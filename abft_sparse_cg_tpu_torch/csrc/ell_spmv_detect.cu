// Kernel C: ell_spmv_detect — one banded-ELL SpMV with the live ABFT
// signals.
//
// Replaces the TPU kernel abft_sparse_cg_tpu/ops/spmv_pallas.py::
// _make_ellb_fast (kernel body :625, pallas_call at :846), variant
// detect=True without halo/base: w[r] = sum over k < ell_len[r] of
// vals[k, r] * x[g(k, r)], the fused pw = x . w, and the mode's trigger
// (parity and/or 8-row-block checksum of the one streamed word plane:
// the rotated fold in the ECC modes, the col word in constraints mode;
// dia_common.cuh).  g is the col word, ECC byte masked in the ECC modes
// only, or the pre-derived gidx plane under an RCM permutation; out-of-
// range indices follow the jnp gather (ell_gather in dia_common.cuh).
//
// What bounds it on the H100: bytes.  Per slot it reads a value (f32), a
// gather word (u32) and, in the detecting modes, a signal word (u32) —
// 8 or 12 B against 2 flops, far below the card's ~20 flop/B balance —
// plus the gathered x, which a narrow band keeps in L1/L2.  At the
// dense-radius-3d -b 10 shape (K = 175, R = 219,520: 38.4M slots, 33.0M
// of them valid; 421 MB read in secded) nothing fits the 50 MB L2, so
// the floor is those bytes over 3.35 TB/s, 0.126 ms.  Measured by
// chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W: 0.206 ms per
// secded call, 0.152 ms in mode none (floor 0.080 ms).
//
// What the design does about it: one thread per row, one warp per 32
// consecutive rows, so in the transposed (K, R) layout every slot k is a
// coalesced 128-byte load per plane per warp; each plane is read once;
// x is gathered through the read-only path (__ldg: nothing writes x
// during the call); the signals ride the same pass; the checksum is the
// thread's XOR over its K words, then three __shfl_xor_sync steps per
// 8-row block.  The TPU kernel's window shuffle-gather, XCOPIES x blocks
// and wide-band absolute scan exist because a TPU cannot gather from
// HBM; a GPU can, so none of them is ported.
//
// The halo form (abft_ell_spmv_detect_halo) is one shard of a row-sharded
// solve: it replaces the same TPU kernel's halo=True, with_base=True
// variant (the base subtraction at :693-694, the window clamp at
// :704-707), which parallel/sharded_kernel.py runs per shard.  The shard's
// planes are its own (K, R_loc) rows, as built (global gather indices);
// x is its x_ext of R_loc + 2H rows, the neighbour shards' edge rows on
// each side; a slot reads x_ext[g - base + H], g by the global rule, where
// ``base`` is the shard's first global row (HaloGather, dia_common.cuh).
// For every index inside the window (every valid one) a shard's w equals
// the single-device kernel's w on those rows bit for bit.
//
// Interface: plain C, called through ctypes (abft_sparse_cg_tpu_torch/
// _build.py).  Launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch.

#include "dia_common.cuh"

namespace {

constexpr int kBlock = 256;

// ``x`` is where gathers read (x, or x_ext), ``xc`` the row-aligned x
// of the fused pw (x, or x_ext + H).
template <class Gather>
__global__ void __launch_bounds__(kBlock)
ell_spmv_detect_kernel(const float* __restrict__ vals,
                       const uint32_t* __restrict__ gsrc, uint32_t gmask,
                       const int* __restrict__ ell_len, int K, int R,
                       const float* __restrict__ x,
                       const float* __restrict__ xc, Gather gat,
                       float* __restrict__ w, float* __restrict__ pw_part,
                       DiaSignals sig, int* __restrict__ trig) {
  __shared__ float fbuf[33];
  __shared__ int ibuf[1];
  float pw = 0.0f;
  int bad = 0;
  const int stride = gridDim.x * blockDim.x;
  // R % 32 == 0 and stride % 32 == 0: whole warps take the same trips,
  // as dia_row_signals' shuffles require (the last block may be ragged,
  // a whole warp at a time).
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += stride) {
    const float wr =
        ell_row<false>(vals, gsrc, gmask, ell_len, K, R, x, r, gat);
    w[r] = wr;
    pw = __fadd_rn(pw, __fmul_rn(__ldg(xc + r), wr));
    if (sig.plane != nullptr) bad |= dia_row_signals(sig, K, R, r);
  }
  const float total = block_sum(pw, fbuf);
  if (threadIdx.x == 0) pw_part[blockIdx.x] = total;
  if (block_any(bad, ibuf) && threadIdx.x == 0) atomicOr(trig, 1);
}

template <class Gather>
int launch(const float* vals, const uint32_t* gsrc, unsigned gmask,
           const int* ell_len, int K, int R, const float* x, const float* xc,
           Gather gat, float* w, float* pw_part, int grid,
           const uint32_t* plane, const uint32_t* base, int use_parity,
           int use_cksum, int* trig, int device, void* stream) {
  if (K < 1 || K > ABFT_MAX_K || R % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DiaSignals sig{plane, base, use_parity, use_cksum};
  ell_spmv_detect_kernel<Gather><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      vals, gsrc, gmask, ell_len, K, R, x, xc, gat, w, pw_part, sig, trig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int abft_ell_spmv_detect(const float* vals, const uint32_t* gsrc,
                                    unsigned gmask, const int* ell_len,
                                    int K, int R, const float* x, float* w,
                                    float* pw_part, int grid,
                                    const uint32_t* plane,
                                    const uint32_t* base, int use_parity,
                                    int use_cksum, int* trig, int device,
                                    void* stream) {
  return launch(vals, gsrc, gmask, ell_len, K, R, x, x, GlobalGather{R}, w,
                pw_part, grid, plane, base, use_parity, use_cksum, trig,
                device, stream);
}

// The halo form: R is the shard's row count, ``x_ext`` holds R + 2H rows,
// ``rows`` is the global row count and ``row0`` the shard's first row.
extern "C" int abft_ell_spmv_detect_halo(
    const float* vals, const uint32_t* gsrc, unsigned gmask,
    const int* ell_len, int K, int R, const float* x_ext, int H, int rows,
    int row0, float* w, float* pw_part, int grid, const uint32_t* plane,
    const uint32_t* base, int use_parity, int use_cksum, int* trig,
    int device, void* stream) {
  if (H < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  return launch(vals, gsrc, gmask, ell_len, K, R, x_ext, x_ext + H,
                HaloGather{rows, H - row0, R + 2 * H}, w, pw_part, grid,
                plane, base, use_parity, use_cksum, trig, device, stream);
}

extern "C" int abft_ell_spmv_block(void) { return kBlock; }
