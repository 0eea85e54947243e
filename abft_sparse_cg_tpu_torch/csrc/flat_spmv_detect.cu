// Kernel E: flat_spmv_detect — one SpMV over the flat (unstructured)
// layout with the live ABFT signals.
//
// Replaces the TPU kernel abft_sparse_cg_tpu/ops/spmv_unstructured.py::
// _make_kernel (kernel body :416, pallas_call at :447, with _benes_body
// :378), variant detect=True: the w of a flat matrix, plus pw = x . w and
// the mode's trigger.  The flat planes hold the entries sorted by output
// row, then gather index (formats/protected.py, exec_kind "flat"), padded
// to E, a multiple of 8, with zero codewords.  w[r] = sum over slots j in
// [row_ptr[r], row_ptr[r+1]) of vals[j] * x[g(j)], g the col word (ECC
// byte masked in the ECC modes) or the RCM gidx plane, clamped by the jnp
// gather's rule (ell_gather in dia_common.cuh).  The signals are those of
// kernels A and C over the one streamed (E,) plane — the rotated fold in
// the ECC modes, the col word in constraints mode: parity of every slot,
// and the XOR of every exact 8-slot block against its encode-time value
// (ops/spmv.py::_fold_blocks on a 1-D plane).
//
// What it is not: the TPU kernel scans x in column order and routes the
// products through two Benes networks because a TPU cannot gather; a GPU
// can, so this is a CSR row gather over the exec-sorted planes, with the
// row pointer derived once at upload from the clean __flat_group__.
//
// What bounds it on the H100: bytes.  Per valid slot a value (f32) and a
// gather word (u32), plus a signal word (u32) over all E slots in the
// detecting modes — 8 or 12 B against 2 flops — plus x, w and the row
// pointer (12 B per row).  At powerlaw-graph -b 10 (R = 655,360, 3.2M
// entries) that is ~47 MB in secded, about the size of the 50 MB L2.
//
// What the design does about it: one warp per row, lanes striding over
// the row's slots (contiguous: coalesced loads), so a hub row of 10,875
// entries takes 340 loads per lane beside rows of 2, instead of one
// thread walking it while its warp waits.  Each lane sums its slots in
// order with explicitly rounded multiplies and adds, the 32 lane sums
// combine in a fixed butterfly (warp_butterfly), and lane 0 adds x[r] w[r]
// to its pw in row order: w and pw are deterministic, and w is bit-
// identical to ops/spmv.py::flat_product.  The signals run slot-parallel
// in the same launch (their 8-slot blocks straddle rows).  x goes through
// the read-only path (__ldg): nothing writes it during the call.
//
// Interface: plain C, called through ctypes (abft_sparse_cg_tpu_torch/
// _build.py).  Launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch.

#include "dia_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
flat_spmv_detect_kernel(const float* __restrict__ vals,
                        const uint32_t* __restrict__ gsrc, uint32_t gmask,
                        const int* __restrict__ row_ptr, int R, int E,
                        const float* __restrict__ x, float* __restrict__ w,
                        float* __restrict__ pw_part, DiaSignals sig,
                        int* __restrict__ trig) {
  __shared__ float fbuf[33];
  __shared__ int ibuf[1];
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nwarps = stride >> 5;
  float pw = 0.0f;
  // Rows: the warp loop is uniform across the warp; lanes diverge only
  // inside the slot loop and meet again at the butterfly.
  for (int r = tid >> 5; r < R; r += nwarps) {
    const int s = __ldg(row_ptr + r), e = __ldg(row_ptr + r + 1);
    float v = 0.0f;
    for (int j = s + lane; j < e; j += 32) {
      const int g = ell_gather(__ldg(gsrc + j), gmask, R);
      v = __fadd_rn(v, __fmul_rn(__ldg(vals + j), __ldg(x + g)));
    }
    v = warp_butterfly(v);
    if (lane == 0) {
      w[r] = v;
      pw = __fadd_rn(pw, __fmul_rn(__ldg(x + r), v));
    }
  }
  // Signals: slot-parallel over E rounded up to whole warps.
  int bad = 0;
  if (sig.plane != nullptr) {
    const int E32 = (E + 31) & ~31;
    for (int j = tid; j < E32; j += stride) bad |= flat_signals(sig, E, j);
  }
  const float total = block_sum(pw, fbuf);
  if (threadIdx.x == 0) pw_part[blockIdx.x] = total;
  if (block_any(bad, ibuf) && threadIdx.x == 0) atomicOr(trig, 1);
}

}  // namespace

extern "C" int abft_flat_spmv_detect(const float* vals, const uint32_t* gsrc,
                                     unsigned gmask, const int* row_ptr,
                                     int R, int E, const float* x, float* w,
                                     float* pw_part, int grid,
                                     const uint32_t* plane,
                                     const uint32_t* base, int use_parity,
                                     int use_cksum, int* trig, int device,
                                     void* stream) {
  if (R < 1 || R % 32 != 0 || E < 8 || E % 8 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DiaSignals sig{plane, base, use_parity, use_cksum};
  flat_spmv_detect_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      vals, gsrc, gmask, row_ptr, R, E, x, w, pw_part, sig, trig);
  return (int)cudaGetLastError();
}

extern "C" int abft_flat_spmv_block(void) { return kBlock; }
