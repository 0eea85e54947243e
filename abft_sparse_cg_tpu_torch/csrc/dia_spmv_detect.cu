// Kernel A: dia_spmv_detect — one DIA SpMV with the live ABFT signals.
//
// Replaces the TPU kernel abft_sparse_cg_tpu/ops/spmv_pallas.py::
// _make_dia_fast (pallas_call at :519): w[r] = sum_d vals[d, r] *
// x[r + off_d] (zero outside [0, R)), the fused pw = x . w, and the
// mode's trigger signals (parity and/or 8-row-block checksum of the
// streamed word plane; dia_common.cuh).  With no plane it is the
// detection-free product of the lazy schedule.  Constraints mode on
// COO128 streams two planes, the col and the row word, each against its
// own baseline (the kPlanes = 2 instances; spmv_pallas.py:459-460).
//
// What bounds it on the H100: bytes.  Per row it reads D values (f32),
// D signal words (u32, ECC and constraints modes), ~1 x element (the
// neighbours' reads hit L1/L2) and writes one w — about 25 B/row for the
// tridiagonal secded case against ~2*D + 1 flops, far below the card's
// ~20 flop/B balance point, so the kernel can at best run at memory
// speed (3.35 TB/s HBM; the -b 10 working set of ~33 MB sits in the
// 50 MB L2).  At -b 10 a call moves ~26 MB: ~8 us at the HBM rate, less
// than the fixed cost of a launch and its host call.
//
// What the design does about it: each thread takes 4 consecutive rows,
// so every diagonal's values and signal words arrive in one 16-byte load
// (R % 32 == 0 and plane row d starts at d * R: aligned), x[r + off_d]
// stays a scalar read-only load, and the grid is sized to the rows (one
// wave of R / 1024 blocks, not a grid-stride loop over a capped grid).
// Each row still adds its D products in diagonal order with explicitly
// rounded multiplies and adds, so w is bit-identical to ops/spmv.py::
// dia_product.  An exact 8-row checksum block is two adjacent threads:
// one shuffle closes it.  The call is one launch: block 0 waits for the
// other blocks' pw partials and flags, sums them in a fixed order and
// writes pw and the trigger (finish_call, dia_common.cuh), where the
// caller used to fill the trigger and reduce the partials in two more
// device operations.
//
// The halo form (abft_dia_spmv_detect_halo) is one shard of a row-sharded
// solve: it replaces the same TPU kernel's halo=H variant (_make_dia_fast
// :331, halo branch :475-479), which parallel/sharded_kernel.py runs per
// shard.  x is the shard's x_ext of R + 2H rows, the neighbour shards'
// edge rows on each side (zero at the global ends), and row r reads
// x_ext[H + r + off_d] where the single-device form reads x[r + off_d]
// with zero outside [0, R).  Everything else is the same code, so a
// shard's w equals the single-device kernel's w on those rows bit for bit.
//
// Interface: plain C, called through ctypes (abft_sparse_cg_tpu_torch/
// _build.py).  Launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch.

#include "dia_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kRows = 4;   // rows per thread

__device__ unsigned int g_arrive;   // finish_call's counter

// x[c] of row c's neighbour: zero outside [0, R), or, in the halo form
// (x pointing at x_ext + H), the exchanged neighbour row.
template <bool kHalo>
__device__ __forceinline__ float x_at(const float* __restrict__ x, int c,
                                      int R) {
  if (kHalo) return __ldg(x + c);
  return (c >= 0 && c < R) ? __ldg(x + c) : 0.0f;
}

template <bool kHalo, int kPlanes>
__global__ void __launch_bounds__(kBlock)
dia_spmv_detect_kernel(const float* __restrict__ vals, DiaOffsets offs,
                       int R, const float* __restrict__ x,
                       float* __restrict__ w, DiaSignals sig, CallOut out) {
  __shared__ float fbuf[33];
  __shared__ int ibuf[33];
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const int r = kRows * t;
  float pw = 0.0f;
  int bad = 0;
  if (r < R) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int d = 0; d < offs.n; ++d) {
      const float4 v = __ldg(
          reinterpret_cast<const float4*>(vals + (size_t)d * R + r));
      const int c = r + offs.off[d];
      a0 = __fadd_rn(a0, __fmul_rn(v.x, x_at<kHalo>(x, c, R)));
      a1 = __fadd_rn(a1, __fmul_rn(v.y, x_at<kHalo>(x, c + 1, R)));
      a2 = __fadd_rn(a2, __fmul_rn(v.z, x_at<kHalo>(x, c + 2, R)));
      a3 = __fadd_rn(a3, __fmul_rn(v.w, x_at<kHalo>(x, c + 3, R)));
    }
    *reinterpret_cast<float4*>(w + r) = make_float4(a0, a1, a2, a3);
    pw = __fadd_rn(pw, __fmul_rn(__ldg(x + r), a0));
    pw = __fadd_rn(pw, __fmul_rn(__ldg(x + r + 1), a1));
    pw = __fadd_rn(pw, __fmul_rn(__ldg(x + r + 2), a2));
    pw = __fadd_rn(pw, __fmul_rn(__ldg(x + r + 3), a3));
  }
  if (sig.plane != nullptr) {
    // R / 4 is a multiple of 8: both threads of an 8-row block are in
    // range or both are not, and every lane takes the shuffle.
    uint32_t acc = 0, acc2 = 0;
    if (r < R) {
      for (int d = 0; d < offs.n; ++d) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            sig.plane + (size_t)d * R + r));
        uint4 pu = u;
        if constexpr (kPlanes == 2) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              sig.plane2 + (size_t)d * R + r));
          acc2 ^= v.x ^ v.y ^ v.z ^ v.w;
          pu = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
        }
        if (sig.use_parity)
          bad |= (__popc(pu.x) | __popc(pu.y) | __popc(pu.z) | __popc(pu.w)) &
                 1;
        acc ^= u.x ^ u.y ^ u.z ^ u.w;
      }
    }
    if (sig.use_cksum) {
      acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
      if (r < R && (t & 1) == 0 && acc != __ldg(sig.base + (r >> 3)))
        bad = 1;
      if constexpr (kPlanes == 2) {
        acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 1);
        if (r < R && (t & 1) == 0 && acc2 != __ldg(sig.base2 + (r >> 3)))
          bad = 1;
      }
    }
  }
  finish_call(pw, bad, out, &g_arrive, fbuf, ibuf);
}

int grid_of(int R) { return (R + kRows * kBlock - 1) / (kRows * kBlock); }

template <bool kHalo>
int launch(const float* vals, const int* offsets, int D, int R,
           const float* x, float* w, const uint32_t* plane,
           const uint32_t* base, const uint32_t* plane2,
           const uint32_t* base2, int use_parity, int use_cksum, float* part,
           int* flags, float* pw, unsigned char* trig, int device,
           void* stream) {
  if (plane2 != nullptr && (plane == nullptr || base2 == nullptr ||
                            ((uintptr_t)plane2 & 15u) != 0))
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  DiaOffsets offs;
  offs.n = D;
  for (int d = 0; d < D; ++d) offs.off[d] = offsets[d];
  DiaSignals sig{plane, base, use_parity, use_cksum, plane2, base2};
  CallOut out{part, flags, pw, trig};
  if (plane2 != nullptr)
    dia_spmv_detect_kernel<kHalo, 2>
        <<<grid_of(R), kBlock, 0, (cudaStream_t)stream>>>(vals, offs, R, x,
                                                          w, sig, out);
  else
    dia_spmv_detect_kernel<kHalo, 1>
        <<<grid_of(R), kBlock, 0, (cudaStream_t)stream>>>(vals, offs, R, x,
                                                          w, sig, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int abft_dia_spmv_grid(int R) { return grid_of(R); }

// ``part`` and ``flags`` hold abft_dia_spmv_grid(R) entries; ``vals``,
// ``plane`` and ``plane2`` are 16-byte aligned; ``plane2`` (constraints
// mode on COO128: the row word) is null but with a first plane.
extern "C" int abft_dia_spmv_detect(const float* vals, const int* offsets,
                                    int D, int R, const float* x, float* w,
                                    const uint32_t* plane,
                                    const uint32_t* base,
                                    const uint32_t* plane2,
                                    const uint32_t* base2, int use_parity,
                                    int use_cksum, float* part, int* flags,
                                    float* pw, unsigned char* trig,
                                    int device, void* stream) {
  if (D < 1 || D > ABFT_MAX_D || R < 32 || R % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<false>(vals, offsets, D, R, x, w, plane, base, plane2, base2,
                       use_parity, use_cksum, part, flags, pw, trig, device,
                       stream);
}

// The halo form: ``x_ext`` holds R + 2H rows and H >= max |offset|.
extern "C" int abft_dia_spmv_detect_halo(const float* vals,
                                         const int* offsets, int D, int R,
                                         const float* x_ext, int H, float* w,
                                         const uint32_t* plane,
                                         const uint32_t* base,
                                         const uint32_t* plane2,
                                         const uint32_t* base2,
                                         int use_parity, int use_cksum,
                                         float* part, int* flags, float* pw,
                                         unsigned char* trig, int device,
                                         void* stream) {
  if (D < 1 || D > ABFT_MAX_D || R < 32 || R % 32 != 0 || H < 0)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < D; ++d)
    if (offsets[d] < -H || offsets[d] > H) return (int)cudaErrorInvalidValue;
  return launch<true>(vals, offsets, D, R, x_ext + H, w, plane, base, plane2,
                      base2, use_parity, use_cksum, part, flags, pw, trig,
                      device, stream);
}
