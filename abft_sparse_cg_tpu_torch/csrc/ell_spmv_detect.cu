// Kernel C: ell_spmv_detect — one banded-ELL SpMV with the live ABFT
// signals.
//
// Replaces the TPU kernel abft_sparse_cg_tpu/ops/spmv_pallas.py::
// _make_ellb_fast (kernel body :625, pallas_call at :846), variant
// detect=True without halo/base: w[r] = sum over k < ell_len[r] of
// vals[k, r] * x[g(k, r)], the fused pw = x . w, and the mode's trigger
// (parity and/or 8-row-block checksum of the one streamed word plane:
// the rotated fold in the ECC modes, the col word in constraints mode;
// dia_common.cuh).  With no plane it is the detection-free product of the
// lazy schedule.  g is the col word, ECC byte masked in the ECC modes
// only, or the pre-derived gidx plane under an RCM permutation; out-of-
// range indices follow the jnp gather (ell_gather in dia_common.cuh).
//
// What bounds it on the H100: bytes.  Per slot it reads a value (f32) and
// a gather word (u32) up to the row's length and, in the detecting modes,
// a signal word (u32) over all K slots — 8 or 12 B against 2 flops, far
// below the card's ~20 flop/B balance — plus the gathered x, which a
// narrow band keeps in L1/L2.  At the dense-radius-3d -b 10 shape (K =
// 175, R = 221,184: 38.7M slots, 33.0M of them valid; 421 MB read in
// secded) nothing fits the 50 MB L2, so the floor is those bytes over
// 3.35 TB/s, 0.126 ms.  The first design (one thread per row reading the
// planes itself, at most 8 slots in flight per thread, and a second loop
// over the signal plane) took 0.1825 ms of kernel time per secded call
// on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6): its loads in flight
// were bounded by registers, and a shard's 216-block grid (R_loc
// 55,296) left 13 warps per SM, at 22% of the shard's bound.
//
// What the design does about it:
//   - one pass over the three planes, staged: each block takes a
//     contiguous range of whole warps of rows (block b: warps [b W / G,
//     (b + 1) W / G) of W = R / 32) in tiles of kRows rows, and streams
//     each tile through a ring of kStages slabs of kSlab slots x kRows rows
//     per plane in shared memory with cp.async (16-byte copies, coalesced
//     over rows in the transposed (K, R) layout, cached in L2 only), so
//     slabs of every plane are in flight without holding a register;
//   - each thread then sums its row from shared memory in slot order k =
//     0..ell_len-1 (__fmul_rn / __fadd_rn, so w is bit-identical to
//     ops/spmv.py::ell_product), with the x gathers (the read-only path,
//     __ldg: nothing writes x during the call) one slab ahead of the
//     sums, so a gather's latency hides behind the previous slab's adds;
//     it folds the parity and its XOR from the same slab's staged signal
//     words, and the 8-row checksum is three __shfl_xor_sync steps at the
//     end of the tile; the next tile's row lengths load during this one;
//   - value and gather slabs past the tile's longest row are neither
//     copied nor visited; the signal plane is read over all K slots,
//     padding included, as the checksums require;
//   - the grid is sized by the card, not by R: the resident blocks per
//     SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor (8 on the
//     H100: 24 KB of ring and 128 threads each) times the SMs, at most
//     one block per warp of rows, so a shard of 55,296 rows fills the card
//     as the whole matrix does;
//   - the call is one launch: block 0 waits for the other blocks' pw
//     partials and flags, sums them in a fixed order and writes pw and
//     the trigger (finish_call, dia_common.cuh).
// Measured by scripts/torch_spmv_ab.py against the first design in one
// call, kernel time per call on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
// §6): secded 0.1621 ms (first design 0.1772; `A @ x` 0.1377 of device
// time), 78% of the 0.1259 ms bound; the detection-free product 0.1185
// (0.1220), 67% of 0.0797; the halo form on a shard of 55,296 rows 0.0507
// (0.0672), 62% of 0.0315; band+random-1pct's main part (K 11) 0.0539
// (0.0541).  What is left is the stream itself: the product of every
// slab waits for its copies and for the x gathers of the slab before it,
// at 32 warps per SM.
// The TPU kernel's window shuffle-gather, XCOPIES x blocks and wide-band
// absolute scan exist because a TPU cannot gather from HBM; a GPU can, so
// none of them is ported.  Kernel D keeps its own row loop (ell_row_
// signals in dia_common.cuh).
//
// Constraints mode on COO128 streams two signal planes, the col and the
// row word, each against its own baseline (spmv_pallas.py:459-460): the
// kPlanes = 2 instances stage a fourth slab per ring stage (32 KB of ring
// instead of 24), fold the second plane's XOR beside the first's and
// close its 8-row blocks against its own baseline.  The row word is also
// the gather word there, but it is staged twice (once per use): the
// gather slabs stop at the tile's longest row, the signal slabs do not.
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
// returns the cudaError_t of the launch.  Two launches must not run at
// once (finish_call's counter is this library's).

#include <cstdint>

#include "cp_async.cuh"
#include "dia_common.cuh"

namespace {

constexpr int kRows = 128;    // rows per tile = threads per block
constexpr int kSlab = 4;      // slots per staged slab
constexpr int kStages = 4;    // slabs in the ring
constexpr int kSlabWords = kSlab * kRows;          // one plane of a slab
// values, gather, then the kPlanes signal planes' slabs
template <int kPlanes>
constexpr int kStageWordsOf = (2 + kPlanes) * kSlabWords;
template <int kPlanes>
constexpr int kSmemBytes = kStages * kStageWordsOf<kPlanes> * 4;
static_assert(kRows % 32 == 0 && kStages >= 3, "tile shape");
// The ring fits the default 48 KB of dynamic shared memory: no launch
// needs cudaFuncAttributeMaxDynamicSharedMemorySize.
static_assert(kSmemBytes<2> <= 48 * 1024, "ring size");

__device__ unsigned int g_arrive;   // finish_call's counter

struct EllArgs {
  const float* vals;      // (K, R), 16-byte aligned
  const uint32_t* gsrc;   // (K, R) gather word or gidx, 16-byte aligned
  uint32_t gmask;
  const int* ell_len;     // (R,)
  int K;
  int R;
  const float* x;         // where gathers read (x, or x_ext)
  const float* xc;        // the row-aligned x of pw (x, or x_ext + H)
  float* w;
  DiaSignals sig;         // (K, R) plane, 16-byte aligned; null: none
};

// Issue the copies of slab s (slots [s kSlab, min((s + 1) kSlab, K)) of
// the tile's ``nrows`` rows from r0) into ring stage ``st``: the value
// and gather planes if ``vals``, the signal plane(s) if ``sig``.  One
// 16-byte copy per plane, slot and 4 rows; consecutive threads take
// consecutive rows of a slot.
template <int kPlanes>
__device__ __forceinline__ void issue_slab(uint32_t* st, const EllArgs& a,
                                           int r0, int nrows, int s,
                                           bool vals, bool sig) {
  const int k0 = s * kSlab;
  const int q4 = nrows >> 2;
  const int chunks = min(kSlab, a.K - k0) * q4;
  for (int c = threadIdx.x; c < chunks; c += kRows) {
    const int k = c / q4;
    const int q = (c - k * q4) * 4;
    const size_t src = (size_t)(k0 + k) * a.R + r0 + q;
    const int dst = k * kRows + q;
    if (vals) {
      cp16(st + dst, a.vals + src);
      cp16(st + kSlabWords + dst, a.gsrc + src);
    }
    if (sig) {
      cp16(st + 2 * kSlabWords + dst, a.sig.plane + src);
      if constexpr (kPlanes == 2)
        cp16(st + 3 * kSlabWords + dst, a.sig.plane2 + src);
    }
  }
}

// The x gathers of one staged slab for this thread's row: slots k0 + jj,
// jj < cnt, their gather words at st[kSlabWords + jj kRows + t].
template <class Gather>
__device__ __forceinline__ void gather_slab(float* xv, const uint32_t* st,
                                            const EllArgs& a,
                                            const Gather& gat, int cnt) {
#pragma unroll
  for (int jj = 0; jj < kSlab; ++jj)
    if (jj < cnt)
      xv[jj] = __ldg(a.x + gat(st[kSlabWords + jj * kRows + threadIdx.x],
                               a.gmask));
}

template <class Gather, int kPlanes>
__global__ void __launch_bounds__(kRows)
ell_spmv_detect_kernel(EllArgs a, Gather gat, CallOut out) {
  constexpr int kStageWords = kStageWordsOf<kPlanes>;
  extern __shared__ __align__(16) uint32_t ring[];
  __shared__ float fbuf[33];
  __shared__ int ibuf[33];
  __shared__ int wmax[kRows / 32];
  const int t = threadIdx.x;
  const int nsig = a.sig.plane != nullptr ? (a.K + kSlab - 1) / kSlab : 0;
  const long long W = a.R >> 5;
  const int lo = (int)(W * blockIdx.x / gridDim.x) * 32;
  const int hi = (int)(W * (blockIdx.x + 1) / gridDim.x) * 32;
  float pw = 0.0f;
  int bad = 0;
  // Each tile's row lengths are loaded during the tile before it.
  int len = lo + t < hi ? __ldg(a.ell_len + lo + t) : 0;
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    // The tile's rows [r0, r0 + nrows); nrows is a multiple of 32, so
    // every warp is wholly in or wholly out.
    const int nrows = min(kRows, hi - r0);
    const bool live = t < nrows;
    const int r = r0 + t;
    const int n = live ? max(min(len, a.K), 0) : 0;
    len = r + kRows < hi ? __ldg(a.ell_len + r + kRows) : 0;
    const int m = __reduce_max_sync(ABFT_FULL_MASK, n);
    if ((t & 31) == 0) wmax[t >> 5] = m;
    __syncthreads();
    int top = 0;
    for (int i = 0; i < kRows / 32; ++i) top = max(top, wmax[i]);
    const int nval = (top + kSlab - 1) / kSlab;   // slabs with a valid slot
    const int nsl = max(nval, nsig);
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsl)
        issue_slab<kPlanes>(ring + s * kStageWords, a, r0, nrows, s,
                            s < nval, s < nsig);
      cp_commit();
    }
    float wr = 0.0f;
    uint32_t acc = 0, acc2 = 0;
    int odd = 0;
    float xc[kSlab], xn[kSlab];
    for (int s = 0; s < nsl; ++s) {
      cp_wait<kStages - 3>();   // this thread's copies of slabs s, s + 1
      __syncthreads();          // everyone's; and slab s - 1 is consumed
      const int sn = s + kStages - 1;
      if (sn < nsl)
        issue_slab<kPlanes>(ring + (sn % kStages) * kStageWords, a, r0,
                            nrows, sn, sn < nval, sn < nsig);
      cp_commit();
      if (!live) continue;
      const uint32_t* st = ring + (s % kStages) * kStageWords;
      const int k0 = s * kSlab;
      const int cnt = min(kSlab, n - k0);
      // The x gathers run one slab ahead of the sums: slab s + 1's are
      // in flight while slab s is summed (slab 0's at the tile's start).
      if (s == 0) gather_slab(xc, st, a, gat, cnt);
      if (s + 1 < nval)
        gather_slab(xn, ring + ((s + 1) % kStages) * kStageWords, a, gat,
                    min(kSlab, n - k0 - kSlab));
      if (s < nsig) {
        const int ns = min(kSlab, a.K - k0);
#pragma unroll
        for (int j = 0; j < kSlab; ++j) {
          if (j < ns) {
            const uint32_t u = st[2 * kSlabWords + j * kRows + t];
            uint32_t pu = u;
            if constexpr (kPlanes == 2) {
              const uint32_t v = st[3 * kSlabWords + j * kRows + t];
              acc2 ^= v;
              pu ^= v;
            }
            odd |= __popc(pu) & 1;
            acc ^= u;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSlab; ++j)
        if (j < cnt)
          wr = __fadd_rn(wr, __fmul_rn(__uint_as_float(st[j * kRows + t]),
                                       xc[j]));
#pragma unroll
      for (int j = 0; j < kSlab; ++j) xc[j] = xn[j];
    }
    if (live) {
      a.w[r] = wr;
      pw = __fadd_rn(pw, __fmul_rn(__ldg(a.xc + r), wr));
      if (nsig) {
        if (a.sig.use_parity) bad |= odd;
        if (a.sig.use_cksum) {
          if (block8_differs(acc, a.sig.base, r)) bad = 1;
          if constexpr (kPlanes == 2)
            if (block8_differs(acc2, a.sig.base2, r)) bad = 1;
        }
      }
    }
    __syncthreads();   // the ring and wmax are the next tile's
  }
  finish_call(pw, bad, out, &g_arrive, fbuf, ibuf);
}

template <class Gather>
int launch(const EllArgs& a, Gather gat, float* part, int* flags, float* pw,
           unsigned char* trig, int grid, int device, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.vals) |
                          reinterpret_cast<uintptr_t>(a.gsrc) |
                          reinterpret_cast<uintptr_t>(a.sig.plane) |
                          reinterpret_cast<uintptr_t>(a.sig.plane2);
  if (a.K < 1 || a.K > ABFT_MAX_K || a.R < 32 || a.R % 32 != 0 ||
      grid < 1 || grid > a.R / 32 || (align & 15) != 0 ||
      (a.sig.plane2 != nullptr &&
       (a.sig.plane == nullptr || a.sig.base2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  CallOut out{part, flags, pw, trig};
  if (a.sig.plane2 != nullptr)
    ell_spmv_detect_kernel<Gather, 2>
        <<<grid, kRows, (kSmemBytes<2>), (cudaStream_t)stream>>>(a, gat, out);
  else
    ell_spmv_detect_kernel<Gather, 1>
        <<<grid, kRows, (kSmemBytes<1>), (cudaStream_t)stream>>>(a, gat, out);
  return (int)cudaGetLastError();
}

EllArgs args_of(const float* vals, const uint32_t* gsrc, unsigned gmask,
                const int* ell_len, int K, int R, const float* x,
                const float* xc, float* w, const uint32_t* plane,
                const uint32_t* base, const uint32_t* plane2,
                const uint32_t* base2, int use_parity, int use_cksum) {
  return EllArgs{vals, gsrc, gmask, ell_len, K, R, x, xc, w,
                 DiaSignals{plane, base, use_parity, use_cksum, plane2,
                            base2}};
}

template <class Gather>
cudaError_t occupancy(int* per_sm, int planes) {
  return planes == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           per_sm, ell_spmv_detect_kernel<Gather, 2>, kRows,
                           kSmemBytes<2>)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           per_sm, ell_spmv_detect_kernel<Gather, 1>, kRows,
                           kSmemBytes<1>);
}

}  // namespace

// The schedule's constants (ops/spmv.py ELL_TILE_ROWS, ELL_SLAB,
// ELL_STAGES) and the resident blocks per SM of the whole-matrix (halo 0)
// or the halo form (halo 1) instance streaming ``planes`` signal planes (1
// or 2) on ``device``, with its SM count: the grid is ops/spmv.py::
// ell_grid of them.
extern "C" int abft_ell_spmv_tile(void) { return kRows; }
extern "C" int abft_ell_spmv_slab(void) { return kSlab; }
extern "C" int abft_ell_spmv_stages(void) { return kStages; }

extern "C" int abft_ell_spmv_occupancy(int device, int halo, int planes,
                                       int* per_sm, int* sms) {
  if (planes < 1 || planes > 2) return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)(halo ? occupancy<HaloGather>(per_sm, planes)
                    : occupancy<GlobalGather>(per_sm, planes));
}

// ``part`` and ``flags`` hold ``grid`` entries (scratch), ``pw`` and
// ``trig`` are the 0-d outputs; 1 <= grid <= R / 32; ``plane2`` (the row
// word of constraints mode on COO128) is null but with a first plane.
extern "C" int abft_ell_spmv_detect(const float* vals, const uint32_t* gsrc,
                                    unsigned gmask, const int* ell_len,
                                    int K, int R, const float* x, float* w,
                                    const uint32_t* plane,
                                    const uint32_t* base,
                                    const uint32_t* plane2,
                                    const uint32_t* base2, int use_parity,
                                    int use_cksum, float* part, int* flags,
                                    float* pw, unsigned char* trig, int grid,
                                    int device, void* stream) {
  return launch(args_of(vals, gsrc, gmask, ell_len, K, R, x, x, w, plane,
                        base, plane2, base2, use_parity, use_cksum),
                GlobalGather{R}, part, flags, pw, trig, grid, device,
                stream);
}

// The halo form: R is the shard's row count, ``x_ext`` holds R + 2H rows,
// ``rows`` is the global row count and ``row0`` the shard's first row.
extern "C" int abft_ell_spmv_detect_halo(
    const float* vals, const uint32_t* gsrc, unsigned gmask,
    const int* ell_len, int K, int R, const float* x_ext, int H, int rows,
    int row0, float* w, const uint32_t* plane, const uint32_t* base,
    const uint32_t* plane2, const uint32_t* base2, int use_parity,
    int use_cksum, float* part, int* flags, float* pw, unsigned char* trig,
    int grid, int device, void* stream) {
  if (H < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  return launch(args_of(vals, gsrc, gmask, ell_len, K, R, x_ext, x_ext + H,
                        w, plane, base, plane2, base2, use_parity,
                        use_cksum),
                HaloGather{rows, H - row0, R + 2 * H}, part, flags, pw, trig,
                grid, device, stream);
}
