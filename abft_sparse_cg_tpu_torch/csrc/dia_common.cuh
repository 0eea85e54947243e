// Shared device code of the five kernels (dia_spmv_detect.cu,
// fused_cg_dia.cu, ell_spmv_detect.cu, fused_cg_ell.cu,
// flat_spmv_detect.cu): the DIA stencil and banded-ELL row products (and
// the banded-ELL gather rule of one shard of a row-sharded solve), the
// live ABFT signals, fixed-order block and grid reductions, the one-launch
// epilogue of kernels A, C and E, the split tail of the fused kernels,
// and the grid barrier that reduces (grid_reduce) of kernels B and D's
// tail-free instances, with their 16-byte row helpers.
//
// Arithmetic order.  The row products sum the diagonals (d = 0..D-1) or
// the slots (k = 0..ell_len[r]-1) in order with explicitly rounded
// multiplies and adds (__fmul_rn / __fadd_rn), so nvcc cannot contract
// them into FMAs: w is bit-identical to the plain PyTorch versions
// (ops/spmv.py::dia_product, ::ell_product) on the same inputs.
// Reductions use fixed-order per-block partials (no float atomics), so
// two runs of one solve give identical results.
//
// Signals (ops/spmv_cuda.py::_mode_signals), over a (D, R) or (K, R)
// plane, padding slots included (they hold zero codewords):
//   parity  OR over elements of popcount(plane[d, r]) & 1 — the streamed
//           plane is the rotated fold, whose columns all have odd weight,
//           so this is each element's overall parity;
//   cksum   XOR of the D x 8 (K x 8) words of every exact 8-row block
//           compared with that block's encode-time checksum (ell_cksum /
//           fold_ck).  This is the jnp path's granularity (ops/spmv.py:
//           425-438), strictly finer than the TPU kernels' chunk-
//           congruence classes, so the trigger fires wherever theirs
//           does.
// Constraints mode on COO128 streams two planes, the col and the row
// word (spmv_pallas.py:283-298, the per-word loop at :459-460): each
// plane's block XORs against its own baseline, ORed, and parity over
// the XOR of an element's two words.  The plane count is a template
// parameter (kPlanes, 1 or 2) of every signal helper and kernel instance,
// so the one-plane instances compile to what they did before the second
// plane existed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ABFT_MAX_D 128
#define ABFT_MAX_K 512
#define ABFT_FULL_MASK 0xffffffffu
#define ABFT_ECC_COL_MASK 0x00ffffffu
#define ABFT_ERR_BREAKDOWN 7  // ops/spmv.py ERR_BREAKDOWN

// The card of one C entry point's call, the caller's current device
// restored when it returns (on every path): a launch on card 1 must not
// leave a later stream query of the process on card 1.
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int cur = -1;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev)
      cudaSetDevice(prev);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
};

// Diagonal offsets, passed by value (kernel parameter space): uniform
// across the grid and read with no memory traffic.
struct DiaOffsets {
  int n;
  int off[ABFT_MAX_D];
};

struct DiaSignals {
  const uint32_t* plane;   // (D, R) fold or col word; null: no signals
  const uint32_t* base;    // (R / 8) encode-time block checksums
  int use_parity;
  int use_cksum;
  const uint32_t* plane2;  // (D, R) the row word of constraints mode on
  const uint32_t* base2;   // COO128, and its baseline; else null
};

// The 8-row block XOR of one plane at row r (a multiple of 8 in lane
// order: the shuffles close aligned groups of 8 lanes) against its
// baseline; nonzero on a mismatch.  Every lane must call it.
__device__ __forceinline__ int block8_differs(uint32_t acc,
                                              const uint32_t* base, int r) {
  acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
  acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 2);
  acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 4);
  return (r & 7) == 0 && acc != __ldg(base + (r >> 3));
}

// Loads of data that other blocks of the same kernel write (the fused
// kernel's p and partials) bypass L1, which is not coherent across SMs.
template <bool kCoherent>
__device__ __forceinline__ float load_f(const float* p) {
  if (kCoherent) return __ldcg(p);
  return __ldg(p);
}

// w[r] = sum_d vals[d, r] * x[r + off_d], zero outside [0, R).
template <bool kCoherent>
__device__ __forceinline__ float dia_row(const float* __restrict__ vals,
                                         const DiaOffsets& offs, int R,
                                         const float* x, int r) {
  float w = 0.0f;
  for (int d = 0; d < offs.n; ++d) {
    const int c = r + offs.off[d];
    const float xv = (c >= 0 && c < R) ? load_f<kCoherent>(x + c) : 0.0f;
    w = __fadd_rn(w, __fmul_rn(__ldg(vals + (size_t)d * R + r), xv));
  }
  return w;
}

// Banded-ELL gather index of one slot: the stored word masked with
// ``gmask`` (the ECC byte off in the ECC modes; all ones for the raw col
// word or the permuted gidx plane), read as int32, then the jnp gather's
// out-of-range rule (ops/spmv.py::take_clamped): below zero wraps once
// by R, then clamp into [0, R).  A flipped index bit therefore reads a
// wrong x entry but never leaves the vector.
__device__ __forceinline__ int ell_gather(uint32_t word, uint32_t gmask,
                                          int R) {
  int g = (int)(word & gmask);
  if (g < 0) g += R;
  return min(max(g, 0), R - 1);
}

// The rule as ell_row takes it: one device's whole x.
struct GlobalGather {
  int R;
  __device__ __forceinline__ int operator()(uint32_t word,
                                            uint32_t gmask) const {
    return ell_gather(word, gmask, R);
  }
};

// The halo form of the rule, for one shard of a row-sharded solve
// (kernel C's halo entry): x is the shard's x_ext of n = R_loc + 2H rows
// (the neighbour shards' edge rows on each side), the global index g comes
// from the rule above with the global row count R, and the read is
// x_ext[g - base + H] (shift = H - base).  A valid index lands inside the
// window (H is the band rounded up to 128); a corrupted one may not, and
// its position is clamped into [0, n), as the TPU kernel clamps it into
// its window (spmv_pallas.py:704-707).  There the read differs from the
// single-device kernel's x[g]: a decided divergence (ROADMAP.md queue 3).
struct HaloGather {
  int R;
  int shift;
  int n;
  __device__ __forceinline__ int operator()(uint32_t word,
                                            uint32_t gmask) const {
    return min(max(ell_gather(word, gmask, R) + shift, 0), n - 1);
  }
};

// w[r] = sum over k < ell_len[r] of vals[k, r] * x[g(k, r)]; slot k of
// row r lives at k * R + r (transposed ELL), so the 32 rows of a warp
// read each slot as one coalesced 128-byte line.  Offsets are 64-bit:
// K * R reaches 38M slots on the dense-radius-3d -b 10 matrix.
//
// The slots go ABFT_ELL_BATCH at a time: every value, gather-word and x
// load of a batch is issued before the batch is summed (still in slot
// order, so w does not change).  Written as one plain loop, ptxas
// scheduled each slot's loads after the previous slot's x gather had
// returned (one slot in flight per thread, at the 32 registers that
// full occupancy allows), and kernel D's mode-none solve was markedly
// slower (PERF.md §6).
//
// ``gat`` maps a slot's gather word to its position in x (GlobalGather, or
// HaloGather for a shard); ell_row(..., R, x, r) is the single-device form.
#define ABFT_ELL_BATCH 8
template <bool kCoherent, class Gather>
__device__ __forceinline__ float ell_row(const float* __restrict__ vals,
                                         const uint32_t* __restrict__ gsrc,
                                         uint32_t gmask,
                                         const int* __restrict__ ell_len,
                                         int K, int R, const float* x,
                                         int r, const Gather& gat) {
  const int n = min(__ldg(ell_len + r), K);
  float w = 0.0f;
  int k = 0;
  for (; k + ABFT_ELL_BATCH <= n; k += ABFT_ELL_BATCH) {
    float v[ABFT_ELL_BATCH], xv[ABFT_ELL_BATCH];
#pragma unroll
    for (int j = 0; j < ABFT_ELL_BATCH; ++j) {
      const size_t o = (size_t)(k + j) * R + r;
      v[j] = __ldg(vals + o);
      xv[j] = load_f<kCoherent>(x + gat(__ldg(gsrc + o), gmask));
    }
#pragma unroll
    for (int j = 0; j < ABFT_ELL_BATCH; ++j)
      w = __fadd_rn(w, __fmul_rn(v[j], xv[j]));
  }
  for (; k < n; ++k) {
    const size_t o = (size_t)k * R + r;
    const int g = gat(__ldg(gsrc + o), gmask);
    w = __fadd_rn(w, __fmul_rn(__ldg(vals + o), load_f<kCoherent>(x + g)));
  }
  return w;
}

template <bool kCoherent>
__device__ __forceinline__ float ell_row(const float* __restrict__ vals,
                                         const uint32_t* __restrict__ gsrc,
                                         uint32_t gmask,
                                         const int* __restrict__ ell_len,
                                         int K, int R, const float* x,
                                         int r) {
  return ell_row<kCoherent>(vals, gsrc, gmask, ell_len, K, R, x, r,
                            GlobalGather{R});
}

// Signals of row r; nonzero if they fired.  Must be called by all 32
// lanes of a warp on 32 consecutive rows starting at a multiple of 32
// (the 8-row XOR uses warp shuffles within aligned groups of 8 lanes).
template <int kPlanes = 1>
__device__ __forceinline__ int dia_row_signals(const DiaSignals& s, int D,
                                               int R, int r) {
  uint32_t acc = 0, acc2 = 0;
  int bad = 0;
  for (int d = 0; d < D; ++d) {
    const uint32_t v = __ldg(s.plane + (size_t)d * R + r);
    uint32_t pv = v;
    if constexpr (kPlanes == 2) {
      const uint32_t v2 = __ldg(s.plane2 + (size_t)d * R + r);
      acc2 ^= v2;
      pv ^= v2;
    }
    if (s.use_parity) bad |= __popc(pv) & 1;
    acc ^= v;
  }
  if (s.use_cksum) {
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 2);
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 4);
    if ((r & 7) == 0 && acc != __ldg(s.base + (r >> 3))) bad = 1;
    if constexpr (kPlanes == 2) bad |= block8_differs(acc2, s.base2, r);
  }
  return bad;
}

// ell_row and dia_row_signals in ONE pass over the K slots of row r:
// each slot's signal word is loaded beside its value and gather word
// (the product still stops at ell_len[r]), so the three plane streams
// are in flight together.  Same results as the two calls; kernel D's
// split-tail instances use it (a separate signal pass made the first
// design's secded solve much slower, PERF.md §6).  Nonzero ``*bad`` if the signals fired;
// the warp-shuffle rule of dia_row_signals applies.
template <bool kCoherent, int kPlanes = 1>
__device__ __forceinline__ float ell_row_signals(
    const float* __restrict__ vals, const uint32_t* __restrict__ gsrc,
    uint32_t gmask, const int* __restrict__ ell_len, int K, int R,
    const float* x, int r, const DiaSignals& s, int* bad) {
  const int n = min(__ldg(ell_len + r), K);
  float w = 0.0f;
  uint32_t acc = 0, acc2 = 0;
  int odd = 0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const size_t o = (size_t)k * R + r;
    const uint32_t v = __ldg(s.plane + o);
    uint32_t pv = v;
    if constexpr (kPlanes == 2) {
      const uint32_t v2 = __ldg(s.plane2 + o);
      acc2 ^= v2;
      pv ^= v2;
    }
    if (s.use_parity) odd |= __popc(pv) & 1;
    acc ^= v;
    if (k < n) {
      const int g = ell_gather(__ldg(gsrc + o), gmask, R);
      w = __fadd_rn(w, __fmul_rn(__ldg(vals + o), load_f<kCoherent>(x + g)));
    }
  }
  if (s.use_cksum) {
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 2);
    acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 4);
    if ((r & 7) == 0 && acc != __ldg(s.base + (r >> 3))) odd = 1;
    if constexpr (kPlanes == 2) odd |= block8_differs(acc2, s.base2, r);
  }
  *bad |= odd;
  return w;
}

// Sum of a warp's 32 lane values in a fixed XOR butterfly (offsets 16,
// 8, 4, 2, 1); every lane gets the total.  ops.spmv.flat_product repeats
// this order.
__device__ __forceinline__ float warp_butterfly(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(ABFT_FULL_MASK, v, o));
  return v;
}

// Block-wide sum in a fixed order; every thread gets the total.  ``buf``
// holds at least 33 floats of shared memory; blockDim.x % 32 == 0.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(ABFT_FULL_MASK, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += buf[i];
    buf[32] = t;
  }
  __syncthreads();
  const float total = buf[32];
  __syncthreads();  // buf may be reused right after
  return total;
}

// Block-wide OR of nonzero flags; every thread gets the result.
__device__ __forceinline__ int block_any(int v, int* buf) {
  if (threadIdx.x == 0) buf[0] = 0;
  __syncthreads();
  if (__any_sync(ABFT_FULL_MASK, v) && (threadIdx.x & 31) == 0) buf[0] = 1;
  __syncthreads();
  const int any = buf[0];
  __syncthreads();
  return any;
}

// ---- One launch per SpMV call (kernels A, C and E) ------------------------
//
// Every block but block 0 writes its pw partial and its signal flag and
// counts itself in with a release add, and is done.  Block 0, after its
// own work, waits for the count (the other blocks wait on nothing, so
// they all finish), sums the partials in a fixed order, writes pw and
// the 0-d bool trigger, and resets the counter for the next call.  So a
// call is one launch, with no fill of the trigger and no reduction
// kernel after it, and pw is deterministic for a given grid.  The counter
// is a __device__ variable of the kernel's library, zero when it loads:
// two launches of one kernel must not run at once (the port issues them
// all on one stream).
struct CallOut {
  float* part;            // (grid) pw partials; scratch
  int* flags;             // (grid) signal flags; scratch
  float* pw;              // 0-d: x . w
  unsigned char* trig;    // 0-d bool: the signals fired
};

__device__ __forceinline__ void red_add_release(unsigned int* p,
                                                unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ``buf`` holds at least 33 floats and ``ibuf`` 33 ints of shared memory.
__device__ __forceinline__ void finish_call(float pw, int bad,
                                            const CallOut& o,
                                            unsigned int* arrive, float* buf,
                                            int* ibuf) {
  // The block's sum (warp butterflies, then the warps in order) and OR,
  // in thread 0.
  for (int off = 16; off > 0; off >>= 1)
    pw += __shfl_xor_sync(ABFT_FULL_MASK, pw, off);
  bad = __any_sync(ABFT_FULL_MASK, bad);
  if ((threadIdx.x & 31) == 0) {
    buf[threadIdx.x >> 5] = pw;
    ibuf[threadIdx.x >> 5] = bad;
  }
  __syncthreads();
  float total = 0.0f;
  int any = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      total += buf[i];
      any |= ibuf[i];
    }
    if (blockIdx.x != 0) {
      o.part[blockIdx.x] = total;
      o.flags[blockIdx.x] = any;
      red_add_release(arrive, 1u);
    } else {
      while (load_acquire(arrive) != gridDim.x - 1) __nanosleep(64);
    }
  }
  if (blockIdx.x != 0) return;
  __syncthreads();
  float v = 0.0f;
  int f = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    v += i ? __ldcg(o.part + i) : total;
    f |= i ? __ldcg(o.flags + i) : any;
  }
  v = block_sum(v, buf);
  f = block_any(f, ibuf);
  if (threadIdx.x == 0) {
    *o.pw = v;
    *o.trig = f ? 1 : 0;
    *arrive = 0;
  }
}

// ---- The split tail of the fused kernels B and D --------------------------
//
// A bordered split (formats/split.py::try_split) with a dense plan
// (ops/spmv.py::dense_tail_plan): T <= 64 outlier rows o_t, each with a
// span window [start_t, start_t + S); S and every start are multiples of
// 128.  td[t] holds the dense row o_t over its window, tb[t] the
// transpose images (entries whose gather source is o_t, by output row).
// Per iteration the tail adds to the main product w
//   dense rows        w[o_t]                  += td[t] . p[start_t + 0..S)
//   mirrored AXPYs    w[start_t + j]          += p[o_t] * tb[t][j]
// and streams its (E,) signal plane for live detection — the counterpart
// of the TPU kernel's tail (solver/fused.py:977-1014, tail_trigger
// :737-763).  Order: every element w[i] adds, for t = 0..T-1 in turn, the
// dense row's sum (i == o_t) and then the AXPY term (i in window t), as
// the TPU kernel's loop over t does.
//
// Schedule (one pass and one grid sync, as the tail-free loop):
//   phase 1, beside the main rows — p[o_t] is fixed for the iteration
//     (TailShared::po), so each non-outlier row adds its AXPY terms in t
//     order right after its main product (tail_axpy; the windows of its
//     128-row tile come from a host-static bit mask, tiles[i / 128]) and
//     is final: its w and pw term are written then.  An outlier row's main
//     product goes to tmain[t].  Block c < T * nch sums chunk c of the
//     dense rows (tail_dense_chunk, 16-byte loads), and every thread folds
//     whole 8-slot blocks of the tail's signal plane (tail_signals);
//   after the grid sync and the trigger test, every block reduces the
//     chunk partials and finishes the T outlier rows in the element order
//     above (tail_finish); pw = the grid's phase-1 partials + the outlier
//     rows' p . w in t order, the same in every block; the thread that
//     owns row o_t in the grid-strided partition writes w[o_t].
// So w is deterministic for a given grid, every non-outlier element is
// bit-identical to the plain version's, and only pw's summation order
// differs from it.  The tail checksum compares exact 8-slot blocks,
// finer than the TPU kernel's whole-plane fold.
#define ABFT_MAX_T 64

struct TailPlan {
  int T;                            // outlier rows; 0: no tail
  int S;                            // span width
  int chunk;                        // dense-row chunk (multiple of 128)
  int nch;                          // chunks per dense row: ceil(S / chunk)
  int E;                            // tail signal-plane slots (E % 8 == 0)
  const int* rows;                  // (T) o_t (exec rows)
  const int* starts;                // (T) start_t
  const unsigned long long* tiles;  // (R / 128) bit t: tile in window t
  const float* td;                  // (T, S)
  const float* tb;                  // (T, S)
  float* part;                      // (T * nch) chunk partials
  float* tmain;                     // (T) main product at o_t
  DiaSignals sig;                   // (E,) tail fold or col word; or null
};

// The plan's per-block copy in shared memory (rows and starts once per
// launch, p[o_t] once per iteration, the dense sums and the finished
// outlier rows after the sync).  An empty struct for the tail-free
// instances.
template <bool kTail>
struct TailShared {
  int rows[ABFT_MAX_T];
  int starts[ABFT_MAX_T];
  float po[ABFT_MAX_T];
  float ds[ABFT_MAX_T];
  float wo[ABFT_MAX_T];
};

template <>
struct TailShared<false> {};

// Once per launch: rows and starts into shared memory; returns the bit
// mask of the outliers whose row this thread owns in the grid-strided
// partition (row i belongs to thread i % stride).
__device__ __forceinline__ unsigned long long tail_stage(
    const TailPlan& tp, TailShared<true>& sh, int tid, int stride) {
  for (int t = threadIdx.x; t < tp.T; t += blockDim.x) {
    sh.rows[t] = __ldg(tp.rows + t);
    sh.starts[t] = __ldg(tp.starts + t);
  }
  __syncthreads();
  unsigned long long own = 0;
  for (int t = 0; t < tp.T; ++t)
    if (sh.rows[t] % stride == tid) own |= 1ull << t;
  return own;
}

// Once per iteration, before phase 1: p[o_t] (other blocks wrote p).
__device__ __forceinline__ void tail_load_po(const TailPlan& tp,
                                             TailShared<true>& sh,
                                             const float* p) {
  for (int t = threadIdx.x; t < tp.T; t += blockDim.x)
    sh.po[t] = __ldcg(p + sh.rows[t]);
  __syncthreads();
}

// Which outlier row i is, if this thread owns one (``own``); -1 if none.
__device__ __forceinline__ int tail_outlier(const TailShared<true>& sh,
                                            unsigned long long own, int i) {
  while (own) {
    const int t = __ffsll((long long)own) - 1;
    own &= own - 1;
    if (sh.rows[t] == i) return t;
  }
  return -1;
}

// Phase 1, a non-outlier row i: its main product ``w`` plus its mirrored
// AXPY terms, in t order.  The tb loads go ABFT_TAIL_BATCH windows at a
// time, all issued before the batch is summed: one window at a time made
// an arrowhead -b 10 iteration 9% slower (PERF.md §6).
#define ABFT_TAIL_BATCH 4
__device__ __forceinline__ float tail_axpy(const TailPlan& tp,
                                           const TailShared<true>& sh,
                                           int i, float w) {
  unsigned long long m = __ldg(tp.tiles + (i >> 7));
  while (m) {
    float v[ABFT_TAIL_BATCH];
    int ts[ABFT_TAIL_BATCH];
#pragma unroll
    for (int j = 0; j < ABFT_TAIL_BATCH; ++j) {
      ts[j] = -1;
      if (m) {
        ts[j] = __ffsll((long long)m) - 1;
        m &= m - 1;
        v[j] = __ldg(tp.tb + (size_t)ts[j] * tp.S + (i - sh.starts[ts[j]]));
      }
    }
#pragma unroll
    for (int j = 0; j < ABFT_TAIL_BATCH; ++j)
      if (ts[j] >= 0) w = __fadd_rn(w, __fmul_rn(sh.po[ts[j]], v[j]));
  }
  return w;
}

// Phase 1, block-uniform: block c < T * nch sums chunk c = t * nch + q of
// the dense rows, slots [q * chunk, min((q + 1) * chunk, S)) of td[t] .
// p[start_t + ...].  Thread k takes the float4 groups k, k + blockDim,
// k + 2 blockDim, ... of the chunk in turn, each in x, y, z, w order, two
// groups' loads in flight; then block_sum.  (Grid-strided over chunks, so
// a grid smaller than T * nch is still covered; the wrapper sizes the
// chunks so that one round does.)
__device__ __forceinline__ void tail_dense_chunk(const TailPlan& tp,
                                                 const TailShared<true>& sh,
                                                 const float* p,
                                                 float* fbuf) {
  const int nparts = tp.T * tp.nch;
  for (int c = blockIdx.x; c < nparts; c += gridDim.x) {
    const int t = c / tp.nch;
    const int k0 = (c - t * tp.nch) * (tp.chunk >> 2);
    const int k1 = min(k0 + (tp.chunk >> 2), tp.S >> 2);
    const float4* td4 =
        reinterpret_cast<const float4*>(tp.td + (size_t)t * tp.S);
    const float4* p4 = reinterpret_cast<const float4*>(p + sh.starts[t]);
    float v = 0.0f;
    for (int k = k0 + (int)threadIdx.x; k < k1; k += 2 * blockDim.x) {
      const int k2 = k + blockDim.x;
      const float4 a = __ldg(td4 + k), b = __ldcg(p4 + k);
      float4 a2 = make_float4(0.f, 0.f, 0.f, 0.f), b2 = a2;
      if (k2 < k1) {
        a2 = __ldg(td4 + k2);
        b2 = __ldcg(p4 + k2);
      }
      v = __fadd_rn(v, __fmul_rn(a.x, b.x));
      v = __fadd_rn(v, __fmul_rn(a.y, b.y));
      v = __fadd_rn(v, __fmul_rn(a.z, b.z));
      v = __fadd_rn(v, __fmul_rn(a.w, b.w));
      if (k2 < k1) {
        v = __fadd_rn(v, __fmul_rn(a2.x, b2.x));
        v = __fadd_rn(v, __fmul_rn(a2.y, b2.y));
        v = __fadd_rn(v, __fmul_rn(a2.z, b2.z));
        v = __fadd_rn(v, __fmul_rn(a2.w, b2.w));
      }
    }
    v = block_sum(v, fbuf);
    if (threadIdx.x == 0) tp.part[c] = v;
  }
}

// After the grid sync (every block, block-uniform): the dense sums (warp
// w reduces rows t = w, w + 8, ...: lane l adds partials q = l, l + 32,
// ... in turn, then warp_butterfly), then thread t finishes outlier row
// o_t from tmain[t] in the element order (for each window t' holding o_t
// or t' == t, in t' order: the dense sum at t' == t, then the AXPY term
// of t'); the owner of o_t writes w[o_t].  Returns the outlier rows' pw
// term, sum over t in order of p[o_t] * w[o_t], in every thread.
__device__ __forceinline__ float tail_finish(const TailPlan& tp,
                                             TailShared<true>& sh, float* w,
                                             unsigned long long own) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < tp.T; t += blockDim.x >> 5) {
    float v = 0.0f;
    for (int q = lane; q < tp.nch; q += 32)
      v = __fadd_rn(v, __ldcg(tp.part + t * tp.nch + q));
    v = warp_butterfly(v);
    if (lane == 0) sh.ds[t] = v;
  }
  __syncthreads();
  for (int t0 = threadIdx.x; t0 < tp.T; t0 += blockDim.x) {
    const int o = sh.rows[t0];
    const unsigned long long win = __ldg(tp.tiles + (o >> 7));
    unsigned long long m = win | (1ull << t0);
    float v = __ldcg(tp.tmain + t0);
    while (m) {
      const int t = __ffsll((long long)m) - 1;
      m &= m - 1;
      if (t == t0) v = __fadd_rn(v, sh.ds[t]);
      if ((win >> t) & 1ull)
        v = __fadd_rn(v, __fmul_rn(sh.po[t], __ldg(tp.tb + (size_t)t * tp.S +
                                                   (o - sh.starts[t]))));
    }
    sh.wo[t0] = v;
  }
  __syncthreads();
  while (own) {
    const int t = __ffsll((long long)own) - 1;
    own &= own - 1;
    w[sh.rows[t]] = sh.wo[t];
  }
  float s = 0.0f;
  for (int t = 0; t < tp.T; ++t)
    s = __fadd_rn(s, __fmul_rn(sh.po[t], sh.wo[t]));
  return s;
}

// The tail's signals over its (E,) plane, by whole 8-slot blocks: thread
// ``tid`` of ``stride`` takes blocks tid, tid + stride, ... (two 16-byte
// loads each), OR of each word's parity, XOR of the 8 words against the
// block's baseline word; nonzero if they fired.  kPlanes 2: the same over
// the second plane against its own baseline, parity over the XOR of the
// two planes.
template <int kPlanes = 1>
__device__ __forceinline__ int tail_signals(const TailPlan& tp, int tid,
                                            int stride) {
  const DiaSignals& s = tp.sig;
  if (s.plane == nullptr) return 0;
  const uint4* pl = reinterpret_cast<const uint4*>(s.plane);
  int bad = 0;
  for (int g = tid; g < (tp.E >> 3); g += stride) {
    uint4 a = __ldg(pl + 2 * g), b = __ldg(pl + 2 * g + 1);
    if constexpr (kPlanes == 2) {
      const uint4* pl2 = reinterpret_cast<const uint4*>(s.plane2);
      const uint4 a2 = __ldg(pl2 + 2 * g), b2 = __ldg(pl2 + 2 * g + 1);
      if (s.use_cksum && (a2.x ^ a2.y ^ a2.z ^ a2.w ^ b2.x ^ b2.y ^ b2.z ^
                          b2.w) != __ldg(s.base2 + g))
        bad = 1;
      if (s.use_parity)
        bad |= (__popc(a.x ^ a2.x) | __popc(a.y ^ a2.y) |
                __popc(a.z ^ a2.z) | __popc(a.w ^ a2.w) |
                __popc(b.x ^ b2.x) | __popc(b.y ^ b2.y) |
                __popc(b.z ^ b2.z) | __popc(b.w ^ b2.w)) & 1;
    } else if (s.use_parity) {
      bad |= (__popc(a.x) | __popc(a.y) | __popc(a.z) | __popc(a.w) |
              __popc(b.x) | __popc(b.y) | __popc(b.z) | __popc(b.w)) & 1;
    }
    if (s.use_cksum &&
        (a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w) != __ldg(s.base + g))
      bad = 1;
  }
  return bad;
}

// Host side: fill a TailPlan from the C interface's arguments; returns
// false on arguments the kernels cannot take (the 16-byte loads need td,
// p and the signal plane 16-byte aligned).
inline bool make_tail_plan(TailPlan* t, const float* td, const float* tb,
                           const int* rows, const int* starts,
                           const unsigned long long* tiles, int T, int S,
                           int chunk, float* part, float* tmain,
                           const uint32_t* plane, const uint32_t* base,
                           const uint32_t* plane2, const uint32_t* base2,
                           int use_parity, int use_cksum, int E,
                           const float* p) {
  t->T = T;
  t->S = S;
  t->E = E;
  t->chunk = chunk;
  t->nch = T && chunk > 0 ? (S + chunk - 1) / chunk : 0;
  t->rows = rows;
  t->starts = starts;
  t->tiles = tiles;
  t->td = td;
  t->tb = tb;
  t->part = part;
  t->tmain = tmain;
  t->sig = DiaSignals{plane, base, use_parity, use_cksum, plane2, base2};
  if (T == 0) return true;
  auto aligned = [](const void* q) { return ((uintptr_t)q & 15u) == 0; };
  return T > 0 && T <= ABFT_MAX_T && S >= 128 && S % 128 == 0 &&
         chunk >= 128 && chunk % 128 == 0 && E >= 8 && E % 8 == 0 &&
         td != nullptr && tb != nullptr && rows != nullptr &&
         starts != nullptr && tiles != nullptr && part != nullptr &&
         tmain != nullptr && aligned(td) && aligned(p) &&
         (plane == nullptr || aligned(plane)) &&
         (plane2 == nullptr || (plane != nullptr && aligned(plane2)));
}

// ---- The Jacobi and lazy instances of the fused kernels B and D ----------
//
// Jacobi (kPrecond, solver/fused.py:1022-1039): z1 = M^-1 r1, rz1 = r1 . z1
// reduced beside rr1 in the same pass (a second partial array, the same
// fixed order, no extra grid sync), beta = rz1 / rz, p = z1 + beta p.
// Lazy (kLazy, fused.py:912-1155): iteration itr streams the signal plane
// only when itr % ci == ci - 1 (keyed on the absolute count, so resumes
// agree); a checked iteration that stands copies x, r, p of its rows to
// the snapshot and records its/rrs/rzs; the entry state seeds it; a clean
// exit with its != itr runs one signals-only pass that closes the
// unverified window.  The instances without them take this struct and
// never read it.
struct CgOpts {
  const float* minv;  // (R) M^-1; kPrecond
  float* part_rz;     // (grid) rz1 partials; kPrecond
  float* xs;          // (R) snapshot of x, r, p; kLazy
  float* rs;
  float* ps;
  int ci;             // check interval > 1; kLazy
  int* snap_iout;     // its
  float* snap_fout;   // rrs, rzs
};

// Fixed-order sum of a whole grid's per-block partials, computed by
// every block after a grid sync (__ldcg: other blocks wrote them): the
// split-tail instances of kernel B and kernel D.  Every block reads all
// the partials, so a grid of G blocks reads G^2 of them per reduction;
// kernels B and D's tail-free instances reduce with grid_reduce below
// instead.
__device__ __forceinline__ float grid_total(const float* part, float* buf) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    v += __ldcg(part + i);
  return block_sum(v, buf);
}

__device__ __forceinline__ int grid_any(const int* part, int* buf) {
  int v = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
    v |= __ldcg(part + i);
  return block_any(v, buf);
}

// ---- Kernels B and D's tail-free instances: the grid barrier that reduces
//
// One barrier and one fixed-order reduction in a single step.  Each block
// sums its threads' values (warp butterflies, then the warps in order,
// as block_sum does) and thread 0 stores the block's partials and counts
// the block in with one acquire-release atomic.  The block that came
// last (the count tells it) resets the count, sums the partials in
// grid_total's order (thread i adds partials i, i + blockDim, ... in
// turn, then the block sum) and publishes the totals with the next
// generation in one 16-byte store, which releases the others: each
// waits for that generation and reads the totals in the same 16-byte
// load.  So a reduction reads each partial once, not once per block, the
// totals do not depend on which block came last, and the critical path
// is the arrival's atomic, one read of the partials and the publication.
// Each block reads the generation once per launch (grid_generation:
// no barrier can complete before every block has started) and counts
// its barriers itself.  The count is back at 0 after every barrier, so
// one GridSync (a __device__ variable of the kernel's library, zero when
// it loads) serves every launch, one at a time: the port issues them all
// on one stream.  The launch is cooperative, so every block is resident
// and the wait cannot deadlock.
struct GridSync {
  unsigned int count;  // blocks arrived at the current barrier
  unsigned int pad[3];
  uint4 pub;           // the last barrier's a, b (float bits), OR, generation
};

struct Sums {
  float a, b;
  int any;
};

__device__ __forceinline__ uint4 load_volatile4(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_volatile4(uint4* p, uint4 v) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ unsigned int atom_add_acq_rel(unsigned int* p,
                                                        unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The generation at launch, for thread 0 of each block to count from.
__device__ __forceinline__ unsigned int grid_generation(const GridSync* g) {
  return threadIdx.x == 0 ? load_volatile4(&g->pub).w : 0u;
}

// kA, kB, kAny: which of (a, b, any) carry data (none: a bare barrier).
// Every thread of every block calls it with its own values and gets the
// grid's totals; ``gen``: thread 0's count of the generation, from
// grid_generation; ``pa``, ``pb``, ``pf`` hold gridDim.x partials;
// ``fbuf`` holds at least 72 floats and ``ibuf`` 44 ints of shared
// memory.
template <bool kA, bool kB, bool kAny>
__device__ __forceinline__ Sums grid_reduce(Sums s, float* pa, float* pb,
                                            int* pf, GridSync* g,
                                            unsigned int& gen, float* fbuf,
                                            int* ibuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
  // the block's values, in thread 0
  auto block = [&](Sums v) {
    for (int o = 16; o > 0; o >>= 1) {
      if (kA) v.a += __shfl_xor_sync(ABFT_FULL_MASK, v.a, o);
      if (kB) v.b += __shfl_xor_sync(ABFT_FULL_MASK, v.b, o);
    }
    if (kAny) v.any = __any_sync(ABFT_FULL_MASK, v.any);
    if (lane == 0) {
      fbuf[warp] = v.a;
      fbuf[33 + warp] = v.b;
      ibuf[4 + warp] = v.any;
    }
    __syncthreads();
    Sums t{0.0f, 0.0f, 0};
    if (threadIdx.x == 0)
      for (int i = 0; i < nw; ++i) {
        t.a += fbuf[i];
        t.b += fbuf[33 + i];
        t.any |= ibuf[4 + i];
      }
    return t;
  };
  const Sums part = block(s);
  if (threadIdx.x == 0) {
    if (kA) pa[blockIdx.x] = part.a;
    if (kB) pb[blockIdx.x] = part.b;
    if (kAny) pf[blockIdx.x] = part.any;
    const bool last = atom_add_acq_rel(&g->count, 1u) == gridDim.x - 1;
    if (last) g->count = 0;  // ordered before the publication below
    ibuf[0] = last;
    gen += 1u;
  }
  __syncthreads();
  if (ibuf[0]) {
    Sums v{0.0f, 0.0f, 0};
    for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
      if (kA) v.a += __ldcg(pa + i);
      if (kB) v.b += __ldcg(pb + i);
      if (kAny) v.any |= __ldcg(pf + i);
    }
    __syncthreads();  // fbuf held the block's own sums
    const Sums t = block(v);
    if (threadIdx.x == 0) {
      __threadfence();
      store_volatile4(&g->pub, make_uint4(__float_as_uint(t.a),
                                          __float_as_uint(t.b),
                                          (unsigned int)t.any, gen));
      fbuf[66] = t.a;
      fbuf[67] = t.b;
      ibuf[2] = t.any;
    }
  } else if (threadIdx.x == 0) {
    uint4 v;
    do {
      v = load_volatile4(&g->pub);
    } while (v.w != gen);
    __threadfence();  // what the other blocks stored before the barrier
    fbuf[66] = __uint_as_float(v.x);
    fbuf[67] = __uint_as_float(v.y);
    ibuf[2] = (int)v.z;
  }
  __syncthreads();
  const Sums t{fbuf[66], fbuf[67], ibuf[2]};
  __syncthreads();  // the buffers may be reused right after
  return t;
}

// s[i .. i + 3] of a 16-byte aligned shared array, for any i >= 0, from
// one or two aligned 16-byte reads: a warp's lanes read i = 4 * lane + c,
// which as four scalar reads would hit each bank four times.  The array
// must hold 4 floats past s[i + 3].
__device__ __forceinline__ float4 tile_window(const float* s, int i) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4 a = s4[i >> 2];
  switch (i & 3) {
    case 0:
      return a;
    case 1: {
      const float4 b = s4[(i >> 2) + 1];
      return make_float4(a.y, a.z, a.w, b.x);
    }
    case 2: {
      const float4 b = s4[(i >> 2) + 1];
      return make_float4(a.z, a.w, b.x, b.y);
    }
    default: {
      const float4 b = s4[(i >> 2) + 1];
      return make_float4(a.w, b.x, b.y, b.z);
    }
  }
}

// 16-byte loads and stores of four consecutive rows (the row is a
// multiple of 4 and the vector 16-byte aligned); ld4cg reads through L2,
// for vectors that other blocks of the launch write.
__device__ __forceinline__ float4 ld4cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
