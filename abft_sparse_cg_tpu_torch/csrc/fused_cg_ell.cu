// Kernel D: fused_cg_ell — the whole detect-fast CG loop over a
// banded-ELL matrix in one kernel.
//
// Replaces the ELL branch of the TPU kernel abft_sparse_cg_tpu/solver/
// fused.py::_make_kernel (is_ell at :494, the haloed window of p at :500,
// its gather at :815-860, pallas_call at :1248; the plan at :183-216).  It
// has kernel B's contract (fused_cg_dia.cu): the same exit states
// (convergence, upto, a trigger, a breakdown = ERR_BREAKDOWN), rr trace at
// slots [itr_in, itr_out), in-place update of x, r and p, and the same
// re-execution of a triggered iteration by the caller after a repair
// (solver/fused.py).  One iteration:
//   1. w = A p over the (K, R) planes, pw = p . w, and the signals of the
//      streamed word plane(s) in the same pass;
//   2. pw and the trigger's OR in one grid barrier; a trigger exits
//      before any update;
//   3. alpha = rz / pw, r1 = r - alpha w (in the w buffer), rr1 (and rz1
//      = r1 . M^-1 r1); one barrier; pw <= 0 or a non-finite rr1 exits
//      before any update;
//   4. x += alpha p, r = r1, p = z1 + (rz1 / rz) p, trace[itr] = rr1; one
//      barrier (the next product gathers p at other blocks' rows).
// The Jacobi (kPrecond) and lazy --check-interval (kLazy) instances are
// kernel B's (dia_common.cuh CgOpts).  Constraints mode on COO128 streams
// two signal planes, the col and the row word, each against its own
// baseline (the kPlanes = 2 instances).
//
// What bounds it on the H100: bytes per iteration — the plane streams (the
// values and gather words of the valid slots, and in the detecting modes
// the K signal words of every row, padding included) plus ~8 floats of CG
// vectors per row.  At dense-radius-3d -b 10 (K 175, R 221,184: 33.0M
// valid slots of 38.7M) that is 426 MB per secded iteration (272 MB in
// mode none), far past the 50 MB L2: HBM-bound, 0.1275 ms per secded
// iteration over 3.35 TB/s.
//
// What the design does about it (the tail-free signal instances —
// live, lazy, Jacobi, lazy Jacobi, one or two planes — row_loop):
//   - the product pass is kernel C's staged stream (ell_spmv_detect.cu):
//     block b owns the contiguous warps of rows of ops/spmv.py::
//     ell_block_rows over the grid and takes them in tiles of kRows rows;
//     each tile's value, gather and signal slabs (kSlab slots x kRows
//     rows, a fourth slab per stage with two signal planes) stream
//     through a kStages-deep cp.async ring in shared memory, so the
//     loads in flight hold no registers; value and gather slabs stop at
//     the tile's longest row, signal slabs cover all K slots; each thread
//     sums its row in slot order with __fmul_rn / __fadd_rn (w is
//     bit-identical to ops/spmv.py::ell_product) and closes its parity
//     and 8-row checksums with block8_differs; the lazy instances'
//     unchecked iterations stage no signal slab;
//   - p is gathered from shared memory (the "window" schedule): after the
//     barrier that publishes p, each block stages p over [lo - hb, hi +
//     hb) of its rows [lo, hi), hb = the exec-space band rounded up to 4
//     (formats/protected.py band), with cp.async through L2 (never L1:
//     other blocks wrote p), and every valid gather of its rows lands
//     there; an index outside the window (only a corrupted one can be) is
//     read from p in device memory, so w stays bit-identical whatever the
//     index;
//   - as many blocks per SM as the ring and the window leave room for in
//     the SM's 228 KB, at most kMaxRowBlocksPerSM (5-stage rings, which
//     leave room for 4 blocks instead of 5, were 9% slower: scripts/
//     torch_d_probe.py, PERF.md §6): solver/fused.py::ell_row_plan sizes
//     the window to the matrix (the largest block's rows and 2 hb) and
//     takes the most blocks per SM at which it fits.  Where it fits at
//     fewer than half the l2 schedule's blocks, the "l2" schedule gathers
//     every slot from device memory (__ldcg), as the first design did,
//     with the ring alone in shared memory; the plan is made once per
//     matrix;
//   - three grid barriers per iteration, each one reduction (dia_common.
//     cuh grid_reduce, the library's own GridSync: the last block sums the
//     partials in a fixed order and publishes the totals), in place of
//     grid.sync() and every block re-reading every partial;
//   - one grid and partition for every tail-free instance of a matrix and
//     mode, live or lazy, Jacobi or not (they share a ring and a window:
//     abft_fused_ell_occupancy takes the least of their resident blocks),
//     at most one block per warp of rows, so a clean lazy solve equals the
//     live one bit for bit.
// Measured by scripts/torch_live_ab.py against the first design in one
// call, device time per dense-radius-3d -b 10 solve on NVIDIA H100 80GB
// HBM3, 700.00 W (PERF.md §6): secded 1.6771 ms (first design 2.0555),
// 68% of the 1.1477 ms bound; Jacobi 1.8575 (2.3839); lazy CI 4 1.4335
// (1.4753); lazy Jacobi 1.5815 (1.6372); stencil27-shuffled -b 10 secded,
// l2 schedule, 1.4994 (1.7247).  In mode none the stream took 1.2137 ms
// against the first design's 1.1179 in an earlier call (there the slabs
// carry no signal plane; why the ring loses to the first design's
// register loads there is not probed).
//
// So mode none's tail-free instances, and the instances with kernel B's
// split tail (kTail; dia_common.cuh TailPlan) of a bordered split whose
// main part is banded ELL, keep the first design's loop (cg_loop below;
// the "grid-stride" schedule of mode none): one row per thread,
// grid-strided, each slot's value, gather and signal word loaded through
// registers (ell_row / ell_row_signals), the gathers of p through L2,
// three grid.sync() per iteration, every block re-reading the partials
// (grid_total / grid_any); with a tail, the AXPY terms beside each row's
// product, the outlier rows finished after the first sync.
//
// Interface: plain C through ctypes; launches with
// cudaLaunchCooperativeKernel on the caller's stream, allocates
// nothing, returns the cudaError_t.

#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "dia_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The first design's instances (the split tail's, mode none's): blocks of
// kBlock threads, one row per thread, grid-strided.  The split tail's
// lazy instances are launched with the live
// counterpart's grid, so that every reduction sums in the same order and
// a clean lazy solve equals the live one bit for bit: they must fit as
// many blocks per SM as the live instances do (8 at 256 threads, i.e. 32
// registers).
constexpr int kBlock = 256;
constexpr int kLazyBlocksPerSM = 8;

// The staged stream: tiles of kRows rows (= threads per block),
// slabs of kSlab slots, a ring of kStages slabs (kernel C's constants);
// at most kMaxRowBlocksPerSM blocks per SM (their launch bounds: at most
// 72 registers a thread), as many as the ring and the matrix's window
// leave room for (solver/fused.py::ell_row_plan).
constexpr int kRows = 128;
constexpr int kSlab = 4;
constexpr int kStages = 4;
constexpr int kSlabWords = kSlab * kRows;
constexpr int kMaxRowBlocksPerSM = 7;
constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may take
static_assert(kRows % 32 == 0 && kStages >= 3, "tile shape");
// the planes staged per ring stage: values, gather words, signal planes
template <int kPlanes>
constexpr int kStageWordsOf = (2 + kPlanes) * kSlabWords;
template <int kPlanes>
constexpr int kRingBytes = kStages * kStageWordsOf<kPlanes> * 4;

__device__ GridSync g_sync;   // grid_reduce's barrier state

struct EllPlanes {
  const float* vals;      // (K, R)
  const uint32_t* gsrc;   // (K, R) col word or gidx
  const int* ell_len;     // (R)
  uint32_t gmask;
  int K;
};

struct FusedArgs {
  int R;
  float* x;               // (R) in place
  float* r;               // (R) in place
  float* p;               // (R) in place
  float* w;               // (R) scratch: A p, then r1
  int hb;                 // the stream: the window's halo rows (a
                          // multiple of 4); -1: the l2 schedule
  DiaSignals sig;
  float* part_pw;         // (grid) per-block partials
  float* part_rr;         // (grid)
  int* part_flag;         // (grid)
  const int* iscal_in;    // itr, upto
  const float* fscal_in;  // rr, rz
  int* iscal_out;         // itr, trig, err
  float* fscal_out;       // rr, rz
  float* trace;           // (trace_len), written at [itr_in, itr_out)
  int trace_len;
  float conv;
};

// ---- The first design's loop: the split-tail instances and mode none's --
//
// kSignals: the detecting modes (a signal plane is streamed); mode none
// runs the instance without the signal code.  kPrecond, kLazy: the Jacobi
// and lazy instances (dia_common.cuh CgOpts); lazy implies kSignals.  The
// lazy instance's unchecked iterations run ell_row, its checked ones
// ell_row_signals: both sum the slots in order, so w is the same bits.
// kPlanes: the signal planes streamed (2: constraints mode on COO128).
template <bool kSignals, bool kTail, bool kPrecond, bool kLazy, int kPlanes>
__device__ __forceinline__ void cg_loop(const FusedArgs& a,
                                        const EllPlanes& m,
                                        const TailPlan& tp, const CgOpts& o) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float fbuf[33];
  __shared__ int ibuf[1];
  __shared__ TailShared<kTail> tsh;
  const int R = a.R;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int itr = a.iscal_in[0];
  const int upto = a.iscal_in[1];
  float rr = a.fscal_in[0];
  float rz = a.fscal_in[1];
  int trig = 0, err = 0;
  // lazy: the entry state is verified and seeds the snapshot
  int its = itr;
  float rrs = rr, rzs = rz;
  if constexpr (kLazy) {
    for (int i = tid; i < R; i += stride) {
      o.xs[i] = __ldcg(a.x + i);
      o.rs[i] = __ldcg(a.r + i);
      o.ps[i] = __ldcg(a.p + i);
    }
  }
  unsigned long long own = 0;  // the outlier rows this thread owns
  if constexpr (kTail) own = tail_stage(tp, tsh, tid, stride);

  while (itr < upto && rr > a.conv) {
    // lazy: only every ci-th iteration reads the signal planes
    const bool chk = !kLazy || itr % o.ci == o.ci - 1;
    if constexpr (kTail) tail_load_po(tp, tsh, a.p);
    // 1. ELL product + pw + signals
    float pw_l = 0.0f;
    int bad = 0;
    for (int i = tid; i < R; i += stride) {
      const float wr =
          kSignals && chk
              ? ell_row_signals<true, kPlanes>(m.vals, m.gsrc, m.gmask,
                                               m.ell_len, m.K, R, a.p, i,
                                               a.sig, &bad)
              : ell_row<true>(m.vals, m.gsrc, m.gmask, m.ell_len, m.K, R,
                              a.p, i);
      if constexpr (kTail) {
        // an outlier row waits for the dense sums; any other is final
        const int k = own ? tail_outlier(tsh, own, i) : -1;
        if (k >= 0) {
          tp.tmain[k] = wr;
        } else {
          const float wt = tail_axpy(tp, tsh, i, wr);
          a.w[i] = wt;
          pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wt));
        }
      } else {
        a.w[i] = wr;
        pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wr));
      }
    }
    if constexpr (kTail) {
      tail_dense_chunk(tp, tsh, a.p, fbuf);
      if (chk) bad |= tail_signals<kPlanes>(tp, tid, stride);
    }
    const float bpw = block_sum(pw_l, fbuf);
    const int bbad = block_any(bad, ibuf);
    if (threadIdx.x == 0) {
      a.part_pw[blockIdx.x] = bpw;
      a.part_flag[blockIdx.x] = bbad;
    }
    grid.sync();
    // 2. reduce; a trigger exits before any update
    float pw;
    if constexpr (kTail) {
      if (grid_any(a.part_flag, ibuf)) {
        trig = 1;
        break;
      }
      // the outlier rows, then pw over the complete product
      const float pw_rows = grid_total(a.part_pw, fbuf);
      pw = __fadd_rn(pw_rows, tail_finish(tp, tsh, a.w, own));
    } else {
      pw = grid_total(a.part_pw, fbuf);
      if (grid_any(a.part_flag, ibuf)) {
        trig = 1;
        break;
      }
    }
    // 3. r1 = r - alpha w into the w buffer, rr1 (and rz1) partials
    const float alpha = __fdiv_rn(rz, pw);
    float rr_l = 0.0f, rz_l = 0.0f;
    for (int i = tid; i < R; i += stride) {
      const float r1 =
          __fsub_rn(__ldcg(a.r + i), __fmul_rn(alpha, __ldcg(a.w + i)));
      a.w[i] = r1;
      rr_l = __fadd_rn(rr_l, __fmul_rn(r1, r1));
      if constexpr (kPrecond)
        rz_l = __fadd_rn(rz_l, __fmul_rn(r1, __fmul_rn(__ldg(o.minv + i), r1)));
    }
    const float brr = block_sum(rr_l, fbuf);
    if (threadIdx.x == 0) a.part_rr[blockIdx.x] = brr;
    if constexpr (kPrecond) {
      const float brz = block_sum(rz_l, fbuf);
      if (threadIdx.x == 0) o.part_rz[blockIdx.x] = brz;
    }
    grid.sync();
    const float rr1 = grid_total(a.part_rr, fbuf);
    float rz1 = rr1;
    if constexpr (kPrecond) rz1 = grid_total(o.part_rz, fbuf);
    if (pw <= 0.0f || !isfinite(rr1)) {
      err = ABFT_ERR_BREAKDOWN;
      break;
    }
    // 4. the update (each thread touches only its own rows)
    const float beta = __fdiv_rn(rz1, rz);
    for (int i = tid; i < R; i += stride) {
      const float pv = __ldcg(a.p + i);
      const float r1 = __ldcg(a.w + i);
      const float xn = __fadd_rn(__ldcg(a.x + i), __fmul_rn(alpha, pv));
      float z1 = r1;
      if constexpr (kPrecond) z1 = __fmul_rn(__ldg(o.minv + i), r1);
      const float pn = __fadd_rn(z1, __fmul_rn(beta, pv));
      a.x[i] = xn;
      a.r[i] = r1;
      a.p[i] = pn;
      if constexpr (kLazy) {
        if (chk) {  // a checked iteration that stood: verified state
          o.xs[i] = xn;
          o.rs[i] = r1;
          o.ps[i] = pn;
        }
      }
    }
    if (tid == 0 && itr < a.trace_len) a.trace[itr] = rr1;
    itr += 1;
    rr = rr1;
    rz = rz1;
    if constexpr (kLazy) {
      if (chk) {
        its = itr;
        rrs = rr1;
        rzs = rz1;
      }
    }
    grid.sync();
  }
  if constexpr (kLazy) {
    // A clean exit mid-window: one signals-only pass over the (K, R)
    // plane (and the tail's) closes the window (fused.py:1101-1155).
    if (its != itr && trig == 0 && err == 0) {
      int bad = 0;
      for (int i = tid; i < R; i += stride)
        bad |= dia_row_signals<kPlanes>(a.sig, m.K, R, i);
      if constexpr (kTail) bad |= tail_signals<kPlanes>(tp, tid, stride);
      const int bbad = block_any(bad, ibuf);
      if (threadIdx.x == 0) a.part_flag[blockIdx.x] = bbad;
      grid.sync();
      trig = grid_any(a.part_flag, ibuf);
    }
  }
  if (tid == 0) {
    a.iscal_out[0] = itr;
    a.iscal_out[1] = trig;
    a.iscal_out[2] = err;
    a.fscal_out[0] = rr;
    a.fscal_out[1] = rz;
    if constexpr (kLazy) {
      o.snap_iout[0] = its;
      o.snap_fout[0] = rrs;
      o.snap_fout[1] = rzs;
    }
  }
}

// Each __global__ below inlines the loop with its own launch bounds.
template <bool kSignals, bool kTail, bool kPrecond, int kPlanes = 1>
__global__ void __launch_bounds__(kBlock)
fused_cg_ell_kernel(FusedArgs a, EllPlanes m, TailPlan tp, CgOpts o) {
  cg_loop<kSignals, kTail, kPrecond, false, kPlanes>(a, m, tp, o);
}

template <bool kTail, bool kPrecond, int kPlanes = 1>
__global__ void __launch_bounds__(kBlock, kLazyBlocksPerSM)
fused_cg_ell_lazy_kernel(FusedArgs a, EllPlanes m, TailPlan tp, CgOpts o) {
  cg_loop<true, kTail, kPrecond, true, kPlanes>(a, m, tp, o);
}

// ---- The tail-free instances: the staged stream -------------------------

// Issue the copies of slab s (slots [s kSlab, min((s + 1) kSlab, K)) of
// the tile's ``nrows`` rows from r0) into ring stage ``st``: the value and
// gather planes if ``vals``, the signal plane(s) if ``sig``.  One 16-byte
// copy per plane, slot and 4 rows; consecutive threads take consecutive
// rows of a slot (kernel C's issue_slab).
template <int kPlanes>
__device__ __forceinline__ void issue_slab(uint32_t* st, const EllPlanes& m,
                                           const DiaSignals& sg, int R,
                                           int r0, int nrows, int s,
                                           bool vals, bool sig) {
  const int k0 = s * kSlab;
  const int q4 = nrows >> 2;
  const int chunks = min(kSlab, m.K - k0) * q4;
  for (int c = threadIdx.x; c < chunks; c += kRows) {
    const int k = c / q4;
    const int q = (c - k * q4) * 4;
    const size_t src = (size_t)(k0 + k) * R + r0 + q;
    const int dst = k * kRows + q;
    if (vals) {
      cp16(st + dst, m.vals + src);
      cp16(st + kSlabWords + dst, m.gsrc + src);
    }
    if (sig) {
      cp16(st + 2 * kSlabWords + dst, sg.plane + src);
      if constexpr (kPlanes == 2)
        cp16(st + 3 * kSlabWords + dst, sg.plane2 + src);
    }
  }
}

// The band window of p a block gathers from: rows [lo, lo + n) in win.
// An index outside it (n = 0 under the l2 schedule) reads p in device
// memory, through L2: other blocks wrote p in this launch.
struct Window {
  const float* win;
  const float* p;
  int lo;
  int n;
  uint32_t gmask;
  int R;
  __device__ __forceinline__ float operator()(uint32_t word) const {
    const int g = ell_gather(word, gmask, R);
    const int j = g - lo;
    return (unsigned)j < (unsigned)n ? win[j] : __ldcg(p + g);
  }
};

// The p gathers of one staged slab for this thread's row: slots k0 + jj,
// jj < cnt, their gather words at st[kSlabWords + jj kRows + t].
__device__ __forceinline__ void gather_slab(float* xv, const uint32_t* st,
                                            const Window& gat, int cnt) {
#pragma unroll
  for (int jj = 0; jj < kSlab; ++jj)
    if (jj < cnt) xv[jj] = gat(st[kSlabWords + jj * kRows + threadIdx.x]);
}

// One pass over the block's rows [lo, hi) in tiles of kRows: the product
// (``prod``: w of each row into a.w, its p . w term into ``pw``) and/or
// the signals (``sig``: OR into ``bad``).  With the product and a window
// (gat.n > 0), the window is staged first, after the barrier that
// published p: its copies are the first group, waited for with the first
// tile's prologue.  Kernel C's ring (ell_spmv_detect.cu): slab s +
// kStages - 1 is issued while slab s is summed, slab s + 1's gathers run
// while slab s is summed (from the window too: gathered in the slab's
// own step, with one slab more in flight, it was slower,
// scripts/torch_d_probe.py), value and gather slabs past the tile's
// longest row are skipped, signal slabs cover all K slots (a lazy
// instance's unchecked passes leave the signal part of each stage empty:
// slabs that filled the stage with more value and gather slots were
// slower, scripts/torch_d_probe.py).
template <int kPlanes>
__device__ __forceinline__ void stream_rows(const FusedArgs& a,
                                            const EllPlanes& m,
                                            uint32_t* ring, float* win,
                                            const Window& gat, int lo,
                                            int hi, bool prod, bool sig,
                                            int* wmax, float& pw,
                                            int& bad) {
  constexpr int kStageWords = kStageWordsOf<kPlanes>;
  const int t = threadIdx.x;
  const int R = a.R;
  const int nsig = sig ? (m.K + kSlab - 1) / kSlab : 0;
  if (prod && gat.n > 0)
    for (int i = 4 * t; i < gat.n; i += 4 * kRows)
      cp16(win + i, a.p + gat.lo + i);
  cp_commit();
  // Each tile's row lengths are loaded during the tile before it.
  int len = prod && lo + t < hi ? __ldg(m.ell_len + lo + t) : 0;
  for (int r0 = lo; r0 < hi; r0 += kRows) {
    // The tile's rows [r0, r0 + nrows); nrows is a multiple of 32, so
    // every warp is wholly in or wholly out.
    const int nrows = min(kRows, hi - r0);
    const bool live = t < nrows;
    const int r = r0 + t;
    const int n = live ? max(min(len, m.K), 0) : 0;
    len = prod && r + kRows < hi ? __ldg(m.ell_len + r + kRows) : 0;
    const int mx = __reduce_max_sync(ABFT_FULL_MASK, n);
    if ((t & 31) == 0) wmax[t >> 5] = mx;
    __syncthreads();
    int top = 0;
    for (int i = 0; i < kRows / 32; ++i) top = max(top, wmax[i]);
    const int nval = (top + kSlab - 1) / kSlab;   // slabs with a valid slot
    const int nsl = max(nval, nsig);
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsl)
        issue_slab<kPlanes>(ring + s * kStageWords, m, a.sig, R,
                                      r0, nrows, s, s < nval, s < nsig);
      cp_commit();
    }
    if (r0 == lo) {
      cp_wait<kStages - 1>();   // the window (the group before the tile's)
      __syncthreads();
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
        issue_slab<kPlanes>(ring + (sn % kStages) * kStageWords,
                                      m, a.sig, R, r0, nrows, sn, sn < nval,
                                      sn < nsig);
      cp_commit();
      if (!live) continue;
      const uint32_t* st = ring + (s % kStages) * kStageWords;
      const int k0 = s * kSlab;
      const int cnt = min(kSlab, n - k0);
      // The gathers run one slab ahead of the sums: slab s + 1's are in
      // flight while slab s is summed (slab 0's at the tile's start).
      if (s == 0) gather_slab(xc, st, gat, cnt);
      if (s + 1 < nval)
        gather_slab(xn, ring + ((s + 1) % kStages) * kStageWords, gat,
                    min(kSlab, n - k0 - kSlab));
      if (s < nsig) {
        const int ns = min(kSlab, m.K - k0);
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
      if (prod) {
        a.w[r] = wr;
        const float pr = gat.n > 0 ? win[r - gat.lo] : __ldcg(a.p + r);
        pw = __fadd_rn(pw, __fmul_rn(pr, wr));
      }
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
}

// The tail-free loop (the header's design): block b owns the rows [lo, hi)
// of ops/spmv.py::ell_block_rows; in the product pass thread t takes row
// lo + t of each tile, in the vector passes rows lo + 4t .. lo + 4t + 3 of
// each 4 kRows rows (16-byte loads).
template <bool kPrecond, bool kLazy, int kPlanes>
__device__ __forceinline__ void row_loop(const FusedArgs& a,
                                         const EllPlanes& m,
                                         const CgOpts& o) {
  constexpr int kStageWords = kStageWordsOf<kPlanes>;
  extern __shared__ __align__(16) uint32_t ring[];
  __shared__ float fbuf[72];
  __shared__ int ibuf[44];
  __shared__ int wmax[kRows / 32];
  float* win = reinterpret_cast<float*>(ring + kStages * kStageWords);
  const int R = a.R;
  const long long W = R >> 5;
  const int lo = (int)(W * blockIdx.x / gridDim.x) * 32;
  const int hi = (int)(W * (blockIdx.x + 1) / gridDim.x) * 32;
  const int t4 = 4 * threadIdx.x;
  Window gat{win, a.p, 0, 0, m.gmask, R};
  if (a.hb >= 0 && lo < hi) {
    gat.lo = max(lo - a.hb, 0);
    gat.n = min(hi + a.hb, R) - gat.lo;
  }
  int itr = a.iscal_in[0];
  const int upto = a.iscal_in[1];
  float rr = a.fscal_in[0];
  float rz = a.fscal_in[1];
  int trig = 0, err = 0;
  unsigned int gen = grid_generation(&g_sync);
  // lazy: the entry state is verified and seeds the snapshot
  int its = itr;
  float rrs = rr, rzs = rz;
  if constexpr (kLazy) {
    for (int r = lo + t4; r < hi; r += 4 * kRows) {
      st4(o.xs + r, ld4cg(a.x + r));
      st4(o.rs + r, ld4cg(a.r + r));
      st4(o.ps + r, ld4cg(a.p + r));
    }
  }
  while (itr < upto && rr > a.conv) {
    // lazy: only every ci-th iteration reads the signal planes
    const bool chk = !kLazy || itr % o.ci == o.ci - 1;
    // 1. the product, pw and the signals
    float pw_l = 0.0f;
    int bad = 0;
    stream_rows<kPlanes>(a, m, ring, win, gat, lo, hi, true, chk,
                                   wmax, pw_l, bad);
    // 2. pw and the trigger in one barrier; a trigger exits before the
    // update
    const Sums s1 = grid_reduce<true, false, true>(
        Sums{pw_l, 0.0f, bad}, a.part_pw, nullptr, a.part_flag, &g_sync, gen,
        fbuf, ibuf);
    if (s1.any) {
      trig = 1;
      break;
    }
    const float pw = s1.a;
    // 3. r1 = r - alpha w into the w buffer, rr1 and rz1
    const float alpha = __fdiv_rn(rz, pw);
    float rr_l = 0.0f, rz_l = 0.0f;
    for (int r = lo + t4; r < hi; r += 4 * kRows) {
      const float4 rv = ld4cg(a.r + r), wv = ld4cg(a.w + r);
      float4 mv = rv;
      if constexpr (kPrecond) mv = ld4(o.minv + r);
      const float4 r1 = make_float4(__fsub_rn(rv.x, __fmul_rn(alpha, wv.x)),
                                    __fsub_rn(rv.y, __fmul_rn(alpha, wv.y)),
                                    __fsub_rn(rv.z, __fmul_rn(alpha, wv.z)),
                                    __fsub_rn(rv.w, __fmul_rn(alpha, wv.w)));
      st4(a.w + r, r1);
      rr_l = __fadd_rn(rr_l, __fmul_rn(r1.x, r1.x));
      rr_l = __fadd_rn(rr_l, __fmul_rn(r1.y, r1.y));
      rr_l = __fadd_rn(rr_l, __fmul_rn(r1.z, r1.z));
      rr_l = __fadd_rn(rr_l, __fmul_rn(r1.w, r1.w));
      if constexpr (kPrecond) {
        rz_l = __fadd_rn(rz_l, __fmul_rn(r1.x, __fmul_rn(mv.x, r1.x)));
        rz_l = __fadd_rn(rz_l, __fmul_rn(r1.y, __fmul_rn(mv.y, r1.y)));
        rz_l = __fadd_rn(rz_l, __fmul_rn(r1.z, __fmul_rn(mv.z, r1.z)));
        rz_l = __fadd_rn(rz_l, __fmul_rn(r1.w, __fmul_rn(mv.w, r1.w)));
      }
    }
    const Sums s2 = grid_reduce<true, kPrecond, false>(
        Sums{rr_l, rz_l, 0}, a.part_rr, o.part_rz, nullptr, &g_sync, gen,
        fbuf, ibuf);
    const float rr1 = s2.a;
    const float rz1 = kPrecond ? s2.b : rr1;
    // breakdown: exit without the update
    if (pw <= 0.0f || !isfinite(rr1)) {
      err = ABFT_ERR_BREAKDOWN;
      break;
    }
    // 4. the update of the block's own rows, and the barrier that
    // publishes p
    const float beta = __fdiv_rn(rz1, rz);
    for (int r = lo + t4; r < hi; r += 4 * kRows) {
      const float4 pv = ld4cg(a.p + r), r1 = ld4cg(a.w + r);
      const float4 xv = ld4cg(a.x + r);
      float4 z1 = r1;
      if constexpr (kPrecond) {
        const float4 mv = ld4(o.minv + r);
        z1 = make_float4(__fmul_rn(mv.x, r1.x), __fmul_rn(mv.y, r1.y),
                         __fmul_rn(mv.z, r1.z), __fmul_rn(mv.w, r1.w));
      }
      const float4 xn = make_float4(
          __fadd_rn(xv.x, __fmul_rn(alpha, pv.x)),
          __fadd_rn(xv.y, __fmul_rn(alpha, pv.y)),
          __fadd_rn(xv.z, __fmul_rn(alpha, pv.z)),
          __fadd_rn(xv.w, __fmul_rn(alpha, pv.w)));
      const float4 pn = make_float4(__fadd_rn(z1.x, __fmul_rn(beta, pv.x)),
                                    __fadd_rn(z1.y, __fmul_rn(beta, pv.y)),
                                    __fadd_rn(z1.z, __fmul_rn(beta, pv.z)),
                                    __fadd_rn(z1.w, __fmul_rn(beta, pv.w)));
      st4(a.x + r, xn);
      st4(a.r + r, r1);
      st4(a.p + r, pn);
      if constexpr (kLazy) {
        if (chk) {  // a checked iteration that stood: verified state
          st4(o.xs + r, xn);
          st4(o.rs + r, r1);
          st4(o.ps + r, pn);
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && itr < a.trace_len)
      a.trace[itr] = rr1;
    itr += 1;
    rr = rr1;
    rz = rz1;
    if constexpr (kLazy) {
      if (chk) {
        its = itr;
        rrs = rr1;
        rzs = rz1;
      }
    }
    grid_reduce<false, false, false>(Sums{0.0f, 0.0f, 0}, nullptr, nullptr,
                                     nullptr, &g_sync, gen, fbuf, ibuf);
  }
  if constexpr (kLazy) {
    // A clean exit mid-window: one signals-only pass of the stream closes
    // the window (fused.py:1101-1155); a trigger here rolls the caller
    // back.
    if (its != itr && trig == 0 && err == 0) {
      float pw_l = 0.0f;
      int bad = 0;
      stream_rows<kPlanes>(a, m, ring, win, gat, lo, hi, false,
                                     true, wmax, pw_l, bad);
      trig = grid_reduce<false, false, true>(Sums{0.0f, 0.0f, bad}, nullptr,
                                             nullptr, a.part_flag, &g_sync,
                                             gen, fbuf, ibuf)
                 .any;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.iscal_out[0] = itr;
    a.iscal_out[1] = trig;
    a.iscal_out[2] = err;
    a.fscal_out[0] = rr;
    a.fscal_out[1] = rz;
    if constexpr (kLazy) {
      o.snap_iout[0] = its;
      o.snap_fout[0] = rrs;
      o.snap_fout[1] = rzs;
    }
  }
}

// Each __global__ below inlines its loop with its own launch bounds.
template <bool kPrecond, bool kLazy, int kPlanes>
__global__ void __launch_bounds__(kRows, kMaxRowBlocksPerSM)
fused_cg_ell_rows(FusedArgs a, EllPlanes m, CgOpts o) {
  row_loop<kPrecond, kLazy, kPlanes>(a, m, o);
}

// The first design's instance of (signals, tail, Jacobi, lazy, signal
// planes): a split tail's, or mode none's tail-free one; null for lazy
// without signals (mode none has no lazy schedule) and for the tail-free
// signal instances (they run the staged stream).  ``planes`` 2
// (constraints mode on COO128) selects the two-plane twin of a signal
// instance.
template <int kPlanes>
const void* tail_instance(bool precond, bool lazy) {
  const void* fns[4] = {
      (const void*)fused_cg_ell_kernel<true, true, false, kPlanes>,
      (const void*)fused_cg_ell_kernel<true, true, true, kPlanes>,
      (const void*)fused_cg_ell_lazy_kernel<true, false, kPlanes>,
      (const void*)fused_cg_ell_lazy_kernel<true, true, kPlanes>};
  return fns[(precond ? 1 : 0) + (lazy ? 2 : 0)];
}

const void* instance(bool signals, bool tail, bool precond, bool lazy,
                     int planes) {
  if (signals) {
    if (!tail) return nullptr;
    return planes == 2 ? tail_instance<2>(precond, lazy)
                       : tail_instance<1>(precond, lazy);
  }
  if (lazy) return nullptr;
  const void* fns[4] = {
      (const void*)fused_cg_ell_kernel<false, false, false>,
      (const void*)fused_cg_ell_kernel<false, false, true>,
      (const void*)fused_cg_ell_kernel<false, true, false>,
      (const void*)fused_cg_ell_kernel<false, true, true>};
  return fns[(precond ? 1 : 0) + (tail ? 2 : 0)];
}

// The staged stream's instance of (Jacobi, lazy, signal planes).
template <int kPlanes>
const void* rows_planes_instance(bool precond, bool lazy) {
  const void* fns[4] = {
      (const void*)fused_cg_ell_rows<false, false, kPlanes>,
      (const void*)fused_cg_ell_rows<true, false, kPlanes>,
      (const void*)fused_cg_ell_rows<false, true, kPlanes>,
      (const void*)fused_cg_ell_rows<true, true, kPlanes>};
  return fns[(precond ? 1 : 0) + (lazy ? 2 : 0)];
}

const void* rows_instance(bool precond, bool lazy, int planes) {
  return planes == 2 ? rows_planes_instance<2>(precond, lazy)
                     : rows_planes_instance<1>(precond, lazy);
}

// The dynamic shared memory of a staged-stream launch: the ring, and
// under the window schedule (hb >= 0) the largest block's window, its
// rows of ell_block_rows and hb rows on either side (solver/fused.py::
// ell_window_rows).
long long row_smem(int planes, int R, int grid, int hb) {
  long long bytes = planes == 2 ? kRingBytes<2> : kRingBytes<1>;
  if (hb >= 0)
    bytes += 4 * ((long long)(R / 32 + grid - 1) / grid * 32 + 2LL * hb);
  return bytes;
}

// Lets a tail-free instance take its ring and window (above the 48 KB
// default) and the SM's whole shared-memory carveout.
cudaError_t allow_smem(const void* fn, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15u) == 0; }

}  // namespace

// Resident blocks per SM of the staged stream's instances that share a
// grid — live, lazy, Jacobi and lazy Jacobi, streaming ``planes`` signal
// planes — at ``smem`` bytes of dynamic shared memory: the least of
// theirs, at most kMaxRowBlocksPerSM; and the SMs of ``device``.  Returns
// a cudaError_t.
extern "C" int abft_fused_ell_occupancy(int device, int planes, int smem,
                                        int* per_sm, int* sms) {
  if (planes < 1 || planes > 2 || smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int least = kMaxRowBlocksPerSM;
  for (int k = 0; k < 4; ++k) {
    const void* fn = rows_instance(k & 1, k & 2, planes);
    int n = 0;
    err = allow_smem(fn, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kRows,
                                                          smem);
    if (err != cudaSuccess) return (int)err;
    least = min(least, n);
  }
  *per_sm = least;
  return (int)cudaSuccess;
}

// Largest co-resident grid for the cooperative launch on ``device``: SMs
// x resident blocks per SM.  Of the first design's loop with a split tail
// (``tail``), for both signal instances of (``precond``) live (the signal
// one streaming ``planes`` planes), or for the lazy instance (signals
// only); without a tail, mode none's instance (``lazy`` 0), or the staged
// stream's lazy instances under the l2 schedule (the ring alone: the most
// any of their launches takes).  Returns a cudaError_t.
extern "C" int abft_fused_ell_grid(int device, int tail, int precond,
                                   int lazy, int planes, int* grid) {
  if (planes < 1 || planes > 2) return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  int coop = 0, sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 1 << 30;
  for (int signals = 1; signals >= 0; --signals) {
    const void* fn = instance(signals, tail, precond, lazy, planes);
    if (fn == nullptr) continue;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = min(per_sm, n);
  }
  if (per_sm == 1 << 30) {   // no first-design instance: the stream's
    err = (cudaError_t)abft_fused_ell_occupancy(
        device, planes, planes == 2 ? kRingBytes<2> : kRingBytes<1>,
        &per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
  }
  *grid = sms * per_sm;
  return *grid > 0 ? (int)cudaSuccess : (int)cudaErrorLaunchOutOfResources;
}

// ``hb``: the signal instances' tail-free schedule — the window's halo
// rows (a multiple of 4), or -1 for the l2 schedule; mode none and the
// split tail run the first design's loop, which ignores it.  The staged
// stream needs R >= 32, grid <= R / 32 with the ring and the largest
// block's window (row_smem) resident at that grid, and every plane and
// vector 16-byte aligned.
extern "C" int abft_fused_cg_ell(
    const float* vals, const uint32_t* gsrc, unsigned gmask,
    const int* ell_len, int K, int R, float* x, float* r, float* p,
    float* w, const uint32_t* plane, const uint32_t* base,
    const uint32_t* plane2, const uint32_t* base2, int use_parity,
    int use_cksum, float* part_pw, float* part_rr, int* part_flag,
    int grid, const int* iscal_in, const float* fscal_in, int* iscal_out,
    float* fscal_out, float* trace, int trace_len, float conv,
    const float* td, const float* tb, const int* trows, const int* tstarts,
    const unsigned long long* ttiles, int T, int S, int tchunk,
    float* tpart, float* tmain, const uint32_t* tplane,
    const uint32_t* tbase, const uint32_t* tplane2, const uint32_t* tbase2,
    int E, const float* minv, float* part_rz,
    float* xs, float* rs, float* ps, int ci, int* snap_iout,
    float* snap_fout, int hb, int device, void* stream) {
  const bool precond = minv != nullptr, lazy = ci > 1, tail = T > 0;
  const int planes = plane2 != nullptr ? 2 : 1;
  if (K < 1 || K > ABFT_MAX_K || R % 32 != 0 || grid < 1 || ci < 1 ||
      (plane2 != nullptr && (plane == nullptr || base2 == nullptr)) ||
      (tail && tplane != nullptr && (tplane2 != nullptr) != (planes == 2)) ||
      (precond && part_rz == nullptr) ||
      (lazy && (plane == nullptr || xs == nullptr || rs == nullptr ||
                ps == nullptr || snap_iout == nullptr ||
                snap_fout == nullptr)))
    return (int)cudaErrorInvalidValue;
  TailPlan t;
  if (!make_tail_plan(&t, td, tb, trows, tstarts, ttiles, T, S, tchunk,
                      tpart, tmain, tplane, tbase, tplane2, tbase2, use_parity,
                      use_cksum, E, p))
    return (int)cudaErrorInvalidValue;
  const bool signals = plane != nullptr;
  const bool first = tail || !signals;   // the first design's loop
  if (!first) {
    // the 16-byte copies and loads, the partition, the window
    const void* vecs[] = {vals, gsrc, plane, plane2, x,  r,
                          p,    w,    minv,  xs,     rs, ps};
    for (const void* v : vecs)
      if (!aligned16(v)) return (int)cudaErrorInvalidValue;
    if (R < 32 || grid > R / 32 || hb < -1 || (hb >= 0 && hb % 4 != 0) ||
        row_smem(planes, R, grid, hb) > kMaxSmem)
      return (int)cudaErrorInvalidValue;
  }
  const int smem = first ? 0 : (int)row_smem(planes, R, grid, hb);
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  int max_grid = 0;
  if (first) {
    const int rc =
        abft_fused_ell_grid(device, tail, precond, lazy, planes, &max_grid);
    if (rc != (int)cudaSuccess) return rc;
  } else {
    // the blocks per SM at this launch's shared memory (and the instance
    // allowed it)
    int per_sm = 0, sms = 0;
    const int rc =
        abft_fused_ell_occupancy(device, planes, smem, &per_sm, &sms);
    if (rc != (int)cudaSuccess) return rc;
    max_grid = per_sm * sms;
  }
  if (grid > max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  EllPlanes m{vals, gsrc, ell_len, gmask, K};
  FusedArgs a;
  a.R = R;
  a.x = x;
  a.r = r;
  a.p = p;
  a.w = w;
  a.hb = hb;
  a.sig = DiaSignals{plane, base, use_parity, use_cksum, plane2, base2};
  a.part_pw = part_pw;
  a.part_rr = part_rr;
  a.part_flag = part_flag;
  a.iscal_in = iscal_in;
  a.fscal_in = fscal_in;
  a.iscal_out = iscal_out;
  a.fscal_out = fscal_out;
  a.trace = trace;
  a.trace_len = trace_len;
  a.conv = conv;
  CgOpts o{minv, part_rz, xs, rs, ps, ci, snap_iout, snap_fout};
  cudaError_t err;
  if (first) {
    void* args[] = {&a, &m, &t, &o};
    err = cudaLaunchCooperativeKernel(
        instance(signals, tail, precond, lazy, planes), dim3(grid),
        dim3(kBlock), args, 0, (cudaStream_t)stream);
  } else {
    void* args[] = {&a, &m, &o};
    err = cudaLaunchCooperativeKernel(
        rows_instance(precond, lazy, planes), dim3(grid),
        dim3(kRows), args, smem, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
