// Kernel B: fused_cg_dia — the whole detect-fast CG loop in one kernel.
//
// Replaces the DIA branch of the TPU kernel abft_sparse_cg_tpu/solver/
// fused.py::_make_kernel (pallas_call at :1248): while itr < upto and
// rr > conv, one iteration k is
//   1. w = A p_k over the DIA planes, pw = p_k . w, and the live signals
//      of the streamed word plane (dia_common.cuh), as kernel A does;
//   2. a fired trigger exits WITHOUT the update (the caller classifies
//      and re-executes the iteration, solver/cg.py:458-478);
//   3. alpha = rz / pw, r1 = r - alpha w, rr1 (and rz1 = r1 . M^-1 r1);
//   4. pw <= 0 or a non-finite rr1 sets err = 7 (ERR_BREAKDOWN) and
//      exits without the update;
//   5. x += alpha p, r = r1, p = z1 + (rz1 / rz) p (z1 = r1, or M^-1 r1),
//      trace[itr] = rr1, itr += 1.
// The exit state in the caller's x, r and p is exactly the plain loop's:
// after a trigger or a breakdown, the state before that iteration.  The
// trace is written only at slots [itr_in, itr_out).  The Jacobi
// (kPrecond) and lazy --check-interval (kLazy) instances are the
// `precond` and `ci > 1` branches of the same TPU kernel (fused.py:
// 552-678, 912-1155; dia_common.cuh CgOpts); the same instances run the
// `-b 100` solves that the TPU routes to _make_streaming_kernel
// (pallas_call at :1931; the H100 has no resident-vector envelope).
//
// What bounds it on the H100: bytes per iteration — the plane streams
// (D values and, detecting, D signal words per row) and the CG vectors
// (x, r, p read and written, w written and read: 8 floats per row) —
// and, at small sizes, the grid-wide barriers and reductions.  At -b 10
// (819,200 rows) an iteration's 36-46 MB fit the 50 MB L2; at -b 100
// (8.2M rows, 360-459 MB) they stream from HBM.
//
// What the design does about it (the tail-free instances; PERF.md §6):
//   - kernel A's product: each thread takes four consecutive rows of its
//     block's contiguous range, in tiles of kTile rows, with 16-byte
//     loads of the value plane and, beside each diagonal's values, of
//     its signal words; each row still adds its D products in diagonal
//     order with explicitly rounded multiplies and adds, so w is
//     bit-identical to ops/spmv.py::dia_product, and pw takes p from the
//     registers that fed the stencil; the r1 pass loads two tiles at a
//     time;
//   - two grid barriers per iteration (the "fold" schedule): the update
//     of iteration k - 1 runs in iteration k's product pass.  Before the
//     stencil, each block writes x, p_k = z1 + beta p_(k-1) (and a
//     checked lazy iteration's snapshot) for its own rows and stages p_k
//     of its tile and of max|offset| halo rows on either side in shared
//     memory; the halo rows belong to other blocks and are recomputed
//     from r1 and p_(k-1) with the same rounded operations, so they are
//     bit-identical.  r and p are double-buffered (the caller's and r2,
//     p2): written in place, a block would overwrite r1 or p_(k-1) while
//     a neighbour still reads them for its halo.  An exit by convergence
//     or the limit runs the last update in one pass; every exit leaves
//     the state in the caller's buffers.  Where max|offset| passes
//     kFoldHalo (solver/fused.py::dia_schedule decides once per matrix)
//     the shared tile would not fit, and the "window" schedule runs: the
//     same product, then the r1 pass, then the update pass, three
//     barriers (the fold was the faster one at every halo measured up to
//     the cap); its product reads p from shared memory, one window per
//     cluster of diagonal offsets (solver/fused.py::dia_window_plan: the
//     tile's rows shifted by the cluster's least offset, and the
//     cluster's width more), staged with cp.async for the next tile
//     while the stencil runs on this one (two window sets), and streams
//     the planes without allocating in L1.  Gathered from L2 instead,
//     a warp's scalar reads of p fetch ~4x the bytes they deliver: on
//     HPCG's 104^3 stencil the window takes ~128 us per live iteration
//     where that gather took ~155 (PERF.md §6).  Where the windows do
//     not fit kWindowSmem, the "three-sync" schedule gathers p from
//     device memory instead;
//   - grid reductions without the O(grid^2) re-read: one barrier both
//     synchronises and reduces (dia_common.cuh grid_reduce: the block
//     that arrives last sums the partials in a fixed order and publishes
//     the totals), and the trigger's OR rides on the pw barrier;
//   - a grid of kRowBlocksPerSM blocks per SM for every tail-free
//     instance, live or lazy, Jacobi or not: the same partition and
//     reduction order, so a clean lazy solve equals the live one bit for
//     bit (at 4, 64 registers; 6 and 8 spill and were slower, 2 and 3
//     keep too few bytes in flight).
// One persistent cooperative launch runs the whole solve; no float
// atomics, so two runs print identical rr lines.
//
// Constraints mode on COO128 streams two signal planes, the col and the
// row word, each against its own baseline (dia_common.cuh): every
// instance below has a kPlanes = 2 twin that loads the second plane's
// words beside the first's, in the product pass, the lazy instances'
// every-CI-th scan and their exit-window pass.
//
// A bordered split with a dense plan runs the instances with the split
// tail (dia_common.cuh TailPlan, solver/fused.py:977-1014), which
// keep their own loop, tail_loop below: one row per thread, grid-strided,
// three grid syncs per iteration, every block re-reading the partials.
// Step 1 also adds each non-outlier row's mirrored AXPY terms right
// after its stencil, keeps the outlier rows' stencil aside, sums the
// chunk partials of the tail's dense rows and folds the tail's signals;
// after the sync and the trigger test, every block finishes the outlier
// rows and adds their p . w to pw.  x, r and p are updated in place
// there.
//
// Interface: plain C through ctypes; launches with
// cudaLaunchCooperativeKernel on the caller's stream, allocates
// nothing, returns the cudaError_t.

#include <cooperative_groups.h>

#include "cp_async.cuh"
#include "dia_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
// The split-tail lazy instances are launched with their live
// counterpart's grid, so that every reduction sums in the same order and
// a clean lazy solve equals the live one bit for bit: they must fit as
// many blocks per SM as the live instances do (8 at 256 threads, i.e. 32
// registers).
constexpr int kLazyBlocksPerSM = 8;
// The tail-free instances: four rows per thread, tiles of kTile rows, a
// grid of kRowBlocksPerSM blocks per SM for all of them, and the fold
// schedule's halo cap (its shared tile holds kTile + 2 kFoldHalo rows).
constexpr int kRows = 4;
constexpr int kTile = kRows * kBlock;
constexpr int kRowBlocksPerSM = 4;
constexpr int kFoldHalo = 512;
// The window schedule: at most kMaxWindows windows, and the two window
// sets in at most kWindowSmem bytes of dynamic shared memory (4 blocks of
// it and their static arrays fit the SM's 228 KB).
constexpr int kMaxWindows = 8;
constexpr int kWindowSmem = 48 * 1024;

__device__ GridSync g_sync;   // grid_reduce's barrier state

struct FusedArgs {
  const float* vals;      // (D, R)
  int R;
  float* x;               // (R) in place
  float* r;               // (R) in place
  float* p;               // (R) in place
  float* w;               // (R) scratch: A p (then r1, but in the fold)
  float* r2;              // (R) fold: the second r and p buffers
  float* p2;
  int nb;                 // tail-free: rows per block, a multiple of 8
  int halo;               // fold: max |offset|
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

// The window schedule's plan (solver/fused.py::dia_window_plan), passed
// by value: window c holds the rows [lo + start[c], hi + start[c] +
// ext[c]) of a tile [lo, hi) at float at[c] of a window set of ``set``
// floats; diagonal d reads row lo + 4t + j + off[d] of its window at
// shift[d] + 4t + j of the set.
struct WindowPlan {
  int n;
  int set;
  int start[kMaxWindows];
  int ext[kMaxWindows];
  int at[kMaxWindows];
  int shift[ABFT_MAX_D];
};

// 16 bytes of a plane the window schedule's stencil streams once, read
// without allocating in L1 (L1::no_allocate): with p in shared memory the
// planes are the stencil's only loads from device memory, and cycling
// them through L1 cost 8-12% of the solve on HPCG's stencil (PERF.md §6).
// The fold and three-sync keep ld4 / __ldg: with these loads the fold's
// -b 100 solves took 0.9-1.5% longer in every mode (PERF.md §6).
__device__ __forceinline__ float4 ld4_stream(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ldu4_stream(const uint32_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Copies p's rows of the windows of tile [lo, hi) into ``set`` (16-byte
// cp.async through L2; the caller commits and waits), rows outside
// [0, R) as 0: every window starts at a multiple of 4 rows and R is a
// multiple of 32, so a 16-byte group is wholly inside or outside.
__device__ __forceinline__ void stage_windows(float* set,
                                              const WindowPlan& wp,
                                              const float* p, int R, int lo,
                                              int hi) {
  for (int c = 0; c < wp.n; ++c) {
    const int j0 = lo + wp.start[c];
    float* dst = set + wp.at[c];
    const int n4 = (hi - lo + wp.ext[c]) >> 2;
    for (int q = threadIdx.x; q < n4; q += kBlock) {
      const int j = j0 + 4 * q;
      if (j >= 0 && j < R)
        cp16(dst + 4 * q, p + j);
      else
        st4(dst + 4 * q, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// The split-tail instances' loop (their own schedule: one row per thread,
// grid-strided, three grid syncs); each __global__ below inlines it with
// its own launch bounds.
template <bool kPrecond, bool kLazy, int kPlanes>
__device__ __forceinline__ void tail_loop(const FusedArgs& a,
                                          const DiaOffsets& offs,
                                          const TailPlan& tp,
                                          const CgOpts& o) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float fbuf[33];
  __shared__ int ibuf[1];
  __shared__ TailShared<true> tsh;
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
  // the outlier rows this thread owns
  const unsigned long long own = tail_stage(tp, tsh, tid, stride);

  while (itr < upto && rr > a.conv) {
    // lazy: only every ci-th iteration reads the signal planes
    const bool chk = !kLazy || itr % o.ci == o.ci - 1;
    tail_load_po(tp, tsh, a.p);
    // 1. stencil + pw + signals
    float pw_l = 0.0f;
    int bad = 0;
    for (int i = tid; i < R; i += stride) {
      const float wr = dia_row<true>(a.vals, offs, R, a.p, i);
      // an outlier row waits for the dense sums; any other is final
      const int k = own ? tail_outlier(tsh, own, i) : -1;
      if (k >= 0) {
        tp.tmain[k] = wr;
      } else {
        const float wt = tail_axpy(tp, tsh, i, wr);
        a.w[i] = wt;
        pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wt));
      }
      if (a.sig.plane != nullptr && chk)
        bad |= dia_row_signals<kPlanes>(a.sig, offs.n, R, i);
    }
    tail_dense_chunk(tp, tsh, a.p, fbuf);
    if (chk) bad |= tail_signals<kPlanes>(tp, tid, stride);
    const float bpw = block_sum(pw_l, fbuf);
    const int bbad = block_any(bad, ibuf);
    if (threadIdx.x == 0) {
      a.part_pw[blockIdx.x] = bpw;
      a.part_flag[blockIdx.x] = bbad;
    }
    grid.sync();
    // 2-3. reduce; a trigger exits before any update
    if (grid_any(a.part_flag, ibuf)) {
      trig = 1;
      break;
    }
    // the outlier rows, then pw over the complete product
    const float pw_rows = grid_total(a.part_pw, fbuf);
    const float pw = __fadd_rn(pw_rows, tail_finish(tp, tsh, a.w, own));
    // 4. r1 = r - alpha w into the w buffer, rr1 (and rz1) partials
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
    // 5. breakdown: exit without the update
    if (pw <= 0.0f || !isfinite(rr1)) {
      err = ABFT_ERR_BREAKDOWN;
      break;
    }
    // 6. the update (each thread touches only its own rows)
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
    // A clean exit mid-window: one signals-only pass closes the window
    // (fused.py:1101-1155); a trigger here rolls the caller back.
    if (its != itr && trig == 0 && err == 0) {
      int bad = 0;
      if (a.sig.plane != nullptr)
        for (int i = tid; i < R; i += stride)
          bad |= dia_row_signals<kPlanes>(a.sig, offs.n, R, i);
      bad |= tail_signals<kPlanes>(tp, tid, stride);
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

// The tail-free loop (the header's design): block b owns rows
// [b nb, (b + 1) nb); thread t takes rows lo + 4t .. lo + 4t + 3 of each
// kTile-row tile [lo, hi) of that range, in every pass, so each thread
// reads back only rows it wrote itself, but for the fold's halo rows.
// ``wp``: the window schedule's plan (kWindow), else null.
template <bool kFold, bool kWindow, bool kPrecond, bool kLazy, int kPlanes>
__device__ __forceinline__ void row_loop(const FusedArgs& a,
                                         const DiaOffsets& offs,
                                         const WindowPlan* wp,
                                         const CgOpts& o) {
  __shared__ float fbuf[72];
  __shared__ int ibuf[44];
  __shared__ __align__(16) float tile[kFold ? kTile + 2 * kFoldHalo + 8 : 4];
  // the window schedule's two window sets
  extern __shared__ __align__(16) float wsets[];
  const int R = a.R;
  const int lo0 = min((int)blockIdx.x * a.nb, R);
  const int hi0 = min(lo0 + a.nb, R);
  const int t4 = kRows * threadIdx.x;
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
    for (int r = lo0 + t4; r < hi0; r += kTile) {
      st4(o.xs + r, ld4cg(a.x + r));
      st4(o.rs + r, ld4cg(a.r + r));
      st4(o.ps + r, ld4cg(a.p + r));
    }
  }
  // The fold's buffers: r_k in r[cr]; p_k in p[cp] when nothing is
  // pending, else p_(k-1) in p[cp] and p_k goes to p[cp ^ 1].
  int cr = 0, cp = 0;
  bool pend = false, chk_p = false;
  float alpha_p = 0.0f, beta_p = 0.0f;
  auto rbuf = [&](int i) { return i ? a.r2 : a.r; };
  auto pbuf = [&](int i) { return i ? a.p2 : a.p; };
  // z = r or M^-1 r, then z + beta p: p_(k+1) of one row
  auto next_p = [&](float rv, float pv, float mv, float beta) {
    const float z = kPrecond ? __fmul_rn(mv, rv) : rv;
    return __fadd_rn(z, __fmul_rn(beta, pv));
  };

  while (itr < upto && rr > a.conv) {
    // lazy: only every ci-th iteration reads the signal planes
    const bool chk = !kLazy || itr % o.ci == o.ci - 1;
    const float* rcur = rbuf(cr);
    const float* pold = pbuf(cp);
    float* pnew = pbuf(cp ^ 1);
    // 1. (the pending update,) stencil, pw and signals
    float pw_l = 0.0f;
    int bad = 0;
    if constexpr (kWindow) {
      if (lo0 < hi0)
        stage_windows(wsets, *wp, a.p, R, lo0, min(lo0 + kTile, hi0));
      cp_commit();
    }
    int cur = 0;   // the window set of this tile
    for (int lo = lo0; lo < hi0; lo += kTile, cur ^= 1) {
      const int hi = min(lo + kTile, hi0);
      const int r = lo + t4;
      float4 pk = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kFold) {
        if (r < hi) {
          if (pend) {
            const float4 rv = ld4cg(rcur + r), pv = ld4cg(pold + r);
            const float4 xv = ld4cg(a.x + r);
            float4 mv = rv;
            if constexpr (kPrecond) mv = ld4(o.minv + r);
            pk = make_float4(next_p(rv.x, pv.x, mv.x, beta_p),
                             next_p(rv.y, pv.y, mv.y, beta_p),
                             next_p(rv.z, pv.z, mv.z, beta_p),
                             next_p(rv.w, pv.w, mv.w, beta_p));
            const float4 xn = make_float4(
                __fadd_rn(xv.x, __fmul_rn(alpha_p, pv.x)),
                __fadd_rn(xv.y, __fmul_rn(alpha_p, pv.y)),
                __fadd_rn(xv.z, __fmul_rn(alpha_p, pv.z)),
                __fadd_rn(xv.w, __fmul_rn(alpha_p, pv.w)));
            st4(a.x + r, xn);
            st4(pnew + r, pk);
            if constexpr (kLazy) {
              if (chk_p) {  // the pending iteration was checked: verified
                st4(o.xs + r, xn);
                st4(o.rs + r, rv);
                st4(o.ps + r, pk);
              }
            }
          } else {
            pk = ld4cg(pold + r);
          }
          reinterpret_cast<float4*>(tile)[kFoldHalo / 4 + threadIdx.x] = pk;
        }
        // the halo rows, zero outside [0, R)
        for (int h = threadIdx.x; h < 2 * a.halo; h += kBlock) {
          const int j = h < a.halo ? lo - a.halo + h : hi + h - a.halo;
          float v = 0.0f;
          if (j >= 0 && j < R) {
            if (pend) {
              const float mv = kPrecond ? __ldg(o.minv + j) : 0.0f;
              v = next_p(__ldcg(rcur + j), __ldcg(pold + j), mv, beta_p);
            } else {
              v = __ldcg(pold + j);
            }
          }
          tile[kFoldHalo + j - lo] = v;
        }
        __syncthreads();
      } else {
        if (r < hi) pk = ld4cg(a.p + r);
      }
      if constexpr (kWindow) {
        // the next tile's windows into the other set, in flight during
        // this tile's stencil (that set's last reader was the tile before,
        // which ended with a __syncthreads)
        const int nlo = lo + kTile;
        if (nlo < hi0)
          stage_windows(wsets + (cur ^ 1) * wp->set, *wp, a.p, R, nlo,
                        min(nlo + kTile, hi0));
        cp_commit();
        cp_wait<1>();     // this thread's copies of this tile's set
        __syncthreads();  // everyone's
      }
      // the stencil, and the signal words beside the values (both
      // planes' loads in flight together)
      const bool sig = a.sig.plane != nullptr && chk;
      uint32_t acc = 0, acc2 = 0;
      if (r < hi) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        for (int d = 0; d < offs.n; ++d) {
          const float* vp = a.vals + (size_t)d * R + r;
          const float4 v = kWindow ? ld4_stream(vp) : ld4(vp);
          if (sig) {
            const uint32_t* up = a.sig.plane + (size_t)d * R + r;
            const uint4 u = kWindow ? ldu4_stream(up)
                                    : __ldg(reinterpret_cast<const uint4*>(up));
            uint4 pu = u;
            if constexpr (kPlanes == 2) {
              const uint32_t* up2 = a.sig.plane2 + (size_t)d * R + r;
              const uint4 u2 =
                  kWindow ? ldu4_stream(up2)
                          : __ldg(reinterpret_cast<const uint4*>(up2));
              acc2 ^= u2.x ^ u2.y ^ u2.z ^ u2.w;
              pu = make_uint4(u.x ^ u2.x, u.y ^ u2.y, u.z ^ u2.z, u.w ^ u2.w);
            }
            if (a.sig.use_parity)
              bad |= (__popc(pu.x) | __popc(pu.y) | __popc(pu.z) |
                      __popc(pu.w)) &
                     1;
            acc ^= u.x ^ u.y ^ u.z ^ u.w;
          }
          float4 s;
          if constexpr (kFold) {
            s = tile_window(tile, kFoldHalo + t4 + offs.off[d]);
          } else if constexpr (kWindow) {
            s = tile_window(wsets + cur * wp->set, t4 + wp->shift[d]);
          } else {
            const int c = r + offs.off[d];
            s.x = (c >= 0 && c < R) ? __ldcg(a.p + c) : 0.0f;
            s.y = (c + 1 >= 0 && c + 1 < R) ? __ldcg(a.p + c + 1) : 0.0f;
            s.z = (c + 2 >= 0 && c + 2 < R) ? __ldcg(a.p + c + 2) : 0.0f;
            s.w = (c + 3 >= 0 && c + 3 < R) ? __ldcg(a.p + c + 3) : 0.0f;
          }
          a0 = __fadd_rn(a0, __fmul_rn(v.x, s.x));
          a1 = __fadd_rn(a1, __fmul_rn(v.y, s.y));
          a2 = __fadd_rn(a2, __fmul_rn(v.z, s.z));
          a3 = __fadd_rn(a3, __fmul_rn(v.w, s.w));
        }
        st4(a.w + r, make_float4(a0, a1, a2, a3));
        pw_l = __fadd_rn(pw_l, __fmul_rn(pk.x, a0));
        pw_l = __fadd_rn(pw_l, __fmul_rn(pk.y, a1));
        pw_l = __fadd_rn(pw_l, __fmul_rn(pk.z, a2));
        pw_l = __fadd_rn(pw_l, __fmul_rn(pk.w, a3));
      }
      if (sig && a.sig.use_cksum) {
        // lo and the range's end are multiples of 8: an 8-row checksum
        // block is threads 2j and 2j + 1, both in range or both not, and
        // every lane takes the shuffle.
        acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
        if (r < hi && (threadIdx.x & 1) == 0 &&
            acc != __ldg(a.sig.base + (r >> 3)))
          bad = 1;
        if constexpr (kPlanes == 2) {
          acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 1);
          if (r < hi && (threadIdx.x & 1) == 0 &&
              acc2 != __ldg(a.sig.base2 + (r >> 3)))
            bad = 1;
        }
      }
      if constexpr (kFold || kWindow) __syncthreads();  // the next stage
    }
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
    // 3. r1 = r - alpha w (the next r buffer, or the w buffer), rr1, rz1
    const float alpha = __fdiv_rn(rz, pw);
    float* r1buf = kFold ? rbuf(cr ^ 1) : a.w;
    float rr_l = 0.0f, rz_l = 0.0f;
    auto r1_rows = [&](int r, float4 rv, float4 wv, float4 mv) {
      const float4 r1 = make_float4(__fsub_rn(rv.x, __fmul_rn(alpha, wv.x)),
                                    __fsub_rn(rv.y, __fmul_rn(alpha, wv.y)),
                                    __fsub_rn(rv.z, __fmul_rn(alpha, wv.z)),
                                    __fsub_rn(rv.w, __fmul_rn(alpha, wv.w)));
      st4(r1buf + r, r1);
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
    };
    // two tiles' loads in flight at a time
    for (int r = lo0 + t4; r < hi0; r += 2 * kTile) {
      const bool two = r + kTile < hi0;
      const float4 rv = ld4cg(rcur + r), wv = ld4cg(a.w + r);
      float4 rv2 = rv, wv2 = wv, mv = rv, mv2 = rv;
      if (two) {
        rv2 = ld4cg(rcur + r + kTile);
        wv2 = ld4cg(a.w + r + kTile);
      }
      if constexpr (kPrecond) {
        mv = ld4(o.minv + r);
        if (two) mv2 = ld4(o.minv + r + kTile);
      }
      r1_rows(r, rv, wv, mv);
      if (two) r1_rows(r + kTile, rv2, wv2, mv2);
    }
    const Sums s2 = grid_reduce<true, kPrecond, false>(
        Sums{rr_l, rz_l, 0}, a.part_rr, o.part_rz, nullptr, &g_sync, gen,
        fbuf, ibuf);
    const float rr1 = s2.a;
    const float rz1 = kPrecond ? s2.b : rr1;
    // 4. breakdown: exit without the update
    if (pw <= 0.0f || !isfinite(rr1)) {
      err = ABFT_ERR_BREAKDOWN;
      break;
    }
    // 5. the update: pending until the next product pass (fold), or a
    // pass of its own and a third barrier
    const float beta = __fdiv_rn(rz1, rz);
    if constexpr (kFold) {
      if (pend) cp ^= 1;  // p_k is in the buffer the stage wrote
      cr ^= 1;
      pend = true;
      alpha_p = alpha;
      beta_p = beta;
      chk_p = chk;
    } else {
      for (int r = lo0 + t4; r < hi0; r += kTile) {
        const float4 pv = ld4cg(a.p + r), r1 = ld4cg(a.w + r);
        const float4 xv = ld4cg(a.x + r);
        float4 mv = r1;
        if constexpr (kPrecond) mv = ld4(o.minv + r);
        const float4 xn = make_float4(
            __fadd_rn(xv.x, __fmul_rn(alpha, pv.x)),
            __fadd_rn(xv.y, __fmul_rn(alpha, pv.y)),
            __fadd_rn(xv.z, __fmul_rn(alpha, pv.z)),
            __fadd_rn(xv.w, __fmul_rn(alpha, pv.w)));
        const float4 pn = make_float4(next_p(r1.x, pv.x, mv.x, beta),
                                      next_p(r1.y, pv.y, mv.y, beta),
                                      next_p(r1.z, pv.z, mv.z, beta),
                                      next_p(r1.w, pv.w, mv.w, beta));
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
      grid_reduce<false, false, false>(Sums{0.0f, 0.0f, 0}, nullptr,
                                       nullptr, nullptr, &g_sync, gen, fbuf,
                                       ibuf);
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
  }
  if constexpr (kFold) {
    // Every exit leaves the state in the caller's buffers, each thread
    // on its own rows: after a trigger or a breakdown, x_k, r_k and p_k
    // as the stage left them; else the pending update.
    const float* rcur = rbuf(cr);
    const float* pold = pbuf(cp);
    const bool stopped = trig != 0 || err != 0;
    const float* pk_at = stopped && pend ? pbuf(cp ^ 1) : pold;
    for (int r = lo0 + t4; r < hi0; r += kTile) {
      if (stopped || !pend) {
        if (cr) st4(a.r + r, ld4cg(rcur + r));
        if (pk_at != a.p) st4(a.p + r, ld4cg(pk_at + r));
        continue;
      }
      const float4 rv = ld4cg(rcur + r), pv = ld4cg(pold + r);
      const float4 xv = ld4cg(a.x + r);
      float4 mv = rv;
      if constexpr (kPrecond) mv = ld4(o.minv + r);
      const float4 pn = make_float4(next_p(rv.x, pv.x, mv.x, beta_p),
                                    next_p(rv.y, pv.y, mv.y, beta_p),
                                    next_p(rv.z, pv.z, mv.z, beta_p),
                                    next_p(rv.w, pv.w, mv.w, beta_p));
      const float4 xn = make_float4(
          __fadd_rn(xv.x, __fmul_rn(alpha_p, pv.x)),
          __fadd_rn(xv.y, __fmul_rn(alpha_p, pv.y)),
          __fadd_rn(xv.z, __fmul_rn(alpha_p, pv.z)),
          __fadd_rn(xv.w, __fmul_rn(alpha_p, pv.w)));
      st4(a.x + r, xn);
      st4(a.r + r, rv);
      st4(a.p + r, pn);
      if constexpr (kLazy) {
        if (chk_p) {
          st4(o.xs + r, xn);
          st4(o.rs + r, rv);
          st4(o.ps + r, pn);
        }
      }
    }
  }
  if constexpr (kLazy) {
    // A clean exit mid-window: one signals-only pass closes the window
    // (fused.py:1101-1155); a trigger here rolls the caller back.
    if (its != itr && trig == 0 && err == 0) {
      int bad = 0;
      if (a.sig.plane != nullptr) {
        for (int lo = lo0; lo < hi0; lo += kTile) {
          const int r = lo + t4;
          const int hi = min(lo + kTile, hi0);
          uint32_t acc = 0, acc2 = 0;
          if (r < hi) {
            for (int d = 0; d < offs.n; ++d) {
              const uint4 u = __ldg(reinterpret_cast<const uint4*>(
                  a.sig.plane + (size_t)d * R + r));
              uint4 pu = u;
              if constexpr (kPlanes == 2) {
                const uint4 u2 = __ldg(reinterpret_cast<const uint4*>(
                    a.sig.plane2 + (size_t)d * R + r));
                acc2 ^= u2.x ^ u2.y ^ u2.z ^ u2.w;
                pu = make_uint4(u.x ^ u2.x, u.y ^ u2.y, u.z ^ u2.z,
                                u.w ^ u2.w);
              }
              if (a.sig.use_parity)
                bad |= (__popc(pu.x) | __popc(pu.y) | __popc(pu.z) |
                        __popc(pu.w)) &
                       1;
              acc ^= u.x ^ u.y ^ u.z ^ u.w;
            }
          }
          if (a.sig.use_cksum) {
            acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
            if (r < hi && (threadIdx.x & 1) == 0 &&
                acc != __ldg(a.sig.base + (r >> 3)))
              bad = 1;
            if constexpr (kPlanes == 2) {
              acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 1);
              if (r < hi && (threadIdx.x & 1) == 0 &&
                  acc2 != __ldg(a.sig.base2 + (r >> 3)))
                bad = 1;
            }
          }
        }
      }
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

template <bool kFold, bool kPrecond, bool kLazy, int kPlanes>
__global__ void __launch_bounds__(kBlock, kRowBlocksPerSM)
fused_cg_dia_rows(FusedArgs a, DiaOffsets offs, CgOpts o) {
  row_loop<kFold, false, kPrecond, kLazy, kPlanes>(a, offs, nullptr, o);
}

template <bool kPrecond, bool kLazy, int kPlanes>
__global__ void __launch_bounds__(kBlock, kRowBlocksPerSM)
fused_cg_dia_window(FusedArgs a, DiaOffsets offs, WindowPlan wp, CgOpts o) {
  row_loop<false, true, kPrecond, kLazy, kPlanes>(a, offs, &wp, o);
}

template <bool kPrecond, int kPlanes>
__global__ void __launch_bounds__(kBlock)
fused_cg_dia_tail_kernel(FusedArgs a, DiaOffsets offs, TailPlan tp,
                         CgOpts o) {
  tail_loop<kPrecond, false, kPlanes>(a, offs, tp, o);
}

template <bool kPrecond, int kPlanes>
__global__ void __launch_bounds__(kBlock, kLazyBlocksPerSM)
fused_cg_dia_tail_lazy_kernel(FusedArgs a, DiaOffsets offs, TailPlan tp,
                              CgOpts o) {
  tail_loop<kPrecond, true, kPlanes>(a, offs, tp, o);
}

// The tail-free schedules, as the C interface numbers them.
enum Schedule { kThreeSync = 0, kFoldSched = 1, kWindowSched = 2 };

template <int kPlanes>
const void* instance_of(bool tail, bool precond, bool lazy, int sched) {
  if (tail) {
    const void* fns[4] = {
        (const void*)fused_cg_dia_tail_kernel<false, kPlanes>,
        (const void*)fused_cg_dia_tail_kernel<true, kPlanes>,
        (const void*)fused_cg_dia_tail_lazy_kernel<false, kPlanes>,
        (const void*)fused_cg_dia_tail_lazy_kernel<true, kPlanes>};
    return fns[(precond ? 1 : 0) + (lazy ? 2 : 0)];
  }
  if (sched == kWindowSched) {
    const void* fns[4] = {
        (const void*)fused_cg_dia_window<false, false, kPlanes>,
        (const void*)fused_cg_dia_window<true, false, kPlanes>,
        (const void*)fused_cg_dia_window<false, true, kPlanes>,
        (const void*)fused_cg_dia_window<true, true, kPlanes>};
    return fns[(precond ? 1 : 0) + (lazy ? 2 : 0)];
  }
  const void* fns[8] = {
      (const void*)fused_cg_dia_rows<false, false, false, kPlanes>,
      (const void*)fused_cg_dia_rows<true, false, false, kPlanes>,
      (const void*)fused_cg_dia_rows<false, true, false, kPlanes>,
      (const void*)fused_cg_dia_rows<true, true, false, kPlanes>,
      (const void*)fused_cg_dia_rows<false, false, true, kPlanes>,
      (const void*)fused_cg_dia_rows<true, false, true, kPlanes>,
      (const void*)fused_cg_dia_rows<false, true, true, kPlanes>,
      (const void*)fused_cg_dia_rows<true, true, true, kPlanes>};
  return fns[(sched == kFoldSched ? 1 : 0) + (precond ? 2 : 0) +
             (lazy ? 4 : 0)];
}

// The instance of (tail, Jacobi, lazy, schedule, signal planes).  The
// split-tail instances have one schedule.
const void* instance(bool tail, bool precond, bool lazy, int sched,
                     int planes) {
  return planes == 2 ? instance_of<2>(tail, precond, lazy, sched)
                     : instance_of<1>(tail, precond, lazy, sched);
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15u) == 0; }

// The window plan of the C interface's ``windows`` (n, then start[n],
// ext[n] and the window of each of the D diagonals), checked: every
// window starts and ends on a multiple of 4 rows and holds every row its
// diagonals read, and the two sets fit kWindowSmem.
bool make_window_plan(WindowPlan* wp, const int* windows, const int* offsets,
                      int D) {
  if (windows == nullptr) return false;
  const int n = windows[0];
  if (n < 1 || n > kMaxWindows) return false;
  wp->n = n;
  int at = 0;
  for (int c = 0; c < n; ++c) {
    const int start = windows[1 + c], ext = windows[1 + n + c];
    if (start % 4 != 0 || ext % 4 != 0 || ext < 0 || ext > kWindowSmem)
      return false;
    wp->start[c] = start;
    wp->ext[c] = ext;
    wp->at[c] = at;
    at += kTile + ext;
  }
  wp->set = at;
  if (2LL * 4 * at > kWindowSmem) return false;
  for (int d = 0; d < D; ++d) {
    const int c = windows[1 + 2 * n + d];
    if (c < 0 || c >= n) return false;
    // rows lo + 4t .. + 3 + off of a tile [lo, hi) lie in [lo + start,
    // hi + start + ext) for every 4t < hi - lo
    const int k = offsets[d] - wp->start[c];
    if (k < 0 || k > wp->ext[c]) return false;
    wp->shift[d] = wp->at[c] + k;
  }
  return true;
}

// Lets a window instance take kWindowSmem of dynamic shared memory (with
// its static arrays, past the 48 KB default).  The carveout is left to
// the driver, which sizes it to each launch's windows: the SM's whole
// carveout for every launch left too little L1 and was ~1% slower on
// HPCG's stencil (PERF.md §6).
cudaError_t allow_window_smem(const void* fn) {
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowSmem);
}

}  // namespace

// Largest co-resident grid for the cooperative launch on ``device`` of
// the instance (``tail``, ``precond``, ``lazy``) streaming ``planes``
// signal planes (1, or 2: constraints mode on COO128).  A split-tail instance
// gets SMs x its own resident blocks per SM (the tail live instance fits
// 6, the lazy ones 8, launched on the live grid).  Every tail-free
// instance, any schedule, gets SMs x kRowBlocksPerSM, which its launch
// bounds guarantee (the query checks it, the window instance at
// kWindowSmem): one partition of the rows for all of them.  Returns a
// cudaError_t.
extern "C" int abft_fused_grid(int device, int tail, int precond, int lazy,
                               int planes, int* grid) {
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
  int per_sm = tail ? 1 << 30 : kRowBlocksPerSM;
  for (int sched = 0; sched < (tail ? 1 : 3); ++sched) {
    const void* fn = instance(tail, precond, lazy, sched, planes);
    const int smem = sched == kWindowSched ? kWindowSmem : 0;
    int n = 0;
    if (sched == kWindowSched) err = allow_window_smem(fn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock,
                                                          smem);
    if (err != cudaSuccess) return (int)err;
    per_sm = n < per_sm ? n : per_sm;
  }
  *grid = sms * per_sm;
  if (!tail && per_sm < kRowBlocksPerSM)
    return (int)cudaErrorLaunchOutOfResources;
  return *grid > 0 ? (int)cudaSuccess : (int)cudaErrorLaunchOutOfResources;
}

// ``plane2``, ``tplane2``: the second signal planes of the main part and
// the tail (constraints mode on COO128: the row word), null but with a
// first plane; they select the two-plane instances.  ``sched``: the
// tail-free schedule (0 three-sync, 1 fold, 2 window; ignored with a
// tail); ``r2``, ``p2``: the fold's second r and p buffers (R floats,
// 16-byte aligned); ``windows``: the window schedule's plan
// (make_window_plan), else null; ``nb``: the tail-free rows per block (a
// multiple of 8, nb x grid >= R).
extern "C" int abft_fused_cg_dia(
    const float* vals, const int* offsets, int D, int R, float* x, float* r,
    float* p, float* w, const uint32_t* plane, const uint32_t* base,
    const uint32_t* plane2, const uint32_t* base2, int use_parity,
    int use_cksum, float* part_pw, float* part_rr, int* part_flag, int grid,
    const int* iscal_in, const float* fscal_in, int* iscal_out,
    float* fscal_out, float* trace, int trace_len, float conv,
    const float* td, const float* tb, const int* trows, const int* tstarts,
    const unsigned long long* ttiles, int T, int S, int tchunk, float* tpart,
    float* tmain, const uint32_t* tplane, const uint32_t* tbase,
    const uint32_t* tplane2, const uint32_t* tbase2, int E,
    const float* minv, float* part_rz,
    float* xs, float* rs, float* ps, int ci, int* snap_iout,
    float* snap_fout, int sched, float* r2, float* p2, const int* windows,
    int nb, int device, void* stream) {
  const bool precond = minv != nullptr, lazy = ci > 1, tail = T > 0;
  const int planes = plane2 != nullptr ? 2 : 1;
  if (D < 1 || D > ABFT_MAX_D || R % 32 != 0 || grid < 1 || ci < 1 ||
      (plane2 != nullptr && (plane == nullptr || base2 == nullptr)) ||
      (tail && tplane != nullptr && (tplane2 != nullptr) != (planes == 2)) ||
      (precond && part_rz == nullptr) ||
      (lazy && (xs == nullptr || rs == nullptr || ps == nullptr ||
                snap_iout == nullptr || snap_fout == nullptr)))
    return (int)cudaErrorInvalidValue;
  TailPlan t;
  if (!make_tail_plan(&t, td, tb, trows, tstarts, ttiles, T, S, tchunk,
                      tpart, tmain, tplane, tbase, tplane2, tbase2, use_parity,
                      use_cksum, E, p))
    return (int)cudaErrorInvalidValue;
  int halo = 0;
  for (int d = 0; d < D; ++d) {
    const int h = offsets[d] < 0 ? -offsets[d] : offsets[d];
    halo = h > halo ? h : halo;
  }
  if (tail) sched = kThreeSync;
  if (sched < kThreeSync || sched > kWindowSched)
    return (int)cudaErrorInvalidValue;
  const bool fold = sched == kFoldSched;
  WindowPlan wp;
  if (!tail) {
    // the 16-byte loads, the partition, the fold's buffers and its halo,
    // the windows
    const void* vecs[] = {vals, x,  r,  p,  w,  plane, plane2,
                          minv, xs, rs, ps, r2, p2};
    for (const void* v : vecs)
      if (!aligned16(v)) return (int)cudaErrorInvalidValue;
    if (nb < 8 || nb % 8 != 0 || (long long)nb * grid < R ||
        (fold && (r2 == nullptr || p2 == nullptr || halo > kFoldHalo)) ||
        (sched == kWindowSched &&
         !make_window_plan(&wp, windows, offsets, D)))
      return (int)cudaErrorInvalidValue;
  }
  // (the launch itself refuses a grid past the co-resident one; the
  // caller's comes from abft_fused_grid, queried once per device)
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  DiaOffsets offs;
  offs.n = D;
  for (int d = 0; d < D; ++d) offs.off[d] = offsets[d];
  FusedArgs a;
  a.vals = vals;
  a.R = R;
  a.x = x;
  a.r = r;
  a.p = p;
  a.w = w;
  a.r2 = r2;
  a.p2 = p2;
  a.nb = nb;
  a.halo = halo;
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
  void* tail_args[] = {&a, &offs, &t, &o};
  void* row_args[] = {&a, &offs, &o};
  void* window_args[] = {&a, &offs, &wp, &o};
  const bool window = sched == kWindowSched;
  err = cudaLaunchCooperativeKernel(
      instance(tail, precond, lazy, sched, planes), dim3(grid), dim3(kBlock),
      tail ? tail_args : window ? window_args : row_args,
      window ? 2 * 4 * wp.set : 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
