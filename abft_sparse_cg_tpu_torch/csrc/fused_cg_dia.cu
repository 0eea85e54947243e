// Kernel B: fused_cg_dia — the whole detect-fast CG loop in one kernel.
//
// Replaces the DIA branch of the TPU kernel abft_sparse_cg_tpu/solver/
// fused.py::_make_kernel (pallas_call at :1248): while itr < upto and
// rr > conv, one iteration is
//   1. w = A p over the DIA planes, pw = p . w, and the live signals of
//      the streamed word plane (dia_common.cuh), as kernel A does;
//   2. grid sync; every block reduces the pw partials and the trigger
//      flags itself, in the same fixed order, so all blocks take the
//      same branch with no further sync;
//   3. a fired trigger exits WITHOUT the update (the caller classifies
//      and re-executes the iteration, solver/cg.py:458-478);
//   4. alpha = rz / pw, r1 = r - alpha w (kept in the w buffer), rr1
//      partials; grid sync; reduce rr1;
//   5. pw <= 0 or a non-finite rr1 sets err = 7 (ERR_BREAKDOWN) and
//      exits without the update;
//   6. x += alpha p, r = r1, p = r1 + (rr1 / rz) p, trace[itr] = rr1,
//      itr += 1; grid sync (the next stencil reads neighbour rows of p).
// A bordered split with a dense plan runs the instance with the split
// tail (kTail; dia_common.cuh TailPlan, solver/fused.py:977-1014): step 1
// also adds each non-outlier row's mirrored AXPY terms right after its
// stencil (its w and pw term are then final), keeps the outlier rows'
// stencil aside, sums the chunk partials of the tail's dense rows and
// folds the tail's signals; after the sync and the trigger test, every
// block finishes the outlier rows and adds their p . w to pw.  So the
// tail costs no pass and no grid sync of its own: three per iteration,
// as without it.  The tail-free instance is the code without it.  The
// Jacobi (kPrecond) and lazy --check-interval (kLazy) instances, with or
// without the tail, are the `precond` and `ci > 1` branches of the same
// TPU kernel (fused.py:552-678, 912-1155; dia_common.cuh CgOpts); the
// same instances run the `-b 100` solves that the TPU routes to
// _make_streaming_kernel (pallas_call at :1931; the H100 has no
// resident-vector envelope to leave).
// x, r and p are updated IN PLACE.  That is safe because an iteration
// that triggers or breaks down writes none of them: the caller sees
// exactly the state before that iteration.  The trace is written only
// at slots [itr_in, itr_out).
//
// What bounds it on the H100: bytes per iteration — the plane streams
// (D values + D signal words per row) plus the CG vectors (p read in the
// stencil, w written and read back, x/r/p updated: ~9 floats per row)
// — and, at small sizes, the three grid-wide barriers per iteration.
// At -b 10 (819,200 rows) the bytes of one iteration (36 MB in mode
// none, 46 MB in secded) fit in the 50 MB L2; at -b 100 (8.2M rows,
// 360-459 MB) they stream from HBM.  The split tail adds its td and tb
// planes and its signal plane (42 MB at arrowhead -b 10: 88 MB in all,
// past the L2).
//
// What the design does about it: one persistent cooperative launch for
// the whole solve (no per-iteration launch, no host round trip for the
// convergence test); every plane is read once per iteration, coalesced;
// the reductions are per-block partials summed redundantly by every
// block instead of an extra barrier and broadcast.  That is a few KB
// from L2 per block but O(grid^2) for the grid: the grid is not capped
// (SMs x occupancy, up to ~1,000 blocks), so the three reductions of an
// iteration read up to ~3 x 4 MB of L2 in all.  One more barrier with
// one more such reduction cost 2.3 us per iteration at 792 blocks
// (PERF.md §6); whether one reducing block plus a broadcast, or a
// grid capped at the SM count, is cheaper is not measured yet.
// Vector and partial loads go through L2 (__ldcg): other blocks write
// p and the partials, and L1 is not coherent across SMs.  Fixed-order
// reductions and no float atomics: two runs print identical rr lines.
//
// Interface: plain C through ctypes; launches with
// cudaLaunchCooperativeKernel on the caller's stream, allocates
// nothing, returns the cudaError_t.

#include <cooperative_groups.h>

#include "dia_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
// The lazy instances are launched with their live counterpart's grid, so
// that every reduction sums in the same order and a clean lazy solve
// equals the live one bit for bit: they must fit as many blocks per SM as
// the live instances do (8 at 256 threads, i.e. 32 registers).
constexpr int kLazyBlocksPerSM = 8;

struct FusedArgs {
  const float* vals;      // (D, R)
  int R;
  float* x;               // (R) in place
  float* r;               // (R) in place
  float* p;               // (R) in place
  float* w;               // (R) scratch: A p, then r1
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

// The loop of every instance; each __global__ below inlines it with its
// own launch bounds.
template <bool kTail, bool kPrecond, bool kLazy>
__device__ __forceinline__ void cg_loop(const FusedArgs& a,
                                        const DiaOffsets& offs,
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
    // 1. stencil + pw + signals
    float pw_l = 0.0f;
    int bad = 0;
    for (int i = tid; i < R; i += stride) {
      const float wr = dia_row<true>(a.vals, offs, R, a.p, i);
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
      if (a.sig.plane != nullptr && chk)
        bad |= dia_row_signals(a.sig, offs.n, R, i);
    }
    if constexpr (kTail) {
      tail_dense_chunk(tp, tsh, a.p, fbuf);
      if (chk) bad |= tail_signals(tp, tid, stride);
    }
    const float bpw = block_sum(pw_l, fbuf);
    const int bbad = block_any(bad, ibuf);
    if (threadIdx.x == 0) {
      a.part_pw[blockIdx.x] = bpw;
      a.part_flag[blockIdx.x] = bbad;
    }
    grid.sync();
    // 2-3. reduce; a trigger exits before any update
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
          bad |= dia_row_signals(a.sig, offs.n, R, i);
      if constexpr (kTail) bad |= tail_signals(tp, tid, stride);
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

template <bool kTail, bool kPrecond>
__global__ void __launch_bounds__(kBlock)
fused_cg_dia_kernel(FusedArgs a, DiaOffsets offs, TailPlan tp, CgOpts o) {
  cg_loop<kTail, kPrecond, false>(a, offs, tp, o);
}

template <bool kTail, bool kPrecond>
__global__ void __launch_bounds__(kBlock, kLazyBlocksPerSM)
fused_cg_dia_lazy_kernel(FusedArgs a, DiaOffsets offs, TailPlan tp,
                         CgOpts o) {
  cg_loop<kTail, kPrecond, true>(a, offs, tp, o);
}

// The instance of (tail, Jacobi, lazy).
const void* instance(bool tail, bool precond, bool lazy) {
  const void* fns[8] = {
      (const void*)fused_cg_dia_kernel<false, false>,
      (const void*)fused_cg_dia_kernel<true, false>,
      (const void*)fused_cg_dia_kernel<false, true>,
      (const void*)fused_cg_dia_kernel<true, true>,
      (const void*)fused_cg_dia_lazy_kernel<false, false>,
      (const void*)fused_cg_dia_lazy_kernel<true, false>,
      (const void*)fused_cg_dia_lazy_kernel<false, true>,
      (const void*)fused_cg_dia_lazy_kernel<true, true>};
  return fns[(tail ? 1 : 0) + (precond ? 2 : 0) + (lazy ? 4 : 0)];
}

}  // namespace

// Largest co-resident grid for the cooperative launch on ``device`` of
// the instance (``tail``, ``precond``, ``lazy``): SMs x resident blocks
// per SM.  The instances need different register counts (the tail-free
// live one fits 8 blocks per SM, the tail one 6), so each instance gets
// its own grid.  Returns a cudaError_t.
extern "C" int abft_fused_grid(int device, int tail, int precond, int lazy,
                               int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, instance(tail, precond, lazy), kBlock, 0);
  if (err != cudaSuccess) return (int)err;
  *grid = sms * per_sm;
  return *grid > 0 ? (int)cudaSuccess : (int)cudaErrorLaunchOutOfResources;
}

extern "C" int abft_fused_cg_dia(
    const float* vals, const int* offsets, int D, int R, float* x, float* r,
    float* p, float* w, const uint32_t* plane, const uint32_t* base,
    int use_parity, int use_cksum, float* part_pw, float* part_rr,
    int* part_flag, int grid, const int* iscal_in, const float* fscal_in,
    int* iscal_out, float* fscal_out, float* trace, int trace_len,
    float conv, const float* td, const float* tb, const int* trows,
    const int* tstarts, const unsigned long long* ttiles, int T, int S,
    int tchunk, float* tpart, float* tmain, const uint32_t* tplane,
    const uint32_t* tbase, int E, const float* minv, float* part_rz,
    float* xs, float* rs, float* ps, int ci, int* snap_iout,
    float* snap_fout, int device, void* stream) {
  const bool precond = minv != nullptr, lazy = ci > 1;
  if (D < 1 || D > ABFT_MAX_D || R % 32 != 0 || grid < 1 || ci < 1 ||
      (precond && part_rz == nullptr) ||
      (lazy && (xs == nullptr || rs == nullptr || ps == nullptr ||
                snap_iout == nullptr || snap_fout == nullptr)))
    return (int)cudaErrorInvalidValue;
  TailPlan t;
  if (!make_tail_plan(&t, td, tb, trows, tstarts, ttiles, T, S, tchunk,
                      tpart, tmain, tplane, tbase, use_parity, use_cksum, E,
                      p))
    return (int)cudaErrorInvalidValue;
  int max_grid = 0;
  int rc = abft_fused_grid(device, T > 0, precond, lazy, &max_grid);
  if (rc != (int)cudaSuccess) return rc;
  if (grid > max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
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
  a.sig = DiaSignals{plane, base, use_parity, use_cksum};
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
  void* args[] = {&a, &offs, &t, &o};
  cudaError_t err = cudaLaunchCooperativeKernel(
      instance(T > 0, precond, lazy), dim3(grid), dim3(kBlock), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
