// Kernel D: fused_cg_ell — the whole detect-fast CG loop over a
// banded-ELL matrix in one kernel.
//
// Replaces the ELL branch of the TPU kernel abft_sparse_cg_tpu/solver/
// fused.py::_make_kernel (is_ell at :494, the window gather of p at
// :819-860, pallas_call at :1248; the plan at :183-216).  It is kernel B
// (fused_cg_dia.cu) with the banded-ELL row product of kernel C in place
// of the stencil: the same contract, exit states (convergence, upto, a
// trigger, a breakdown), rr trace and in-place update of x, r, p, and the
// same re-execution of a triggered iteration by the caller after a
// repair (solver/fused.py).  One iteration:
//   1. w = A p over the (K, R) planes, pw = p . w, and the signals
//      in the same pass over the slots (ell_row_signals);
//   2. grid sync; every block reduces the pw partials and the flags in
//      the same fixed order; a trigger exits before any update;
//   3. alpha = rz / pw, r1 = r - alpha w (in the w buffer), rr1 partials;
//      grid sync; reduce rr1; pw <= 0 or a non-finite rr1 exits with
//      err = 7 (ERR_BREAKDOWN) before any update;
//   4. x += alpha p, r = r1, p = r1 + (rr1 / rz) p, trace[itr] = rr1;
//      grid sync (the next product gathers p at arbitrary rows).
// A bordered split whose main part is banded ELL runs the instances with
// kernel B's split tail (kTail; dia_common.cuh TailPlan, fused_cg_dia.cu:
// the AXPY terms beside each row's product in step 1, the outlier rows
// finished after its sync, no grid sync of its own), and the Jacobi and
// lazy instances are kernel B's (dia_common.cuh CgOpts).  Constraints
// mode on COO128 streams two signal planes, the col and the row word, each
// against its own baseline: the kPlanes = 2 instances of the signal
// helpers (ell_row_signals, dia_row_signals, tail_signals).
//
// What bounds it on the H100: bytes per iteration — the plane streams (K
// values + K gather words + K signal words per row in the detecting
// modes) plus ~9 floats of CG vectors per row and the gathered p.  At
// dense-radius-3d -b 10 that is 426 MB per iteration in secded (272 MB
// in mode none), far past the 50 MB L2: HBM-bound.  Measured by
// chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W: 0.231 ms per secded
// iteration (55% of 3.35 TB/s), 0.126 ms in mode none (64%).
//
// What the design does about it: one persistent cooperative launch for
// the whole solve, every plane read once per iteration in coalesced
// slot rows (one thread per row), the signal word of each slot loaded
// in the same loop as its value and gather word (ell_row_signals; a
// separate signal pass made the secded solve much slower, PERF.md §6),
// and a kernel without the signal code for mode none.  The gather of p goes
// through L2 (__ldcg): other blocks rewrite p every iteration and L1 is
// not coherent across SMs, so the read-only path (__ldg) would read
// stale values.  The reductions are those of kernel B's split-tail
// instances (redundant per-block sums of the grid's partials, no float
// atomics: two runs print identical rr lines), and so is the uncapped
// grid (PERF.md Open question 3).  Kept as its own file rather than a
// template shared with kernel B so that kernel B's measured code stays
// as it was.
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

// The instance of (signals, tail, Jacobi, lazy, signal planes); null for
// lazy without signals (mode none has no lazy schedule).  ``planes`` 2
// (constraints mode on COO128) selects the two-plane twin of a signal
// instance.
const void* instance(bool signals, bool tail, bool precond, bool lazy,
                     int planes) {
  if (signals && planes == 2) {
    const void* fns[8] = {
        (const void*)fused_cg_ell_kernel<true, false, false, 2>,
        (const void*)fused_cg_ell_kernel<true, true, false, 2>,
        (const void*)fused_cg_ell_kernel<true, false, true, 2>,
        (const void*)fused_cg_ell_kernel<true, true, true, 2>,
        (const void*)fused_cg_ell_lazy_kernel<false, false, 2>,
        (const void*)fused_cg_ell_lazy_kernel<true, false, 2>,
        (const void*)fused_cg_ell_lazy_kernel<false, true, 2>,
        (const void*)fused_cg_ell_lazy_kernel<true, true, 2>};
    return fns[(tail ? 1 : 0) + (precond ? 2 : 0) + (lazy ? 4 : 0)];
  }
  if (lazy) {
    if (!signals) return nullptr;
    const void* fns[4] = {
        (const void*)fused_cg_ell_lazy_kernel<false, false>,
        (const void*)fused_cg_ell_lazy_kernel<true, false>,
        (const void*)fused_cg_ell_lazy_kernel<false, true>,
        (const void*)fused_cg_ell_lazy_kernel<true, true>};
    return fns[(tail ? 1 : 0) + (precond ? 2 : 0)];
  }
  const void* fns[8] = {
      (const void*)fused_cg_ell_kernel<false, false, false>,
      (const void*)fused_cg_ell_kernel<false, true, false>,
      (const void*)fused_cg_ell_kernel<false, false, true>,
      (const void*)fused_cg_ell_kernel<false, true, true>,
      (const void*)fused_cg_ell_kernel<true, false, false>,
      (const void*)fused_cg_ell_kernel<true, true, false>,
      (const void*)fused_cg_ell_kernel<true, false, true>,
      (const void*)fused_cg_ell_kernel<true, true, true>};
  return fns[(tail ? 1 : 0) + (precond ? 2 : 0) + (signals ? 4 : 0)];
}

}  // namespace

// Largest co-resident grid for the cooperative launch on ``device``:
// SMs x resident blocks per SM, for both signal instances of (``tail``,
// ``precond``) live (the signal one streaming ``planes`` planes), or for
// the lazy instance (signals only).  Returns a cudaError_t.
extern "C" int abft_fused_ell_grid(int device, int tail, int precond,
                                   int lazy, int planes, int* grid) {
  if (planes < 1 || planes > 2) return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const void* fns[] = {instance(true, tail, precond, lazy, planes),
                       instance(false, tail, precond, lazy, planes)};
  per_sm = 1 << 30;
  for (const void* fn : fns) {
    if (fn == nullptr) continue;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = min(per_sm, n);
  }
  *grid = sms * per_sm;
  return *grid > 0 ? (int)cudaSuccess : (int)cudaErrorLaunchOutOfResources;
}

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
    float* snap_fout, int device, void* stream) {
  const bool precond = minv != nullptr, lazy = ci > 1;
  const int planes = plane2 != nullptr ? 2 : 1;
  if (K < 1 || K > ABFT_MAX_K || R % 32 != 0 || grid < 1 || ci < 1 ||
      (plane2 != nullptr && (plane == nullptr || base2 == nullptr)) ||
      (T > 0 && tplane != nullptr && (tplane2 != nullptr) != (planes == 2)) ||
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
  DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  int max_grid = 0;
  int rc =
      abft_fused_ell_grid(device, T > 0, precond, lazy, planes, &max_grid);
  if (rc != (int)cudaSuccess) return rc;
  if (grid > max_grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  EllPlanes m{vals, gsrc, ell_len, gmask, K};
  FusedArgs a;
  a.R = R;
  a.x = x;
  a.r = r;
  a.p = p;
  a.w = w;
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
  void* args[] = {&a, &m, &t, &o};
  cudaError_t err = cudaLaunchCooperativeKernel(
      instance(plane != nullptr, T > 0, precond, lazy, planes), dim3(grid),
      dim3(kBlock), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
