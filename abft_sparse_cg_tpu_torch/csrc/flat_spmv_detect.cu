// Kernel E: flat_spmv_detect — one SpMV over the flat (unstructured)
// layout with the live ABFT signals.
//
// Replaces the TPU kernel abft_sparse_cg_tpu/ops/spmv_unstructured.py::
// _make_kernel (kernel body :416, pallas_call at :447, with _benes_body
// :378), variant detect=True: the w of a flat matrix, plus pw = x . w and
// the mode's trigger.  With no plane it is the detection-free product of
// the lazy schedule.  The flat planes hold the entries sorted by output
// row, then gather index (formats/protected.py, exec_kind "flat"), padded
// to E, a multiple of 8, with zero codewords.  w[r] = sum over slots j in
// [row_ptr[r], row_ptr[r+1]) of vals[j] * x[g(j)], g the col word (ECC
// byte masked in the ECC modes) or the RCM gidx plane, clamped by the jnp
// gather's rule (ell_gather in dia_common.cuh).  The signals are those of
// kernels A and C over the one streamed (E,) plane — the rotated fold in
// the ECC modes, the col word in constraints mode: parity of every slot,
// and the XOR of every exact 8-slot block against its encode-time value
// (ops/spmv.py::_fold_blocks on a 1-D plane).  Constraints mode on
// COO128 streams two planes, the col and the row word (the kPlanes = 2
// instance): the second plane's 8-slot XORs close in registers against
// its own baseline, parity is over the XOR of the two words.
//
// What it is not: the TPU kernel scans x in column order and routes the
// products through two Benes networks because a TPU cannot gather; a GPU
// can, so this is a CSR row gather over the exec-sorted planes.
//
// What bounds it on the H100: bytes.  Per valid slot a value (f32) and a
// gather word (u32), plus a signal word (u32) over all E slots in the
// detecting modes — 8 or 12 B against 2 flops — plus x, w and the row
// pointer (12 B per row).  At powerlaw-graph -b 10 (R = 655,360, 3.2M
// entries) that is ~47 MB in secded, about the size of the 50 MB L2.
// What held the first design (one warp per row, rows in a grid-stride
// loop) far from that: rows of 2-42 slots left most of a warp's lanes
// idle, each row was a chain of dependent loads (row pointer, gather
// word, x) walked ~78 times per warp, and a hub row of 10,875 slots took
// one warp 340 trips.
//
// What the design does about it: a nonzero-balanced row gather in the
// style of CSR-Adaptive (Greathouse & Daga, SC'14).  A plan derived once
// at upload (ops/spmv.py::flat_row_blocks) gives each block either a run
// of consecutive rows whose slots fit one shared-memory tile of kTile
// slots (at most kRunRows rows), or one tile-sized chunk of a long row
// (more than kTile slots); the chunks come first in the plan.  Every
// thread of a block issues its loads together — the tile's values and
// gather words (coalesced), the run's row pointer and x entries, the
// block's signal words and baselines — then the x gathers, and stores
// each product, rounded once, as 0 + v * x in shared memory: two round
// trips to memory per block.  Each row is then summed from shared memory
// in the order of the first design (lane l of 32 sums slots l, l + 32,
// ... in turn, the 32 lane sums combine in the XOR butterfly 16, 8, 4,
// 2, 1), so w is bit-identical to it and to ops/spmv.py::flat_product:
//   - a row of n <= 32 slots is one thread's: its lane sums are the n
//     products and 32 - n zeros, and the butterfly's lane 0 is a tree
//     over them (row_tree); offsets at or above the warp's largest
//     short row only add +0.0 to sums that are never -0.0, so the tree
//     runs the offsets below it alone (a sub-warp butterfly);
//   - a row of 32 < n <= kTile slots in a run is one warp's, lane sums
//     from shared memory, then warp_butterfly;
//   - a long row's chunks load in parallel, one block each; warp 0 of
//     each takes the row's 32 running lane sums from the block before
//     it, adds its chunk (a multiple of 32 slots, so lane l stays on
//     slots l mod 32) and hands them on; the last one runs the
//     butterfly.  Only that chain of 64 adds per lane is serial.
// The signals cover [ceil8(s0), ceil8(s1)) of each block's slots [s0,
// s1): the blocks partition the (E,) plane, E = ceil8(nnz), and each
// block's 8-slot groups are whole.  The call is one launch: block 0
// waits for the other blocks' pw partials and flags, sums them in a fixed
// order and writes pw and the trigger (finish_call, dia_common.cuh).  x
// goes through the read-only path (__ldg): nothing writes it during the
// call.
//
// Interface: plain C, called through ctypes (abft_sparse_cg_tpu_torch/
// _build.py).  Launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch.

#include "dia_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 2048;      // ops/spmv.py FLAT_TILE
constexpr int kRunRows = 1024;   // ops/spmv.py FLAT_RUN_ROWS
constexpr int kPer = kTile / kBlock;
constexpr int kRowPer = kRunRows / kBlock;
// A block's signal slots are [ceil8(s0), ceil8(s1)): at most kTile (a
// multiple of 8 no larger than s1 - s0 + 7), in kTile / 8 = kBlock
// checksum groups.
constexpr int kGroups = kTile / 8;
static_assert(kTile % kBlock == 0 && kTile % 32 == 0, "tile shape");
static_assert(kGroups == kBlock, "one checksum group per thread");

__device__ unsigned int g_arrive;   // finish_call's counter

struct FlatMatrix {
  const float* vals;      // (E,)
  const uint32_t* gsrc;   // (E,) gather word or gidx
  uint32_t gmask;
  const int* row_ptr;     // (R + 1,)
  int R;
};

__device__ __forceinline__ int ceil8(int s) { return (s + 7) & ~7; }

// tile[j] = 0 + vals[s + j] * x[g(s + j)] for j < n <= kTile: every
// value, gather-word and x load of a thread is issued before its first
// multiply.  ``between`` runs after the x gathers are issued and before
// they are waited for.
template <typename F>
__device__ __forceinline__ void load_products(float* tile,
                                              const FlatMatrix& m,
                                              const float* __restrict__ x,
                                              int s, int n, F between) {
  float v[kPer], xv[kPer];
  int g[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kBlock;
    g[k] = 0;
    v[k] = 0.0f;
    if (j < n) {
      v[k] = __ldg(m.vals + s + j);
      g[k] = ell_gather(__ldg(m.gsrc + s + j), m.gmask, m.R);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    xv[k] = threadIdx.x + k * kBlock < n ? __ldg(x + g[k]) : 0.0f;
  between();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kBlock;
    if (j < n) tile[j] = __fadd_rn(0.0f, __fmul_rn(v[k], xv[k]));
  }
}

// Lane 0 of the butterfly over G lane sums t[0..n) (zeros beyond n),
// n <= G <= 32: at offset o, L[i] += L[i + o] for i < o.  Each level is
// its own instance, so every index is a constant and L stays in
// registers.
template <int O>
__device__ __forceinline__ void tree_levels(float* L) {
#pragma unroll
  for (int i = 0; i < O; ++i) L[i] = __fadd_rn(L[i], L[i + O]);
  if constexpr (O > 1) tree_levels<O / 2>(L);
}

template <int G>
__device__ __forceinline__ float row_tree(const float* t, int n) {
  float L[G];
#pragma unroll
  for (int i = 0; i < G; ++i) L[i] = i < n ? t[i] : 0.0f;
  if constexpr (G > 1) tree_levels<G / 2>(L);
  return L[0];
}

// Lane sums of n slots of the tile from ``v`` on: lane adds slots lane,
// lane + 32, ... in turn, eight loads ahead of its adds.
__device__ __forceinline__ float lane_sum(const float* tile, int n,
                                          int lane, float v) {
  int j = lane;
  for (; j + 7 * 32 < n; j += 8 * 32) {
    float t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = tile[j + k * 32];
#pragma unroll
    for (int k = 0; k < 8; ++k) v = __fadd_rn(v, t[k]);
  }
  for (; j < n; j += 32) v = __fadd_rn(v, tile[j]);
  return v;
}

struct Shared {
  float tile[kTile];          // products
  int ptr[kRunRows + 1];      // a run's row pointer, less s0
  float x[kRunRows];          // a run's x entries
  uint32_t base[kGroups];     // the signal groups' baselines
  uint32_t acc[kGroups];      // and their XORs
};

// The loads of one block: the products of slots [s0, s1) into the tile,
// the row pointer and x entries of its ``nrows`` rows from r0 (none for
// a chunk), and the signals of [ceil8(s0), ceil8(s1)) — the blocks
// partition [0, E), E = ceil8(nnz).  Everything is issued beside the
// values and gather words, so a block waits for two round trips (those
// loads, then the x gathers).  Returns the signals' flag; ends with the
// block synchronised.
template <int kPlanes>
__device__ __forceinline__ int load_block(Shared& sh, const FlatMatrix& m,
                                          const float* __restrict__ x,
                                          const DiaSignals& sig, int r0,
                                          int nrows, int s0, int s1) {
  const int q0 = ceil8(s0), q1 = ceil8(s1);
  const bool signals = sig.plane != nullptr;
  int rp[kRowPer + 1];
  float xr[kRowPer];
  uint32_t sw[kPer], sw2[kPlanes == 2 ? kPer : 1];
#pragma unroll
  for (int k = 0; k <= kRowPer; ++k) {
    const int i = threadIdx.x + k * kBlock;
    rp[k] = i <= nrows && nrows ? __ldg(m.row_ptr + r0 + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < kRowPer; ++k) {
    const int i = threadIdx.x + k * kBlock;
    xr[k] = i < nrows ? __ldg(x + r0 + i) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = q0 + threadIdx.x + k * kBlock;
    sw[k] = signals && j < q1 ? __ldg(sig.plane + j) : 0u;
    if constexpr (kPlanes == 2)
      sw2[k] = signals && j < q1 ? __ldg(sig.plane2 + j) : 0u;
  }
  const int ngroups = (q1 - q0) / 8;
  const uint32_t sb = signals && sig.use_cksum && threadIdx.x < ngroups
                          ? __ldg(sig.base + q0 / 8 + threadIdx.x) : 0u;
  int odd = 0;
  load_products(sh.tile, m, x, s0, s1 - s0, [&] {
    // Parity, and each 8-slot group's XOR into shared memory, while the
    // x gathers are in flight.
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if constexpr (kPlanes == 2) {
        if (sig.use_parity) odd |= __popc(sw[k] ^ sw2[k]) & 1;
        uint32_t acc2 = sw2[k];
        acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 1);
        acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 2);
        acc2 ^= __shfl_xor_sync(ABFT_FULL_MASK, acc2, 4);
        const int g = (threadIdx.x + k * kBlock) >> 3;
        if (signals && sig.use_cksum && (threadIdx.x & 7) == 0 &&
            g < ngroups && acc2 != __ldg(sig.base2 + q0 / 8 + g))
          odd = 1;
      } else if (sig.use_parity) {
        odd |= __popc(sw[k]) & 1;
      }
      uint32_t acc = sw[k];
      acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 1);
      acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 2);
      acc ^= __shfl_xor_sync(ABFT_FULL_MASK, acc, 4);
      const int j = threadIdx.x + k * kBlock;
      if ((j & 7) == 0) sh.acc[j >> 3] = acc;
    }
#pragma unroll
    for (int k = 0; k <= kRowPer; ++k) {
      const int i = threadIdx.x + k * kBlock;
      if (i <= nrows) sh.ptr[i] = rp[k] - s0;
      if (k < kRowPer && i < nrows) sh.x[i] = xr[k];
    }
    sh.base[threadIdx.x] = sb;
  });
  __syncthreads();
  if (signals && sig.use_cksum && threadIdx.x < ngroups &&
      sh.acc[threadIdx.x] != sh.base[threadIdx.x])
    odd = 1;
  return odd;
}

// A run's rows [r0, r0 + nrows): warp k takes the rows r0 + 32 c + lane
// for c = k, k + 8, ..., summed from shared memory alone.
__device__ __forceinline__ float run_rows(const Shared& sh, int r0,
                                          int nrows, float* __restrict__ w) {
  const int lane = threadIdx.x & 31;
  float pw = 0.0f;
  for (int c = threadIdx.x >> 5; c * 32 < nrows; c += kBlock / 32) {
    const int i = c * 32 + lane;
    int s = 0, n = 0;
    if (i < nrows) {
      s = sh.ptr[i];
      n = sh.ptr[i + 1] - s;
    }
    const int ns = n <= 32 ? n : 0;
    const int top = __reduce_max_sync(ABFT_FULL_MASK, ns);
    const float* t = sh.tile + s;
    float v;
    if (top <= 1)       v = row_tree<1>(t, ns);
    else if (top <= 2)  v = row_tree<2>(t, ns);
    else if (top <= 4)  v = row_tree<4>(t, ns);
    else if (top <= 8)  v = row_tree<8>(t, ns);
    else if (top <= 16) v = row_tree<16>(t, ns);
    else                v = row_tree<32>(t, ns);
    unsigned wide = __ballot_sync(ABFT_FULL_MASK, n > 32);
    while (wide) {
      const int src = __ffs(wide) - 1;
      wide &= wide - 1;
      const int ws = __shfl_sync(ABFT_FULL_MASK, s, src);
      const int wn = __shfl_sync(ABFT_FULL_MASK, n, src);
      const float u = warp_butterfly(lane_sum(sh.tile + ws, wn, lane, 0.0f));
      if (lane == src) v = u;
    }
    if (i < nrows) {
      w[r0 + i] = v;
      pw = __fadd_rn(pw, __fmul_rn(sh.x[i], v));
    }
  }
  return pw;
}

// One chunk [s0, s1) of long row r, its products already in the tile.
// Warp 0 takes the row's 32 running lane sums from the previous chunk's
// block (the one before it in the plan: waiting for it cannot deadlock,
// it was dispatched first and waits on nothing later), adds this
// chunk's slots, and hands the sums on; the last chunk's block runs the
// butterfly.  ``sync`` holds one flag per block, zero between calls:
// each consumer clears the flag it waited for.
__device__ __forceinline__ float chain_chunk(const Shared& sh, int r,
                                             int first, int last, int n,
                                             float* __restrict__ carry,
                                             unsigned int* sync,
                                             const float* __restrict__ x,
                                             float* __restrict__ w) {
  if (threadIdx.x >= 32) return 0.0f;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  float v = 0.0f;
  if (!first) {
    while (load_acquire(sync + b - 1) == 0) __nanosleep(32);
    v = __ldcg(carry + (size_t)(b - 1) * 32 + lane);
    __syncwarp();
    if (lane == 0) sync[b - 1] = 0;
  }
  v = lane_sum(sh.tile, n, lane, v);
  if (!last) {
    __stcg(carry + (size_t)b * 32 + lane, v);
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(sync + b, 1u);
    return 0.0f;
  }
  v = warp_butterfly(v);
  if (lane) return 0.0f;
  w[r] = v;
  return __fmul_rn(__ldg(x + r), v);
}

template <int kPlanes>
__global__ void __launch_bounds__(kBlock)
flat_spmv_detect_kernel(FlatMatrix m, const int4* __restrict__ plan,
                        float* __restrict__ carry, unsigned int* sync,
                        const float* __restrict__ x, float* __restrict__ w,
                        DiaSignals sig, CallOut out) {
  __shared__ Shared sh;
  __shared__ float fbuf[33];
  __shared__ int ibuf[33];
  // A run (r0, r1, s0, s1), or a chunk of long row r: (r, -1 - (first |
  // last << 1), s0, s1).
  const int4 blk = __ldg(plan + blockIdx.x);
  const bool chunk = blk.y < 0;
  const int nrows = chunk ? 0 : blk.y - blk.x;
  const int bad =
      load_block<kPlanes>(sh, m, x, sig, blk.x, nrows, blk.z, blk.w);
  float pw;
  if (chunk) {
    const int f = -1 - blk.y;
    pw = chain_chunk(sh, blk.x, f & 1, f & 2, blk.w - blk.z, carry, sync,
                     x, w);
  } else {
    pw = run_rows(sh, blk.x, nrows, w);
  }
  finish_call(pw, bad, out, &g_arrive, fbuf, ibuf);
}

}  // namespace

extern "C" int abft_flat_spmv_tile(void) { return kTile; }
extern "C" int abft_flat_spmv_run_rows(void) { return kRunRows; }

// ``plan``: (nblocks, 4) row blocks from ops/spmv.py::flat_row_blocks
// (16-byte aligned); ``carry`` holds 32 * nblocks floats (scratch),
// ``sync`` nblocks flags that are zero (MatrixDevice.flat_sync), ``part``
// and ``flags`` nblocks entries (scratch); ``plane2`` (the row word of
// constraints mode on COO128) is null but with a first plane.
extern "C" int abft_flat_spmv_detect(const float* vals, const uint32_t* gsrc,
                                     unsigned gmask, const int* row_ptr,
                                     const int* plan, int nblocks,
                                     float* carry, unsigned* sync, int R,
                                     const float* x, float* w,
                                     const uint32_t* plane,
                                     const uint32_t* base,
                                     const uint32_t* plane2,
                                     const uint32_t* base2, int use_parity,
                                     int use_cksum, float* part, int* flags,
                                     float* pw, unsigned char* trig,
                                     int device, void* stream) {
  if (R < 1 || R % 32 != 0 || nblocks < 1 ||
      (plane2 != nullptr && (plane == nullptr || base2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  DeviceScope on(device);
  cudaError_t err = on.err;
  if (err != cudaSuccess) return (int)err;
  FlatMatrix m{vals, gsrc, gmask, row_ptr, R};
  DiaSignals sig{plane, base, use_parity, use_cksum, plane2, base2};
  CallOut out{part, flags, pw, trig};
  const int4* p4 = reinterpret_cast<const int4*>(plan);
  if (plane2 != nullptr)
    flat_spmv_detect_kernel<2><<<nblocks, kBlock, 0, (cudaStream_t)stream>>>(
        m, p4, carry, sync, x, w, sig, out);
  else
    flat_spmv_detect_kernel<1><<<nblocks, kBlock, 0, (cudaStream_t)stream>>>(
        m, p4, carry, sync, x, w, sig, out);
  return (int)cudaGetLastError();
}
