// Asynchronous global -> shared copies (cp.async, sm_80 and later) for
// kernel C's staged planes (ell_spmv_detect.cu).
//
// A copy is issued by one thread and lands in shared memory without
// passing through its registers, so a block keeps many loads in flight at
// the register count of one.  Copies are grouped: ``cp_commit`` closes the
// thread's current group, ``cp_wait<N>`` waits until at most N of the
// thread's groups are still in flight.  Another thread's copies are seen
// only after that thread's wait and a __syncthreads().
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; cached in L2 only (.cg): the
// streamed planes are read once and must not evict the gathered x from L1.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
