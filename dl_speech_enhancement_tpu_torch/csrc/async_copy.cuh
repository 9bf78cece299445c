// Hopper's asynchronous copies and the shared-memory barriers (mbarriers)
// they complete on, as rvq_assign.cu uses them: 16-byte cp.async copies that
// arrive on a barrier once landed; stores into another block of the cluster
// (st.async) that complete bytes on its barrier; and the halves of a cluster
// barrier (residual_chain.cu uses these too).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dse {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes barrier initialisation visible to the async proxy (the copy engine)
// and to the other threads once they pass a block barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies for the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One plain arrival (release: this thread's earlier shared stores are seen by
// the threads that wait on the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Waits as mbar_wait, acquiring at cluster scope what other blocks of the
// cluster stored with st_async_v2.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The address of `p` (this block's shared memory) in block `rank` of the
// cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// Stores 8 bytes into another block's shared memory (cluster addresses from
// cluster_addr), completing 8 bytes on that block's mbarrier.
__device__ __forceinline__ void st_async_v2(unsigned addr, int x, int y, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The halves of cluster.sync(): arrive (release) after this block's writes
// that peers read, wait (acquire) before reading a peer or overwriting what a
// peer reads.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes global -> shared through L2 (cp.async), and the arrival on `bar`
// that this thread's earlier cp.async copies trigger once they complete (the
// barrier counts it among the arrivals it was initialised with).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

}  // namespace dse
