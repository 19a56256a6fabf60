// Hopper's bulk copies (the Tensor Memory Accelerator without a tensor
// map) and the shared-memory barriers that report their completion
// (fused_norm_bwd.cu). One thread asks for a contiguous run of bytes to be
// copied from device memory into shared memory; the copy engine moves it
// and counts its bytes off an mbarrier, which the consumers wait on by
// phase parity. Sizes and addresses are multiples of 16 bytes.

#pragma once

#include <stdint.h>

namespace bulk_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier that completes a phase on one arrival and the
// bytes it was told to expect.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// After the barriers are initialised, before any copy or wait uses them.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The arrival of this phase, expecting `bytes` from the copies that follow.
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copies `bytes` from src (device memory) to dst (shared memory); their
// completion counts off `bar`.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier reads of shared memory before the copy
// engine's later writes there.
__device__ __forceinline__ void fence_reuse() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

}  // namespace bulk_copy
