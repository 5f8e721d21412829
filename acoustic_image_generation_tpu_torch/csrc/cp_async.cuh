// 16-byte cp.async copies from global into shared memory, with zero fill,
// shared by the trunk's GEMM kernels (through sm90_gemm.cuh) and
// csrc/stft.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte cp.async through L2 only; with !valid it reads nothing and
// writes zeros (source size 0), which is how the kernels pad ragged edges.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp_async
