// Helpers shared by the port's kernels: asynchronous global -> shared copies
// (cp.async, sm_80 and later), programmatic dependent launch (sm_90) and the
// one-time shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nps {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes < 16 fills the rest of dst with zeros (src must
// still be a valid, 16-byte aligned address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8-byte copy with the same zero fill (dst and src 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes = 8) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte copy with the same zero fill.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel on the stream
// be launched once every CTA of this one has got here, and, in a kernel
// launched that way, wait until the previous kernel has finished and its
// writes are visible. Without the launch attribute the wait returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let `kernel` use all the dynamic shared memory a block may opt in to.
// Called once per process and kernel (the attribute persists).
template <typename K>
cudaError_t allow_max_smem(K* kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
  return err;
}

}  // namespace nps
