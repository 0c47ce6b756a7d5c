// Helpers shared by the port's kernels: asynchronous global -> shared copies
// (cp.async, sm_80 and later; TMA and bulk copies on mbarriers, sm_90), bf16
// tensor-core products (mma.sync, ldmatrix) and the hi + lo bf16 split of f32
// values, programmatic dependent launch (sm_90), the one-time shared-memory
// opt-in, and 4-element loads and stores of f32 or bf16 as floats.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: nothing links the driver library)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nps {

// 4 consecutive elements as floats (16 bytes f32, 8 bytes bf16; aligned to
// that size)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
// 4 consecutive floats to global memory as f32 or bf16 (16 or 8 bytes,
// streaming stores; bf16 rounded to nearest)
__device__ __forceinline__ void store4(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  __stcs(reinterpret_cast<uint2*>(p), t);
}

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

// ---- bf16 tensor-core products (mma.sync m16n8k16, sm_80 and later) ----
// Fragments as in the PTX ISA, with g = lane / 4, t = lane % 4 and the lower
// column (or row) of each pair in the low 16 bits:
//   A 16x16: a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols
//            2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16x8:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// d += a b, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory: lanes 8q..8q+7 give the row
// addresses of matrix q (16 bytes each), r[q] receives its (row g, cols
// 2t, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as two bf16 terms: hi = bf16(v), lo = bf16(v - hi), both rounded
// to nearest, v0 in the low halves; hi + lo holds v to ~2^-16 relative.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// ---- TMA copies completing on an mbarrier (sm_90) ----
// A barrier of `count` arrivals; the fence makes its initialisation visible
// to the copy engine before the first copy names it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// A box of a 3D tensor map at (c0, c1, c2) (innermost first) into shared
// memory; the box's bytes complete on `bar` (elements outside the tensor
// arrive as zeros).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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
