// Small helpers shared by the kernels: NaN-propagating min/max (the
// semantics of jnp.minimum / torch.minimum, unlike fminf which drops NaN), a
// quotient from a reciprocal (div_rn), asynchronous copies to shared memory,
// and the opt-in to more than 48 KB of shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

constexpr size_t SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without an opt-in

__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// a / b from y = 1 / b (correctly rounded) and one FMA correction of the
// quotient (Markstein): within an ulp of a / b, and in nearly every case the
// same float. K3's and K4's quotients go through it: the IEEE division `a / b`
// compiles to a sequence with a slow-path branch on the pivot chain, while
// one reciprocal per pivot, taken by every lane, and a multiply and two FMAs
// per quotient schedule freely.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-q, b, a), y, q);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// n floats from src (device memory) to dst (shared memory) by the block's
// `nthreads` threads, all copies in flight: 16 bytes per copy where both are
// 16-byte aligned and n % 4 == 0, else 4. The caller waits (cp_async_wait_all)
// and synchronizes before reading dst.
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n, int tid,
                                            int nthreads) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      (n & 3) == 0) {
    for (int i = 4 * tid; i < n; i += 4 * nthreads) cp_async16(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  }
}

// Opts `fn` in to more than the default 48 KB of dynamic shared memory. At or
// below it no host API call is made.
static inline cudaError_t reserve_smem(const void* fn, size_t smem) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
