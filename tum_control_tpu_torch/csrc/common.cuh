// Small helpers shared by the kernels: NaN-propagating min/max (the
// semantics of jnp.minimum / torch.minimum, unlike fminf which drops NaN), a
// quotient from a reciprocal (div_rn) and asynchronous copies to shared
// memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu

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
