// Small helpers shared by the kernels: NaN-propagating min/max (the
// semantics of jnp.minimum / torch.minimum, unlike fminf which drops NaN)
// and block-wide reductions over blockDim.x <= 1024 threads.
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

// Sum over the block; every thread gets the result. `scratch` holds 32
// floats of shared memory; the call synchronises the block twice.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < nwarps; ++w) r += scratch[w];
  __syncthreads();
  return r;
}

// NaN-propagating min over the block; every thread gets the result.
__device__ __forceinline__ float block_min(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(FULL_MASK, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = pmin(r, scratch[w]);
  __syncthreads();
  return r;
}

// Logical AND over the block; every thread gets the result.
__device__ __forceinline__ bool block_all(bool v) {
  return __syncthreads_and(v) != 0;
}
