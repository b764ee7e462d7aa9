// Shared helpers for the port's kernels: element loads/stores in fp32,
// dtype codes matching apex_tpu_torch/ops (0 = float32, 1 = bfloat16,
// 2 = float16) and deterministic block reductions (fixed shuffle tree,
// then warp partials in warp order — the same sum on every run).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace apex {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

constexpr unsigned kFull = 0xffffffffu;

// Sum over the block; `sh` holds at least 33 floats.  Every thread gets
// the result.  blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sh[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const float r = sh[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum_int(int v, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const int r = sh[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, o));
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sh[lane] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, o));
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const float r = sh[32];
  __syncthreads();
  return r;
}

// First-index argmax over the block: the largest value, and among equal
// values the smallest index.  `sv`/`si` hold at least 33 entries.
__device__ __forceinline__ void argmax_pick(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ int block_argmax(float v, int i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_pick(v, i, __shfl_down_sync(kFull, v, o), __shfl_down_sync(kFull, i, o));
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      argmax_pick(v, i, __shfl_down_sync(kFull, v, o), __shfl_down_sync(kFull, i, o));
    if (lane == 0) si[32] = i;
  }
  __syncthreads();
  const int r = si[32];
  __syncthreads();
  return r;
}

}  // namespace apex
