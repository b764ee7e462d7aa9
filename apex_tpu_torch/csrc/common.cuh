// Shared helpers for the port's kernels: element loads/stores in fp32,
// dtype codes matching apex_tpu_torch/_build.py (0 = float32, 1 =
// bfloat16, 2 = float16, 3 = int8 and 4 = float8_e4m3fn, the last two
// the codes of a quantized paged KV pool) and deterministic block reductions (fixed shuffle tree,
// then warp partials in warp order — the same sum on every run).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace apex {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kF8 = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return (float)v; }

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

// ---- the row-tile layout of csrc/batch_norm.cu and csrc/group_norm.cu ----
// A block of kRowThreads threads owns up to 32 column vectors of V
// channels across a chunk of the rows of a channels-last (rows, C)
// matrix; V is 16 bytes of channels (8 half or 4 fp32) or 1.
constexpr int kRowThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&o)[V]) {
  const Pack<T, V> k = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = to_f(k.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&o)[V]) {
  Pack<T, V> k;
#pragma unroll
  for (int i = 0; i < V; ++i) k.v[i] = from_f<T>(o[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = k;
}

// The tile a thread works on: thread (lane_r, lane_c) of a block with tx
// column vectors by ty rows owns column vector cvi (column tile `tile`,
// grid column blockIdx.y) and the rows r0 + lane_r, r0 + lane_r + ty, ...
// below r1 of row chunk `chunk` (blockIdx.x).
struct Tile {
  int tx, ty, lane_c, lane_r, cvi, c0;
  bool live;
  long long r0, r1;
};

__device__ __forceinline__ long long chunk_rows(long long rows, int chunks) {
  return (rows + chunks - 1) / chunks;
}

template <int V>
__device__ __forceinline__ Tile tile_at(long long rows, int c, int chunks,
                                        int tile, long long chunk) {
  Tile t;
  const int cv = c / V;
  t.tx = cv < 32 ? cv : 32;
  t.ty = kRowThreads / t.tx;
  t.lane_c = threadIdx.x % t.tx;
  t.lane_r = threadIdx.x / t.tx;
  t.cvi = tile * t.tx + t.lane_c;
  t.c0 = t.cvi * V;
  t.live = t.lane_r < t.ty && t.cvi < cv;
  const long long per = chunk_rows(rows, chunks);
  t.r0 = chunk * per;
  t.r1 = t.r0 + per < rows ? t.r0 + per : rows;
  return t;
}

template <int V>
__device__ __forceinline__ Tile tile_of(long long rows, int c, int chunks) {
  return tile_at<V>(rows, c, chunks, (int)blockIdx.y, (long long)blockIdx.x);
}

// Calls f((T*)nullptr, std::integral_constant<int, V>{}) for dtype code xt
// and vector width vec: 16 bytes (8 half or 4 fp32 channels) or 1; false
// for any other pair.
template <typename F>
bool dispatch_vec(int xt, int vec, F&& f) {
  using V1 = std::integral_constant<int, 1>;
  using V4 = std::integral_constant<int, 4>;
  using V8 = std::integral_constant<int, 8>;
  switch (xt) {
    case kF32:
      if (vec == 4) f((float*)nullptr, V4{});
      else if (vec == 1) f((float*)nullptr, V1{});
      else return false;
      return true;
    case kBF16:
      if (vec == 8) f((__nv_bfloat16*)nullptr, V8{});
      else if (vec == 1) f((__nv_bfloat16*)nullptr, V1{});
      else return false;
      return true;
    case kF16:
      if (vec == 8) f((__half*)nullptr, V8{});
      else if (vec == 1) f((__half*)nullptr, V1{});
      else return false;
      return true;
    default:
      return false;
  }
}

// x / d for x < 2^31 by a multiply-high against the magic pair of d
// (made on the host by ops/softmax.py _magic or csrc/rope.cu magic_of):
// (umulhi(x, m) + x) >> l
struct Magic {
  uint32_t m;
  int l;
};

__device__ __forceinline__ uint32_t mdiv(uint32_t x, Magic g) {
  return (__umulhi(x, g.m) + x) >> g.l;
}

// Blocks of a persistent grid on the current device: per_sm on each
// multiprocessor, at most one per item.
inline int persistent_grid(long long n_items, int per_sm = 1) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)(per_sm > 1 ? per_sm : 1) *
                        (n_sm > 1 ? n_sm : 1);
  return (int)(n_items < 1 ? 1 : n_items < cap ? n_items : cap);
}

}  // namespace apex
