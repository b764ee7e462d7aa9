// Row LayerNorm / RMSNorm forward (with optional saved statistics) and
// the backward's dx.
//
// Replaces the Pallas TPU kernels apex_tpu/ops/layer_norm.py
// _ln_fwd_kernel (:74) / _ln_fwd_kernel_nobias (:152), which write y and
// the per-row fp32 mean and rstd the backward needs, and
// _ln_bwd_dx_kernel (:93), which computes
//   dx = rstd * (w*dy - mean(w*dy) - xhat * mean(w*dy*xhat))
// from the saved statistics (the mean(w*dy) term drops for RMSNorm).
// The parameter gradients (column sums over rows) stay plain PyTorch, as
// the JAX package leaves them to XLA.
//
// What bounds them on an H100: bytes.  The forward reads x and writes y
// (2 * rows * h * itemsize, plus 8 bytes of statistics per row when they
// are asked for); the backward reads dy and x and writes dx
// (3 * rows * h * itemsize, plus the statistics) — a handful of flops per
// element, far below the card's 295 flop/byte ridge.  The sums are fp32
// in registers reduced in a fixed order (the same result on every run),
// and outputs are stored in x's dtype.  The weight and bias keep their
// own dtype (fp32 norm weights on bf16 activations under amp O2) and are
// multiplied in fp32.
//
// Forward and backward dx each take one of two paths:
// (1) Register-resident (ln_fwd_vec_kernel, ln_bwd_dx_vec_kernel), when
//     a row is a whole number of 16-byte vectors (h * itemsize % 16 ==
//     0; rows, weight and bias 16-byte aligned) and h <= 8192.  A row
//     group of 1, 2, 4 or 8 warps (the fewest that hold the row) owns a
//     row, in blocks of 128 threads (256 for a group of 8 warps); each
//     lane holds up to 32 elements of it — 4 vectors of bf16/fp16 or 8
//     of fp32 — so one warp takes a row up to h = 1024, and 8 warps up
//     to h = 8192.  The row (x, and dy in the backward) is read once,
//     with 16-byte loads, and stays in registers between the reductions
//     and the write.  Sums are warp shuffles in a fixed tree, then (row
//     groups of more than one warp) the warp partials in warp order.
//     The forward takes the JAX kernel's two passes over the registers:
//     the mean, then the sum of (x - mean)^2 (no E[x^2] - mean^2; RMSNorm
//     takes mean 0 and skips the first); the backward's two sums run in
//     one pass.  Each lane's weight (and bias) columns, read once as
//     vectors, stay in registers across the rows it walks: the grid is
//     sized to the blocks that fit on the card at once and strides over
//     rows.
// (2) Otherwise (h not a whole number of 16-byte vectors, or above
//     8192): one 256-thread block per row, the row swept from global
//     memory once per statistic and once for the write (the later
//     sweeps from L1/L2), with a block reduction per statistic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int h, float eps, int rms) {
  __shared__ float sh[33];
  const size_t off = (size_t)blockIdx.x * h;
  const T* xr = x + off;
  T* yr = y + off;
  float mu = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) s += apex::to_f(xr[i]);
    mu = apex::block_sum(s, sh) / (float)h;
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float d = __fsub_rn(apex::to_f(xr[i]), mu);
    ss = __fmaf_rn(d, d, ss);
  }
  const float var = apex::block_sum(ss, sh) / (float)h;
  const float rstd = 1.0f / sqrtf(var + eps);
  for (int i = threadIdx.x; i < h; i += kThreads) {
    float v = __fmul_rn(__fsub_rn(apex::to_f(xr[i]), mu), rstd);
    if (w != nullptr) v = __fmul_rn(v, apex::to_f(w[i]));
    if (b != nullptr) v = __fadd_rn(v, apex::to_f(b[i]));
    yr[i] = apex::from_f<T>(v);
  }
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const W* __restrict__ w, const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ dx, int h,
                 int rms) {
  __shared__ float sh[33];
  const size_t off = (size_t)blockIdx.x * h;
  const T* dyr = dy + off;
  const T* xr = x + off;
  T* dxr = dx + off;
  const float mu = mean[blockIdx.x];
  const float rs = rstd[blockIdx.x];
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = __fmul_rn(__fsub_rn(apex::to_f(xr[i]), mu), rs);
    float wdy = apex::to_f(dyr[i]);
    if (w != nullptr) wdy = __fmul_rn(wdy, apex::to_f(w[i]));
    s1 += wdy;
    s2 = __fmaf_rn(wdy, xhat, s2);
  }
  const float c1 = rms ? 0.f : apex::block_sum(s1, sh) / (float)h;
  const float c2 = apex::block_sum(s2, sh) / (float)h;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = __fmul_rn(__fsub_rn(apex::to_f(xr[i]), mu), rs);
    float wdy = apex::to_f(dyr[i]);
    if (w != nullptr) wdy = __fmul_rn(wdy, apex::to_f(w[i]));
    const float v = __fsub_rn(__fsub_rn(wdy, c1), __fmul_rn(xhat, c2));
    dxr[i] = apex::from_f<T>(__fmul_rn(v, rs));
  }
}

// the E weights of columns [v E, v E + E) in fp32, read as 8- or 16-byte
// vectors (E * sizeof(W) is 8, 16 or 32 bytes)
template <typename W, int E>
__device__ __forceinline__ void load_w(float (&out)[E], const W* w, int v) {
  constexpr int kBytes = E * (int)sizeof(W);
  using V = typename std::conditional<kBytes == 8, uint2, uint4>::type;
  constexpr int kN = kBytes / (int)sizeof(V);
  V raw[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) raw[k] = reinterpret_cast<const V*>(w + v * E)[k];
  const W* e = reinterpret_cast<const W*>(raw);
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = apex::to_f(e[i]);
}

// threads of a register-resident block: 128, or one row group of 8 warps
// (128-thread blocks beat 256 at 8192 x 1024 and, by more, at 1280 rows)
__host__ __device__ constexpr int vec_threads(int warps) {
  return warps * 32 > 128 ? warps * 32 : 128;
}

// Register-resident dx (path 1 of the header): kWarps warps per row,
// vec_threads / 32 / kWarps rows per block pass, NV 16-byte vectors a
// lane.  Vector v of a row belongs to thread v % (32 kWarps) of its row
// group.
template <typename T, typename W, int kWarps>
__global__ void __launch_bounds__(vec_threads(kWarps))
ln_bwd_dx_vec_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const W* __restrict__ w, const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     long long rows, int h, int rms) {
  constexpr int E = 16 / sizeof(T);           // elements per vector
  constexpr int NV = 32 / E;                  // vectors per lane
  constexpr int kBlock = vec_threads(kWarps);
  constexpr int kGroups = kBlock / 32 / kWarps;
  constexpr int kStride = 32 * kWarps;        // vectors per row pass
  __shared__ float red[kBlock / 32][2];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / kWarps;
  const int t = (warp % kWarps) * 32 + (threadIdx.x & 31);
  const int nvec = h / E;
  float wv[NV][E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = t + j * kStride;
    if (w != nullptr && v < nvec) {
      load_w<W, E>(wv[j], w, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) wv[j][e] = 1.f;
    }
  }
  for (long long base = (long long)blockIdx.x * kGroups; base < rows;
       base += (long long)gridDim.x * kGroups) {
    const long long row = base + grp;
    const bool active = row < rows;
    uint4 xv[NV], dv[NV];
    float mu = 0.f, rs = 0.f, s1 = 0.f, s2 = 0.f;
    if (active) {
      mu = mean[row];
      rs = rstd[row];
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
      const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * h);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = t + j * kStride;
        if (v < nvec) {
          xv[j] = xr[v];
          dv[j] = dyr[v];
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (t + j * kStride >= nvec) continue;
        const T* xe = reinterpret_cast<const T*>(&xv[j]);
        const T* de = reinterpret_cast<const T*>(&dv[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = __fmul_rn(__fsub_rn(apex::to_f(xe[e]), mu), rs);
          float wdy = apex::to_f(de[e]);
          if (w != nullptr) wdy = __fmul_rn(wdy, wv[j][e]);
          s1 += wdy;
          s2 = __fmaf_rn(wdy, xhat, s2);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(apex::kFull, s1, o);
      s2 += __shfl_xor_sync(apex::kFull, s2, o);
    }
    if (kWarps > 1) {
      if ((threadIdx.x & 31) == 0) {
        red[warp][0] = s1;
        red[warp][1] = s2;
      }
      __syncthreads();
      s1 = red[grp * kWarps][0];
      s2 = red[grp * kWarps][1];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        s1 += red[grp * kWarps + k][0];
        s2 += red[grp * kWarps + k][1];
      }
      __syncthreads();
    }
    if (!active) continue;
    const float c1 = rms ? 0.f : s1 / (float)h;
    const float c2 = s2 / (float)h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * h);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = t + j * kStride;
      if (v >= nvec) continue;
      const T* xe = reinterpret_cast<const T*>(&xv[j]);
      const T* de = reinterpret_cast<const T*>(&dv[j]);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(apex::to_f(xe[e]), mu), rs);
        float wdy = apex::to_f(de[e]);
        if (w != nullptr) wdy = __fmul_rn(wdy, wv[j][e]);
        const float o = __fsub_rn(__fsub_rn(wdy, c1), __fmul_rn(xhat, c2));
        oe[e] = apex::from_f<T>(__fmul_rn(o, rs));
      }
      dxr[v] = ov;
    }
  }
}

// the sum of v over a row group of kWarps warps: a shuffle tree in the
// warp, then the warp partials in warp order; every thread of the block
// calls it (red holds a float per warp)
template <int kWarps>
__device__ __forceinline__ float group_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(apex::kFull, v, o);
  if (kWarps > 1) {
    const int warp = threadIdx.x >> 5, g0 = warp / kWarps * kWarps;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[g0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += red[g0 + k];
    __syncthreads();
  }
  return v;
}

// Register-resident forward (path 1 of the header): the layout of
// ln_bwd_dx_vec_kernel.  mean_out / rstd_out may be null (serving).
template <typename T, typename W, int kWarps>
__global__ void __launch_bounds__(vec_threads(kWarps))
ln_fwd_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const W* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  long long rows, int h, float eps, int rms) {
  constexpr int E = 16 / sizeof(T);           // elements per vector
  constexpr int NV = 32 / E;                  // vectors per lane
  constexpr int kBlock = vec_threads(kWarps);
  constexpr int kGroups = kBlock / 32 / kWarps;
  constexpr int kStride = 32 * kWarps;        // vectors per row pass
  __shared__ float red[kBlock / 32];
  const int grp = (threadIdx.x >> 5) / kWarps;
  const int t = ((threadIdx.x >> 5) % kWarps) * 32 + (threadIdx.x & 31);
  const int nvec = h / E;
  float wv[NV][E], bv[NV][E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = t + j * kStride;
    if (w != nullptr && v < nvec) {
      load_w<W, E>(wv[j], w, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) wv[j][e] = 1.f;
    }
    if (b != nullptr && v < nvec) {
      load_w<W, E>(bv[j], b, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) bv[j][e] = 0.f;
    }
  }
  for (long long base = (long long)blockIdx.x * kGroups; base < rows;
       base += (long long)gridDim.x * kGroups) {
    const long long row = base + grp;
    const bool active = row < rows;
    uint4 xv[NV];
    float mu = 0.f;
    if (active) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (t + j * kStride < nvec) xv[j] = xr[t + j * kStride];
    }
    if (!rms) {
      float s = 0.f;
      if (active) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (t + j * kStride >= nvec) continue;
          const T* xe = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
          for (int e = 0; e < E; ++e) s += apex::to_f(xe[e]);
        }
      }
      mu = group_sum<kWarps>(s, red) / (float)h;
    }
    float ss = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (t + j * kStride >= nvec) continue;
        const T* xe = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = __fsub_rn(apex::to_f(xe[e]), mu);
          ss = __fmaf_rn(d, d, ss);
        }
      }
    }
    const float var = group_sum<kWarps>(ss, red) / (float)h;
    if (!active) continue;
    const float rstd = 1.0f / sqrtf(var + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * h);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = t + j * kStride;
      if (v >= nvec) continue;
      const T* xe = reinterpret_cast<const T*>(&xv[j]);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float o = __fmul_rn(__fsub_rn(apex::to_f(xe[e]), mu), rstd);
        if (w != nullptr) o = __fmul_rn(o, wv[j][e]);
        if (b != nullptr) o = __fadd_rn(o, bv[j][e]);
        oe[e] = apex::from_f<T>(o);
      }
      yr[v] = ov;
    }
    if (t == 0 && mean_out != nullptr) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// a grid of as many blocks of kern as fit on the card at once, with the
// row passes of kGroups rows spread evenly over them (0, or an error)
template <typename K>
int vec_grid(K kern, int block, int groups_per_block, long long rows,
             unsigned* grid) {
  int per_sm = 0;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, block, 0);
  if (e) return e;
  const long long groups = (rows + groups_per_block - 1) / groups_per_block;
  const long long cap = apex::persistent_grid(groups, per_sm);
  const long long passes = (groups + cap - 1) / cap;
  *grid = (unsigned)((groups + passes - 1) / passes);
  return 0;
}

// whether rows of h elements of T at these pointers take path 1
template <typename T>
bool vec_path(int h, uintptr_t ptrs) {
  return (long long)h * sizeof(T) % 16 == 0 && h <= 8 * 32 * 32 &&
         ptrs % 16 == 0;
}

template <typename T, typename W, int kWarps>
int launch_fwd_vec(const void* x, const void* w, const void* b, void* y,
                   float* mean, float* rstd, long long rows, int h,
                   float eps, int rms, cudaStream_t st) {
  constexpr int kBlock = vec_threads(kWarps);
  auto kern = ln_fwd_vec_kernel<T, W, kWarps>;
  unsigned grid = 0;
  const int e = vec_grid(kern, kBlock, kBlock / 32 / kWarps, rows, &grid);
  if (e) return e;
  kern<<<grid, kBlock, 0, st>>>((const T*)x, (const W*)w, (const W*)b,
                                  (T*)y, mean, rstd, rows, h, eps, rms);
  return 0;
}

template <typename T, typename W>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               float* mean, float* rstd, long long rows, int h, float eps,
               int rms, cudaStream_t st) {
  if (!vec_path<T>(h, (uintptr_t)x | (uintptr_t)y | (uintptr_t)w |
                          (uintptr_t)b)) {
    ln_fwd_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
        (const T*)x, (const W*)w, (const W*)b, (T*)y, mean, rstd, h, eps,
        rms);
    return 0;
  }
  constexpr int kElemsPerWarp = 32 * 32;      // a lane holds 32 elements
  if (h <= kElemsPerWarp)
    return launch_fwd_vec<T, W, 1>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
  if (h <= 2 * kElemsPerWarp)
    return launch_fwd_vec<T, W, 2>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
  if (h <= 4 * kElemsPerWarp)
    return launch_fwd_vec<T, W, 4>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
  return launch_fwd_vec<T, W, 8>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
}

template <typename T>
int launch_fwd_w(const void* x, const void* w, const void* b, void* y,
                 float* mean, float* rstd, long long rows, int h, float eps,
                 int rms, int wt, cudaStream_t st) {
  switch (wt) {
    case apex::kF32: return launch_fwd<T, float>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
    case apex::kBF16: return launch_fwd<T, __nv_bfloat16>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
    default: return launch_fwd<T, __half>(x, w, b, y, mean, rstd, rows, h, eps, rms, st);
  }
}

template <typename T, typename W, int kWarps>
int launch_bwd_vec(const void* dy, const void* x, const void* w,
                   const float* mean, const float* rstd, void* dx,
                   long long rows, int h, int rms, cudaStream_t st) {
  constexpr int kBlock = vec_threads(kWarps);
  auto kern = ln_bwd_dx_vec_kernel<T, W, kWarps>;
  unsigned grid = 0;
  const int e = vec_grid(kern, kBlock, kBlock / 32 / kWarps, rows, &grid);
  if (e) return e;
  kern<<<grid, kBlock, 0, st>>>((const T*)dy, (const T*)x, (const W*)w,
                                  mean, rstd, (T*)dx, rows, h, rms);
  return 0;
}

template <typename T, typename W>
int launch_bwd(const void* dy, const void* x, const void* w,
               const float* mean, const float* rstd, void* dx,
               long long rows, int h, int rms, cudaStream_t st) {
  constexpr int kElemsPerWarp = 32 * 32;      // a lane holds 32 elements
  if (!vec_path<T>(h, (uintptr_t)dy | (uintptr_t)x | (uintptr_t)dx |
                          (uintptr_t)w)) {
    ln_bwd_dx_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
        (const T*)dy, (const T*)x, (const W*)w, mean, rstd, (T*)dx, h, rms);
    return 0;
  }
  if (h <= kElemsPerWarp)
    return launch_bwd_vec<T, W, 1>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
  if (h <= 2 * kElemsPerWarp)
    return launch_bwd_vec<T, W, 2>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
  if (h <= 4 * kElemsPerWarp)
    return launch_bwd_vec<T, W, 4>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
  return launch_bwd_vec<T, W, 8>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
}

template <typename T>
int launch_bwd_w(const void* dy, const void* x, const void* w,
                 const float* mean, const float* rstd, void* dx,
                 long long rows, int h, int rms, int wt, cudaStream_t st) {
  switch (wt) {
    case apex::kF32: return launch_bwd<T, float>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
    case apex::kBF16: return launch_bwd<T, __nv_bfloat16>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
    default: return launch_bwd<T, __half>(dy, x, w, mean, rstd, dx, rows, h, rms, st);
  }
}

}  // namespace

// x, y: (rows, h) contiguous in dtype xt; w, b: (h,) in dtype wt, or
// null (no weight: scale 1; no bias).  rms != 0 skips the mean.  mean,
// rstd: (rows,) float32 outputs, or both null when no gradient is needed
// (the mean is written as 0 for RMSNorm).
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, void* mean, void* rstd, long long rows,
                           int h, float eps, int rms, int xt, int wt,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* mu = (float*)mean;
  float* rs = (float*)rstd;
  int e;
  switch (xt) {
    case apex::kF32: e = launch_fwd_w<float>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
    case apex::kBF16: e = launch_fwd_w<__nv_bfloat16>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
    default: e = launch_fwd_w<__half>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
  }
  return e ? e : (int)cudaGetLastError();
}

// dy, x, dx: (rows, h) contiguous in dtype xt; w: (h,) in dtype wt or
// null; mean, rstd: (rows,) float32 from apex_ln_fwd.
extern "C" int apex_ln_bwd_dx(const void* dy, const void* x, const void* w,
                              const void* mean, const void* rstd, void* dx,
                              long long rows, int h, int rms, int xt, int wt,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* mu = (const float*)mean;
  const float* rs = (const float*)rstd;
  int e;
  switch (xt) {
    case apex::kF32: e = launch_bwd_w<float>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
    case apex::kBF16: e = launch_bwd_w<__nv_bfloat16>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
    default: e = launch_bwd_w<__half>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
  }
  return e ? e : (int)cudaGetLastError();
}
