// Fused BatchNorm(+residual-add+ReLU) over a channels-last (rows, C)
// matrix: the two forward passes and the two backward passes.
//
// Replaces the Pallas TPU kernels of apex_tpu/ops/batch_norm.py:
//   _bn_reduce_kernel (:152)      -> apex_bn_reduce:      s1 = sum x, s2 = sum x^2
//   _bn_apply_kernel (:166)       -> apex_bn_apply:       y = act(x*scale + shift (+ res))
//   _bn_bwd_reduce_kernel (:188)  -> apex_bn_bwd_reduce:  s1 = sum dz, s2 = sum dz*xhat
//   _bn_bwd_dx_kernel (:211)      -> apex_bn_bwd_dx:      dx = a*dz + b + xhat*c, dres = dz
// where dz = dy * 1[pre-activation > 0] under the ReLU epilogue: read from
// the saved output y when there is a residual, else recomputed from the
// per-channel affine x*scale + shift (_relu_mask, :177).  The per-channel
// (C,) arithmetic between the passes (mean, var, rstd, scale, shift and
// the dx coefficients) stays in PyTorch, as the JAX package leaves it to
// XLA.
//
// What bounds them on an H100: bytes.  Each pass reads its (rows, C)
// operands once and writes its (rows, C) outputs once, with a handful of
// flops per element (the card's ridge is ~295 bf16 flop/byte).  Design:
// - one layout for all four: a block of 256 threads owns a tile of up to
//   32 column vectors (16 bytes each: 8 bf16/fp16 or 4 fp32 channels)
//   and a contiguous chunk of rows, which its thread rows walk in steps
//   of the block's row count.  Neighbouring threads read neighbouring 16
//   bytes, and each thread keeps its channels' per-channel vectors in
//   registers for the whole chunk.  Any C works: when C is not a multiple
//   of the vector width (or a pointer is not 16-byte aligned) the same
//   kernels run one channel per thread.
// - the reductions split the row axis over many chunks (the stem's 1.6M
//   rows at C = 64 would leave most of the 132 SMs idle if one block
//   walked a channel's rows): each block sums its chunk in fp32, reduces
//   its thread rows through shared memory in a fixed order and writes one
//   partial row per chunk; a second launch sums the partials of each
//   channel with one warp, lanes in order and then a fixed shuffle tree.
//   No float atomics: a rerun gives the same bits.
// - the elementwise passes round every product and sum on its own
//   (__fmul_rn / __fadd_rn, no contraction into FMA), which is the plain
//   PyTorch version's rounding: on the same per-channel vectors, y, dx and
//   dres equal it bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = apex::kRowThreads;
using apex::load_f;
using apex::store_f;
using apex::Tile;
using apex::tile_of;

// per-channel fp32 vectors: loaded once per thread, element by element
// (a (C,) view need not be 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_ch(const float* p, int c0, float (&o)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = p[c0 + i];
}

// dz = dy * mask: the mask from the saved output y (residual) or from the
// per-channel affine of x (no residual), as 1.0 / 0.0 multipliers like the
// plain version's bool-to-float product
template <typename T, int V>
__device__ __forceinline__ void mask_dz(float (&d)[V], const float (&xv)[V],
                                        const T* y, size_t off,
                                        const float (&sc)[V],
                                        const float (&sf)[V]) {
  if (y != nullptr) {
    float yv[V];
    load_f<T, V>(y + off, yv);
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = __fmul_rn(d[i], yv[i] > 0.f ? 1.f : 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float pre = __fadd_rn(__fmul_rn(xv[i], sc[i]), sf[i]);
      d[i] = __fmul_rn(d[i], pre > 0.f ? 1.f : 0.f);
    }
  }
}

// Stage 1 of both reductions: per-chunk partial sums, part[chunk][0][c]
// (s1) and part[chunk][1][c] (s2).  BWD = false: s1 = sum x, s2 = sum x^2.
// BWD = true: s1 = sum dz, s2 = sum dz * xhat.
template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(kThreads)
bn_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, float* __restrict__ part,
                   long long rows, int c, int chunks, int relu) {
  __shared__ float sh1[kThreads * V];
  __shared__ float sh2[kThreads * V];
  const Tile t = tile_of<V>(rows, c, chunks);
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.f;
  if (t.live) {
    float mu[V], rs[V], sc[V], sf[V];
    if (BWD) {
      load_ch<V>(mean, t.c0, mu);
      load_ch<V>(rstd, t.c0, rs);
      if (relu && y == nullptr) {
        load_ch<V>(scale, t.c0, sc);
        load_ch<V>(shift, t.c0, sf);
      }
    }
#pragma unroll 4
    for (long long r = t.r0 + t.lane_r; r < t.r1; r += t.ty) {
      const size_t off = (size_t)r * c + t.c0;
      float xv[V];
      load_f<T, V>(x + off, xv);
      if (!BWD) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a1[i] = __fadd_rn(a1[i], xv[i]);
          a2[i] = __fmaf_rn(xv[i], xv[i], a2[i]);
        }
      } else {
        float d[V];
        load_f<T, V>(dy + off, d);
        if (relu) mask_dz<T, V>(d, xv, y, off, sc, sf);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
          a1[i] = __fadd_rn(a1[i], d[i]);
          a2[i] = __fmaf_rn(d[i], xhat, a2[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh1[threadIdx.x * V + i] = a1[i];
    sh2[threadIdx.x * V + i] = a2[i];
  }
  __syncthreads();
  if (t.lane_r == 0 && t.cvi < c / V) {
    float* out = part + (size_t)blockIdx.x * 2 * c;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < t.ty; ++j) {
        const int k = (j * t.tx + t.lane_c) * V + i;
        s1 = __fadd_rn(s1, sh1[k]);
        s2 = __fadd_rn(s2, sh2[k]);
      }
      out[t.c0 + i] = s1;
      out[c + t.c0 + i] = s2;
    }
  }
}

// Stage 2: out[k] = sum over chunks of part[chunk][k], k < width = 2C;
// one warp per k, lanes over chunks in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int width, int chunks) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (k >= width) return;  // uniform per warp
  float s = 0.f;
  for (int g = lane; g < chunks; g += 32) s = __fadd_rn(s, part[(size_t)g * width + k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(apex::kFull, s, o));
  if (lane == 0) out[k] = s;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ scale,
                const float* __restrict__ shift, T* __restrict__ y,
                long long rows, int c, int chunks, int relu) {
  const Tile t = tile_of<V>(rows, c, chunks);
  if (!t.live) return;
  float sc[V], sf[V];
  load_ch<V>(scale, t.c0, sc);
  load_ch<V>(shift, t.c0, sf);
#pragma unroll 4
  for (long long r = t.r0 + t.lane_r; r < t.r1; r += t.ty) {
    const size_t off = (size_t)r * c + t.c0;
    float z[V];
    load_f<T, V>(x + off, z);
#pragma unroll
    for (int i = 0; i < V; ++i) z[i] = __fadd_rn(__fmul_rn(z[i], sc[i]), sf[i]);
    if (res != nullptr) {
      float rv[V];
      load_f<T, V>(res + off, rv);
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = __fadd_rn(z[i], rv[i]);
    }
    if (relu) {
      // NaN stays NaN (a loss-scale overflow must reach the finite check)
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = z[i] < 0.f ? 0.f : z[i];
    }
    store_f<T, V>(y + off, z);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const T* __restrict__ y, const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ ca,
                 const float* __restrict__ cb, const float* __restrict__ cc,
                 T* __restrict__ dx, T* __restrict__ dres, long long rows,
                 int c, int chunks, int relu) {
  const Tile t = tile_of<V>(rows, c, chunks);
  if (!t.live) return;
  float mu[V], rs[V], va[V], vb[V], vc[V], sc[V], sf[V];
  load_ch<V>(mean, t.c0, mu);
  load_ch<V>(rstd, t.c0, rs);
  load_ch<V>(ca, t.c0, va);
  load_ch<V>(cb, t.c0, vb);
  load_ch<V>(cc, t.c0, vc);
  if (relu && y == nullptr) {
    load_ch<V>(scale, t.c0, sc);
    load_ch<V>(shift, t.c0, sf);
  }
#pragma unroll 4
  for (long long r = t.r0 + t.lane_r; r < t.r1; r += t.ty) {
    const size_t off = (size_t)r * c + t.c0;
    float xv[V], d[V];
    load_f<T, V>(x + off, xv);
    load_f<T, V>(dy + off, d);
    if (relu) mask_dz<T, V>(d, xv, y, off, sc, sf);
    if (dres != nullptr) store_f<T, V>(dres + off, d);
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xhat = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
      o[i] = __fadd_rn(__fadd_rn(__fmul_rn(va[i], d[i]), vb[i]),
                       __fmul_rn(xhat, vc[i]));
    }
    store_f<T, V>(dx + off, o);
  }
}

// grid (chunks, column tiles) of the shared layout, or false when the
// arguments cannot be launched
bool grid_of(int c, int vec, int chunks, dim3* grid) {
  if (c <= 0 || vec <= 0 || c % vec != 0 || chunks <= 0) return false;
  const int cv = c / vec;
  const int tx = cv < 32 ? cv : 32;
  const int tiles = (cv + tx - 1) / tx;
  if (tiles > 65535) return false;
  *grid = dim3((unsigned)chunks, (unsigned)tiles);
  return true;
}

int reduce(const void* x, const void* dy, const void* y, const void* scale,
           const void* shift, const void* mean, const void* rstd, void* part,
           void* out, long long rows, int c, int vec, int chunks, int relu,
           int xt, bool bwd, cudaStream_t st) {
  dim3 grid;
  if (!grid_of(c, vec, chunks, &grid)) return (int)cudaErrorInvalidValue;
  const bool ok = apex::dispatch_vec(xt, vec, [&](auto tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = decltype(v)::value;
    auto args = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, st>>>(
          (const T*)x, (const T*)dy, (const T*)y, (const float*)scale,
          (const float*)shift, (const float*)mean, (const float*)rstd,
          (float*)part, rows, c, chunks, relu);
    };
    if (bwd) args(bn_partials_kernel<T, V, true>);
    else args(bn_partials_kernel<T, V, false>);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = 2 * c;
  const int per = kThreads / 32;
  bn_finalize_kernel<<<(width + per - 1) / per, kThreads, 0, st>>>(
      (const float*)part, (float*)out, width, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, c) contiguous in dtype xt; part: (chunks, 2, c) float32
// scratch; out: (2, c) float32 = (sum x, sum x^2).  vec: channels per
// thread (16 / itemsize when c is a multiple of it and the pointers are
// 16-byte aligned, else 1); chunks: row chunks of the partial sums.
extern "C" int apex_bn_reduce(const void* x, void* part, void* out,
                              long long rows, int c, int vec, int chunks,
                              int xt, void* stream) {
  return reduce(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, part,
                out, rows, c, vec, chunks, 0, xt, false, (cudaStream_t)stream);
}

// y = act(x * scale + shift (+ res)); res null for none; relu != 0 for
// the ReLU epilogue.  scale, shift: (c,) float32.
extern "C" int apex_bn_apply(const void* x, const void* res, const void* scale,
                             const void* shift, void* y, long long rows, int c,
                             int vec, int chunks, int relu, int xt,
                             void* stream) {
  dim3 grid;
  if (!grid_of(c, vec, chunks, &grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = apex::dispatch_vec(xt, vec, [&](auto tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = decltype(v)::value;
    bn_apply_kernel<T, V><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)res, (const float*)scale, (const float*)shift,
        (T*)y, rows, c, chunks, relu);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out: (2, c) float32 = (sum dz, sum dz * xhat), xhat = (x - mean) * rstd,
// dz = dy masked by the ReLU when relu != 0: from y > 0 when y is given
// (the residual case), else from x * scale + shift > 0.  dy, x, y: (rows,
// c) in dtype xt; the (c,) vectors float32; part as for apex_bn_reduce.
extern "C" int apex_bn_bwd_reduce(const void* dy, const void* x, const void* y,
                                  const void* scale, const void* shift,
                                  const void* mean, const void* rstd,
                                  void* part, void* out, long long rows, int c,
                                  int vec, int chunks, int relu, int xt,
                                  void* stream) {
  return reduce(x, dy, y, scale, shift, mean, rstd, part, out, rows, c, vec,
                chunks, relu, xt, true, (cudaStream_t)stream);
}

// dx = a * dz + b + xhat * cc, and dres = dz when dres is not null; dz
// and xhat as for apex_bn_bwd_reduce; a, b, cc: (c,) float32.
extern "C" int apex_bn_bwd_dx(const void* dy, const void* x, const void* y,
                              const void* scale, const void* shift,
                              const void* mean, const void* rstd,
                              const void* a, const void* b, const void* cc,
                              void* dx, void* dres, long long rows, int c,
                              int vec, int chunks, int relu, int xt,
                              void* stream) {
  dim3 grid;
  if (!grid_of(c, vec, chunks, &grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = apex::dispatch_vec(xt, vec, [&](auto tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int V = decltype(v)::value;
    bn_bwd_dx_kernel<T, V><<<grid, kThreads, 0, st>>>(
        (const T*)dy, (const T*)x, (const T*)y, (const float*)scale,
        (const float*)shift, (const float*)mean, (const float*)rstd,
        (const float*)a, (const float*)b, (const float*)cc, (T*)dx, (T*)dres,
        rows, c, chunks, relu);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
