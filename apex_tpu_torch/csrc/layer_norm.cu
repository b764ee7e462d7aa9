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
// element, far below the card's 295 flop/byte ridge.  Design: one block
// per row; the row is swept from global memory once per statistic (the
// later sweeps hit L1/L2, a row is at most a few KB), the sums are fp32
// in registers reduced in a fixed order (the same result on every run),
// and outputs are stored in x's dtype.  There is no h % 128 lane rule:
// any h works.  The weight and bias keep their own dtype (fp32 norm
// weights on bf16 activations under amp O2) and are multiplied in fp32.
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

template <typename T, typename W>
void launch_fwd(const void* x, const void* w, const void* b, void* y,
                float* mean, float* rstd, long long rows, int h, float eps,
                int rms, cudaStream_t st) {
  ln_fwd_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
      (const T*)x, (const W*)w, (const W*)b, (T*)y, mean, rstd, h, eps, rms);
}

template <typename T>
void launch_fwd_w(const void* x, const void* w, const void* b, void* y,
                  float* mean, float* rstd, long long rows, int h, float eps,
                  int rms, int wt, cudaStream_t st) {
  switch (wt) {
    case apex::kF32: launch_fwd<T, float>(x, w, b, y, mean, rstd, rows, h, eps, rms, st); break;
    case apex::kBF16: launch_fwd<T, __nv_bfloat16>(x, w, b, y, mean, rstd, rows, h, eps, rms, st); break;
    default: launch_fwd<T, __half>(x, w, b, y, mean, rstd, rows, h, eps, rms, st); break;
  }
}

template <typename T, typename W>
void launch_bwd(const void* dy, const void* x, const void* w,
                const float* mean, const float* rstd, void* dx,
                long long rows, int h, int rms, cudaStream_t st) {
  ln_bwd_dx_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
      (const T*)dy, (const T*)x, (const W*)w, mean, rstd, (T*)dx, h, rms);
}

template <typename T>
void launch_bwd_w(const void* dy, const void* x, const void* w,
                  const float* mean, const float* rstd, void* dx,
                  long long rows, int h, int rms, int wt, cudaStream_t st) {
  switch (wt) {
    case apex::kF32: launch_bwd<T, float>(dy, x, w, mean, rstd, dx, rows, h, rms, st); break;
    case apex::kBF16: launch_bwd<T, __nv_bfloat16>(dy, x, w, mean, rstd, dx, rows, h, rms, st); break;
    default: launch_bwd<T, __half>(dy, x, w, mean, rstd, dx, rows, h, rms, st); break;
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
  switch (xt) {
    case apex::kF32: launch_fwd_w<float>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
    case apex::kBF16: launch_fwd_w<__nv_bfloat16>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
    default: launch_fwd_w<__half>(x, w, b, y, mu, rs, rows, h, eps, rms, wt, st); break;
  }
  return (int)cudaGetLastError();
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
  switch (xt) {
    case apex::kF32: launch_bwd_w<float>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
    case apex::kBF16: launch_bwd_w<__nv_bfloat16>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
    default: launch_bwd_w<__half>(dy, x, w, mu, rs, dx, rows, h, rms, wt, st); break;
  }
  return (int)cudaGetLastError();
}
