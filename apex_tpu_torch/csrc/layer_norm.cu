// Row LayerNorm / RMSNorm forward.
//
// Replaces the Pallas TPU kernels apex_tpu/ops/layer_norm.py
// _ln_fwd_kernel (:74) and _ln_fwd_kernel_nobias (:152), forward only:
// serving needs neither the saved mean/rstd nor the backward kernel.
//
// What bounds it on an H100: bytes.  Each row is read and written once
// (2 * rows * h * itemsize bytes) against a handful of flops per
// element, far below the card's 295 flop/byte ridge.  Design: one block
// per row; the row is swept from global memory once per statistic (the
// second and third sweeps hit L1/L2, the row is at most a few KB), the
// statistics are fp32 sums held in registers and reduced in a fixed
// order, and the output is stored in the input's dtype.  Unlike the
// Pallas kernel there is no h % 128 lane rule: any h works.  The weight
// and bias keep their own dtype and are multiplied in fp32.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ y, int h, float eps,
              int rms) {
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
}

template <typename T, typename W>
void launch(const void* x, const void* w, const void* b, void* y,
            long long rows, int h, float eps, int rms, cudaStream_t st) {
  ln_fwd_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
      (const T*)x, (const W*)w, (const W*)b, (T*)y, h, eps, rms);
}

template <typename T>
void launch_w(const void* x, const void* w, const void* b, void* y,
              long long rows, int h, float eps, int rms, int wt,
              cudaStream_t st) {
  switch (wt) {
    case apex::kF32: launch<T, float>(x, w, b, y, rows, h, eps, rms, st); break;
    case apex::kBF16: launch<T, __nv_bfloat16>(x, w, b, y, rows, h, eps, rms, st); break;
    default: launch<T, __half>(x, w, b, y, rows, h, eps, rms, st); break;
  }
}

}  // namespace

// x, y: (rows, h) contiguous in dtype xt; w, b: (h,) in dtype wt, or
// null (no weight: scale 1; no bias).  rms != 0 skips the mean.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, long long rows, int h, float eps,
                           int rms, int xt, int wt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (xt) {
    case apex::kF32: launch_w<float>(x, w, b, y, rows, h, eps, rms, wt, st); break;
    case apex::kBF16: launch_w<__nv_bfloat16>(x, w, b, y, rows, h, eps, rms, wt, st); break;
    default: launch_w<__half>(x, w, b, y, rows, h, eps, rms, wt, st); break;
  }
  return (int)cudaGetLastError();
}
