// Half-rotation (NeoX / Llama) rotary position embedding, forward.
//
// Replaces the Pallas TPU kernel apex_tpu/ops/rope.py _rope_kernel
// (:83): rotate the first rot_dim channels of every head by per-position
// cos/sin tables, pass the tail of a partial rotary span through.
//
// What bounds it on an H100: bytes — x is read once and y written once
// (2 * numel * itemsize) for 6 flops per rotated pair, plus the fp32
// tables.  Design: one thread per rotated pair (j, j + half) and one per
// tail element, consecutive threads on consecutive channels so loads and
// stores coalesce; the math is fp32 with explicit round-to-nearest
// products and sums (no contraction into fma), which is the order the
// plain PyTorch version rounds in.  The tables are either shared over
// the batch, (s, half), or per row, (b, s, half): the batched serving
// engine rotates every slot at its own position.  The Pallas wrapper's
// half % 128 lane gate has no counterpart here; head_dim 128 (half 64)
// runs this kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ y,
            long long rows, int seq, int heads, int d, int half,
            int per_row) {
  const int tail = d - 2 * half;
  const int width = half + tail;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * width) return;
  const long long row = t / width;          // (b, s, head) flattened
  const int j = (int)(t - row * width);
  const T* xr = x + row * d;
  T* yr = y + row * d;
  if (j < half) {
    const long long bs = row / heads;       // (b, s) flattened
    const long long tix = per_row ? bs : bs % seq;
    const float c = cos_t[tix * half + j];
    const float s = sin_t[tix * half + j];
    const float x1 = apex::to_f(xr[j]);
    const float x2 = apex::to_f(xr[j + half]);
    yr[j] = apex::from_f<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    yr[j + half] = apex::from_f<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  } else {
    const int c = 2 * half + (j - half);
    yr[c] = xr[c];
  }
}

template <typename T>
void launch(const void* x, const float* c, const float* s, void* y,
            long long rows, int seq, int heads, int d, int half, int per_row,
            cudaStream_t st) {
  const long long total = rows * (long long)(d - half);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  rope_kernel<T><<<blocks, kThreads, 0, st>>>((const T*)x, c, s, (T*)y, rows,
                                              seq, heads, d, half, per_row);
}

}  // namespace

// x, y: (b, seq, heads, d) contiguous in dtype xt, rows = b * seq * heads;
// cos, sin: float32 (seq, half) or, with per_row, (b, seq, half).
extern "C" int apex_rope_fwd(const void* x, const void* cos_t,
                             const void* sin_t, void* y, long long rows,
                             int seq, int heads, int d, int half,
                             int per_row, int xt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)cos_t;
  const float* s = (const float*)sin_t;
  switch (xt) {
    case apex::kF32: launch<float>(x, c, s, y, rows, seq, heads, d, half, per_row, st); break;
    case apex::kBF16: launch<__nv_bfloat16>(x, c, s, y, rows, seq, heads, d, half, per_row, st); break;
    default: launch<__half>(x, c, s, y, rows, seq, heads, d, half, per_row, st); break;
  }
  return (int)cudaGetLastError();
}
