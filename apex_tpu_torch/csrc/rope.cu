// Half-rotation (NeoX / Llama) rotary position embedding, forward and
// backward, on one or two operands (q and k) in one launch.
//
// Replaces the Pallas TPU kernel apex_tpu/ops/rope.py _rope_kernel
// (:83): rotate the first rot_dim channels of every head by per-position
// cos/sin tables, pass the tail of a partial rotary span through; the
// backward (_rope_pallas_bwd, :131) is the same rotation by -theta, here a
// sign argument on sin (exact: only the sign bit changes).
//
// What bounds it on an H100: bytes — each operand is read once and
// written once (2 * numel * itemsize) for 6 flops per rotated pair, plus
// the fp32 tables.  Design: a block takes one or more (b, s) positions
// (blockIdx.x split into (b, sequence block) by a multiply-high), a
// thread one 16-byte vector of x1 (8 bf16/fp16 or 4 fp32 channels) and
// the matching vector of x2 = x1 + half, for every head of both operands:
// it loads its slice of the position's cos/sin row once (16-byte vectors)
// and walks the heads two at a time, both heads' loads issued before
// either's stores.  The operands are read through their element strides
// as (b, s, groups, rep, d) with d contiguous, so q and k are read
// straight from the packed qkv projection — a (b, s, heads, d) view has
// rep = 1; q in the grouped layout is the (b, s, kv heads, rep, d) view —
// and written contiguous (b, s, heads, d).  Spans, tails, strides or
// pointers that are not whole 16-byte vectors take the same kernel one
// element a thread (VEC = 1).  Offsets are 32-bit unless an operand
// spans 2^31 elements.  The math is fp32 with explicit round-to-nearest
// products and sums (no contraction into fma), the order the plain
// PyTorch version rounds in, so outputs equal it exactly; the tail is
// copied as raw bits.  The tables are either shared over the batch,
// (s, half), or per row, (b, s, half): the batched serving engine
// rotates every slot at its own position.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One operand: x read as (b, s, groups, rep, d) through element strides
// sb, ss, sg, sr (channels contiguous), y written (b, s, heads, d)
// contiguous, heads = groups * rep.
struct Operand {
  const void* x;
  void* y;
  long long sb, ss, sg, sr;
  int heads, nrep;
  apex::Magic rep;  // head -> (group, rep)
};

struct Params {
  Operand a, b;  // b.heads == 0: one operand
  const float* cos;
  const float* sin;
  int seq, d, half, per_row;
  float sign;  // +1 forward, -1 backward (rotation by -theta)
  int nrot, nchunks;  // vectors a head: rotated ones, then the tail's
  int nsb;            // sequence blocks a batch row
  apex::Magic sblocks;
};

// head h of the two operands: its input row and its output row
template <typename T, typename I>
__device__ __forceinline__ void locate(const Params& p, uint32_t bi, int si,
                                       I pos, int h, const T** xr, T** yr) {
  const bool first = h < p.a.heads;
  const int lh = first ? h : h - p.a.heads;
  const uint32_t g = apex::mdiv((uint32_t)lh, first ? p.a.rep : p.b.rep);
  const int r = lh - (int)g * (first ? p.a.nrep : p.b.nrep);
  const I off = (I)bi * (I)(first ? p.a.sb : p.b.sb) +
                (I)si * (I)(first ? p.a.ss : p.b.ss) +
                (I)g * (I)(first ? p.a.sg : p.b.sg) +
                (I)r * (I)(first ? p.a.sr : p.b.sr);
  *xr = static_cast<const T*>(first ? p.a.x : p.b.x) + off;
  *yr = static_cast<T*>(first ? p.a.y : p.b.y) +
        (pos * (I)(first ? p.a.heads : p.b.heads) + lh) * (I)p.d;
}

template <typename T, int VEC>
__device__ __forceinline__ void rotate_store(T* yr, int j, int half,
                                             const float (&x1)[VEC],
                                             const float (&x2)[VEC],
                                             const float (&c)[VEC],
                                             const float (&s)[VEC]) {
  float o1[VEC], o2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    o1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
    o2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
  }
  apex::store_f<T, VEC>(yr + j, o1);
  apex::store_f<T, VEC>(yr + j + half, o2);
}

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const Params p) {
  const uint32_t bi = apex::mdiv(blockIdx.x, p.sblocks);
  const int si = (int)(blockIdx.x - bi * (uint32_t)p.nsb) * (int)blockDim.z +
                 (int)threadIdx.z;
  if (si >= p.seq) return;
  const I pos = (I)bi * (I)p.seq + (I)si;  // (b, s) flattened
  const float* ct = p.cos + (p.per_row ? pos : (I)si) * (I)p.half;
  const float* st = p.sin + (p.per_row ? pos : (I)si) * (I)p.half;
  const int heads = p.a.heads + p.b.heads;
  const int step = 2 * (int)blockDim.y;
  for (int c = threadIdx.x; c < p.nchunks; c += blockDim.x) {
    if (c < p.nrot) {
      const int j = c * VEC;
      float cv[VEC], sv[VEC];
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(ct + j + k);
          const float4 s4 = *reinterpret_cast<const float4*>(st + j + k);
          cv[k] = c4.x; cv[k + 1] = c4.y; cv[k + 2] = c4.z; cv[k + 3] = c4.w;
          sv[k] = s4.x; sv[k + 1] = s4.y; sv[k + 2] = s4.z; sv[k + 3] = s4.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          cv[k] = ct[j + k];
          sv[k] = st[j + k];
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) sv[k] = p.sign * sv[k];
      for (int h0 = threadIdx.y; h0 < heads; h0 += step) {
        const int h1 = h0 + (int)blockDim.y;
        const bool two = h1 < heads;
        const T *x0, *x1 = nullptr;
        T *y0, *y1 = nullptr;
        locate<T, I>(p, bi, si, pos, h0, &x0, &y0);
        if (two) locate<T, I>(p, bi, si, pos, h1, &x1, &y1);
        float a1[VEC], a2[VEC], b1[VEC], b2[VEC];
        apex::load_f<T, VEC>(x0 + j, a1);
        apex::load_f<T, VEC>(x0 + j + p.half, a2);
        if (two) {
          apex::load_f<T, VEC>(x1 + j, b1);
          apex::load_f<T, VEC>(x1 + j + p.half, b2);
        }
        rotate_store<T, VEC>(y0, j, p.half, a1, a2, cv, sv);
        if (two) rotate_store<T, VEC>(y1, j, p.half, b1, b2, cv, sv);
      }
    } else {
      // the tail of a partial rotary span passes through, as raw bits
      using Bits = apex::Pack<T, VEC>;
      const int j = 2 * p.half + (c - p.nrot) * VEC;
      for (int h0 = threadIdx.y; h0 < heads; h0 += step) {
        const int h1 = h0 + (int)blockDim.y;
        const bool two = h1 < heads;
        const T *x0, *x1 = nullptr;
        T *y0, *y1 = nullptr;
        locate<T, I>(p, bi, si, pos, h0, &x0, &y0);
        if (two) locate<T, I>(p, bi, si, pos, h1, &x1, &y1);
        const Bits r0 = *reinterpret_cast<const Bits*>(x0 + j);
        Bits r1;
        if (two) r1 = *reinterpret_cast<const Bits*>(x1 + j);
        *reinterpret_cast<Bits*>(y0 + j) = r0;
        if (two) *reinterpret_cast<Bits*>(y1 + j) = r1;
      }
    }
  }
}

apex::Magic magic_of(uint32_t d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return apex::Magic{(uint32_t)m, l};
}

// Calls f((T*)nullptr, integral_constant<VEC>, I{}) for dtype code xt,
// vector width vec and index width; false for a pair dispatch_vec lacks.
template <typename F>
bool dispatch(int xt, int vec, int idx64, F&& f) {
  return apex::dispatch_vec(xt, vec, [&](auto tp, auto v) {
    if (idx64) f(tp, v, (long long)0);
    else f(tp, v, (int)0);
  });
}

}  // namespace

// Rotate operand a and, when heads_b > 0, operand b, both of (batch, seq)
// positions and head_dim d, in one launch.  Operand x_*: element strides
// sb, ss, sg, sr of its (batch, seq, heads / rep, rep, d) view (channels
// contiguous; rep = 1 for a (batch, seq, heads, d) tensor); y_*: its
// (batch, seq, heads, d) contiguous output.  cos, sin: float32 (seq, half)
// or, with per_row, (batch, seq, half), contiguous; sign -1 rotates by
// -theta.  vec: 16 / itemsize when every pointer, stride, half and d
// keeps 16-byte vectors whole (and the tables 16-byte aligned), else 1;
// idx64: an operand's offsets reach 2^31.
extern "C" int apex_rope(const void* xa, void* ya, long long sba,
                         long long ssa, long long sga, long long sra,
                         int heads_a, int rep_a, const void* xb, void* yb,
                         long long sbb, long long ssb, long long sgb,
                         long long srb, int heads_b, int rep_b,
                         const void* cos_t, const void* sin_t, int batch,
                         int seq, int d, int half, int per_row, float sign,
                         int xt, int vec, int idx64, void* stream) {
  Params p{};
  p.a = Operand{xa, ya, sba, ssa, sga, sra, heads_a, rep_a,
                magic_of((uint32_t)rep_a)};
  p.b = Operand{xb, yb, sbb, ssb, sgb, srb, heads_b, heads_b ? rep_b : 1,
                magic_of((uint32_t)(heads_b ? rep_b : 1))};
  p.cos = (const float*)cos_t;
  p.sin = (const float*)sin_t;
  p.seq = seq;
  p.d = d;
  p.half = half;
  p.per_row = per_row;
  p.sign = sign;
  p.nrot = half / vec;
  p.nchunks = p.nrot + (d - 2 * half) / vec;
  // a block: bx vectors of a head by by heads (two heads a thread) by bz
  // positions, 256 threads or fewer
  const int heads = heads_a + heads_b;
  const int bx = p.nchunks < kThreads ? p.nchunks : kThreads;
  int by = kThreads / bx;
  if (by > (heads + 1) / 2) by = (heads + 1) / 2;
  if (by < 1) by = 1;
  int bz = kThreads / (bx * by);
  if (bz > seq) bz = seq;
  if (bz < 1) bz = 1;
  p.nsb = (seq + bz - 1) / bz;
  p.sblocks = magic_of((uint32_t)p.nsb);
  const unsigned blocks = (unsigned)batch * (unsigned)p.nsb;
  const dim3 block(bx, by, bz);
  cudaStream_t st = (cudaStream_t)stream;
  const bool known = dispatch(xt, vec, idx64, [&](auto tp, auto v, auto i) {
    using T = std::remove_pointer_t<decltype(tp)>;
    rope_kernel<T, decltype(v)::value, decltype(i)>
        <<<blocks, block, 0, st>>>(p);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The variant (xt, vec, idx64): the blocks of `threads` threads that one
// multiprocessor holds at once, and its registers a thread.
extern "C" int apex_rope_occupancy(int xt, int vec, int idx64, int threads,
                                   int* blocks, int* regs) {
  cudaError_t err = cudaErrorInvalidValue;
  dispatch(xt, vec, idx64, [&](auto tp, auto v, auto i) {
    using T = std::remove_pointer_t<decltype(tp)>;
    auto fn = rope_kernel<T, decltype(v)::value, decltype(i)>;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    *regs = attr.numRegs;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                          0);
  });
  return (int)err;
}
