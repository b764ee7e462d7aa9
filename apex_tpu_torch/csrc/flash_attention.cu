// Flash attention: forward, and the backward's dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels of apex_tpu/ops/attention.py:
//   _fa_fwd_kernel (:367)      -> fa_fwd_kernel:  o and the log2-domain
//                                 logsumexp per query row (online softmax);
//   _fa_bwd_dq_kernel (:577)   -> fa_bwd_dq_kernel:  dq, probabilities
//                                 recomputed from the saved logsumexp;
//   _fa_bwd_dkv_kernel (:649)  -> fa_bwd_dkv_kernel: dk, dv per query
//                                 head (GQA groups are summed afterwards
//                                 in fp32, in a fixed order, by the
//                                 wrapper — as the JAX wrapper does).
// They take the features of the Pallas kernels: an additive fp32 bias
// broadcast as (b|1, h|1, sq|1, sk) through element strides (0 on a
// broadcast axis); causal masking with the rectangular sk - sq offset;
// the sliding window; GQA, where rep consecutive query heads read one kv
// head; attention-probability dropout through the counter hash of
// _keep_from_counters (:84), bit for bit (murmur3 fmix32 over uint32);
// and the dead-row convention (_zero_dead, :358): a score below half the
// -1e30 sentinel gets probability exactly 0, so a row with no visible
// key outputs zeros and a backward through it stays finite.  Softmax
// runs in the log2 domain (exp2) and the saved logsumexp is log2-domain;
// it never leaves this fwd/bwd pair.  Ragged tiles are masked, so any sq
// and sk are taken; head_dim up to 128.
//
// Layout: q, o, dO, dq are (b, sq, h, d) and k, v, dk, dv (b, sk, hk, d),
// the JAX layout (BSHD), read in place with row stride heads * d.  lse
// and delta are (b * h, sq) float32, lane = batch * h + head.
//
// What bounds them on an H100: at BERT-Large (s = 512, d = 64) the
// products — 4 * b * h * sq * sk * d flops forward, 8 * ... backward —
// against a few hundred bytes per query row: operations, far above the
// 295 flop/byte ridge of the tensor cores.  Design: one block per (lane,
// 64-row tile), with a loop over the other operand's 64-row tiles in
// place of the TPU's sequential grid axis.  Two paths, chosen by what
// the inputs allow: bf16/fp16 inputs with head_dim 64 or 128 run the
// products on the tensor cores (WMMA, below; wgmma with TMA is later
// work); fp32 inputs and other head dims run them as fp32 FMA on the
// CUDA cores.  In the latter, tiles are converted to fp32 in shared
// memory (row stride d + 1, so the column reads of the score product hit
// 16 different banks); each of 256 threads owns a 4 x 4 block of the
// 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and of the
// 64 x d accumulators; row maxima and sums reduce over the 16 lanes of a
// half warp.  Softmax, masking and dropout are fp32 in both; a
// probability or dS that feeds the next product is rounded to the input
// dtype first, as in the Pallas kernels.  Outputs are written in the
// input dtype.  Every sum runs in a fixed order, and the backward uses no
// atomics, so reruns are bit-identical.  Tiles that the causal or window
// mask kills entirely are skipped.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows of every tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLdS = kT + 1;     // row stride of the score tiles in smem
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;             // null: no bias
  long long bias_sb, bias_sh, bias_sq;
  int b, h, hk, sq, sk, d;
  float scale;
  int causal, window;            // window <= 0: none
  uint32_t seed, threshold;      // dropout: keep iff hash >= threshold
  float drop_inv;                // 1 / (1 - rate)
  int dropout;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the row stage of _keep_from_counters: fmix32(q * C + (seed ^ lane * C))
__device__ __forceinline__ uint32_t drop_row(const Params& p, uint32_t lane,
                                             int qpos) {
  const uint32_t hh = p.seed ^ (lane * 0x9E3779B9u);
  return fmix32((uint32_t)qpos * 0x9E3779B9u + hh);
}

__device__ __forceinline__ bool drop_keep(const Params& p, uint32_t row,
                                          int kpos) {
  return fmix32(row ^ ((uint32_t)kpos * 0x85EBCA6Bu)) >= p.threshold;
}

// Whether the (q0, k0) tile holds any visible position.
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0) {
  if (!p.causal) return true;
  const int off = p.sk - p.sq;
  const int q_last = min(q0 + kT, p.sq) - 1 + off;
  if (k0 > q_last) return false;
  if (p.window > 0 && k0 + kT - 1 < q0 + off - p.window + 1) return false;
  return true;
}

// rows [row0, row0 + 64) of a (seq, heads, d) slab at `src` (already
// offset to its batch and head) into fp32 smem of row stride ld; rows
// past `rows` read as zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int d) {
  for (int idx = threadIdx.x; idx < kT * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int pos = row0 + r;
    dst[r * ld + c] =
        pos < rows ? apex::to_f(src[(long long)pos * row_stride + c]) : 0.f;
  }
}

// s[i][j] = <A[ty + 16 i], B[tx + 16 j]> over the first d columns
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int ld, int d,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// a q.k product -> its log2-domain score with the bias, the causal and
// window masks and the ragged edges at the -1e30 sentinel (a query row
// past sq is all dead)
__device__ __forceinline__ float score_at(const Params& p, float raw,
                                          int batch, int head, int qpos,
                                          int kpos) {
  const int off = p.sk - p.sq;
  float v = raw * (p.scale * kLog2e);
  bool dead = qpos >= p.sq || kpos >= p.sk;
  if (!dead && p.bias != nullptr)
    v += p.bias[(long long)batch * p.bias_sb + (long long)head * p.bias_sh +
                (long long)qpos * p.bias_sq + kpos] * kLog2e;
  if (p.causal) {
    dead = dead || kpos > qpos + off;
    if (p.window > 0) dead = dead || kpos <= qpos + off - p.window;
  }
  return dead ? kNegInf : v;
}

__device__ __forceinline__ void finish_scores(float (&s)[4][4],
                                              const Params& p, int batch,
                                              int head, int q0, int k0,
                                              int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = score_at(p, s[i][j], batch, head, q0 + ty + 16 * i,
                         k0 + tx + 16 * j);
}

// a probability or gradient rounded to the input dtype, as the operand
// of the next product (the Pallas kernels feed the MXU in that dtype);
// the identity for float
template <typename T>
__device__ __forceinline__ float as_operand(float v) {
  return apex::to_f(apex::from_f<T>(v));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(apex::kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(apex::kFull, v, o);
  return v;
}

// exp2(s - m), exactly 0 at a dead position
__device__ __forceinline__ float prob(float s, float m) {
  return s < 0.5f * kNegInf ? 0.f : exp2f(s - m);
}

// ------------------------------------------------------------------ //
// forward
// ------------------------------------------------------------------ //
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(Params p, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Qs = smem;
  float* Ks = Qs + kT * ld;
  float* Vs = Ks + kT * ld;
  float* Ps = Vs + kT * ld;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const T* qb = (const T*)p.q + (long long)batch * p.sq * qstride + (long long)head * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Qs, ld, qb, qstride, q0, p.sq, d);

  float m[4], l[4], acc[4][DC];
  uint32_t drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    drow[i] = p.dropout ? drop_row(p, (uint32_t)lane, q0 + ty + 16 * i) : 0u;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.sk; k0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile(Ks, ld, kb, kstride, k0, p.sk, d);
    load_tile(Vs, ld, vb, kstride, k0, p.sk, d);
    __syncthreads();
    float s[4][4];
    tile_dot(s, Qs, Ks, ld, d, ty, tx);
    finish_scores(s, p, batch, head, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float pr[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[j] = prob(s[i][j], m_new);
        rs += pr[j];
      }
      // the normaliser takes the undropped probabilities; only the
      // value accumulation sees the dropped, rescaled ones
      l[i] = l[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = pr[j];
        if (p.dropout)
          pv = drop_keep(p, drow[i], k0 + tx + 16 * j) ? pv * p.drop_inv : 0.f;
        Ps[(ty + 16 * i) * kLdS + tx + 16 * j] = as_operand<T>(pv);
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    for (int kk = 0; kk < kT; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < d ? Vs[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * kLdS + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (long long)batch * p.sq * qstride + row * qstride + (long long)head * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = apex::from_f<T>(acc[i][j] / ls);
    }
    if (tx == 0) lse[(long long)lane * p.sq + row] = m[i] + log2f(ls);
  }
}

// ------------------------------------------------------------------ //
// backward: dq
// ------------------------------------------------------------------ //
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(Params p, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq) {
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Qs = smem;
  float* dOs = Qs + kT * ld;
  float* Ks = dOs + kT * ld;
  float* Vs = Ks + kT * ld;
  float* Ds = Vs + kT * ld;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d);
  load_tile(dOs, ld, dout + qoff, qstride, q0, p.sq, d);

  float lr[4], dr[4], acc[4][DC];
  uint32_t drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < p.sq ? lse[(long long)lane * p.sq + row] : 0.f;
    dr[i] = row < p.sq ? delta[(long long)lane * p.sq + row] : 0.f;
    drow[i] = p.dropout ? drop_row(p, (uint32_t)lane, row) : 0u;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.sk; k0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile(Ks, ld, kb, kstride, k0, p.sk, d);
    load_tile(Vs, ld, vb, kstride, k0, p.sk, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, ld, d, ty, tx);
    finish_scores(s, p, batch, head, q0, k0, ty, tx);
    tile_dot(dp, dOs, Vs, ld, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float g = dp[i][j];
        if (p.dropout)
          g = drop_keep(p, drow[i], k0 + tx + 16 * j) ? g * p.drop_inv : 0.f;
        // dS = P * (dP - delta); delta = rowsum(dO . O) already holds
        // the dropout factor
        Ds[(ty + 16 * i) * kLdS + tx + 16 * j] =
            as_operand<T>(prob(s[i][j], lr[i]) * (g - dr[i]));
      }
    __syncthreads();
    for (int kk = 0; kk < kT; ++kk) {
      float kv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < d ? Ks[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = Ds[(ty + 16 * i) * kLdS + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(g, kv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    T* out = dq + qoff + row * qstride;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) out[c] = apex::from_f<T>(acc[i][j] * p.scale);
    }
  }
}

// ------------------------------------------------------------------ //
// backward: dk, dv per query head
// ------------------------------------------------------------------ //
template <typename T, typename TO, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(Params p, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, TO* __restrict__ dk,
                  TO* __restrict__ dv) {
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Ks = smem;
  float* Vs = Ks + kT * ld;
  float* Qs = Vs + kT * ld;
  float* dOs = Qs + kT * ld;
  float* Ps = dOs + kT * ld;
  float* Ds = Ps + kT * kLdS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int k0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
  const long long koff = (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Ks, ld, (const T*)p.k + koff, kstride, k0, p.sk, d);
  load_tile(Vs, ld, (const T*)p.v + koff, kstride, k0, p.sk, d);

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int q0 = 0; q0 < p.sq; q0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d);
    load_tile(dOs, ld, dout + qoff, qstride, q0, p.sq, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, ld, d, ty, tx);
    finish_scores(s, p, batch, head, q0, k0, ty, tx);
    tile_dot(dp, dOs, Vs, ld, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      const float lr = row < p.sq ? lse[(long long)lane * p.sq + row] : 0.f;
      const float dr = row < p.sq ? delta[(long long)lane * p.sq + row] : 0.f;
      const uint32_t drow = p.dropout ? drop_row(p, (uint32_t)lane, row) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = prob(s[i][j], lr);
        float pd = pr, g = dp[i][j];
        if (p.dropout) {
          const bool keep = drop_keep(p, drow, k0 + tx + 16 * j);
          pd = keep ? pr * p.drop_inv : 0.f;
          g = keep ? g * p.drop_inv : 0.f;
        }
        Ps[(ty + 16 * i) * kLdS + tx + 16 * j] = as_operand<T>(pd);
        Ds[(ty + 16 * i) * kLdS + tx + 16 * j] = as_operand<T>(pr * (g - dr));
      }
    }
    __syncthreads();
    // dV[key] += sum_q Pd[q][key] dO[q];  dK[key] += sum_q dS[q][key] Q[q]
    for (int qq = 0; qq < kT; ++qq) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        dov[j] = c < d ? dOs[qq * ld + c] : 0.f;
        qv[j] = c < d ? Qs[qq * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pd = Ps[qq * kLdS + ty + 16 * i];
        const float g = Ds[qq * kLdS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          adv[i][j] = fmaf(pd, dov[j], adv[i][j]);
          adk[i][j] = fmaf(g, qv[j], adk[i][j]);
        }
      }
    }
  }
  // outputs (b, sk, h, d): one slab per query head
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.sk) continue;
    const long long base = (((long long)batch * p.sk + key) * p.h + head) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[base + c] = apex::from_f<TO>(adk[i][j] * p.scale);
        dv[base + c] = apex::from_f<TO>(adv[i][j]);
      }
    }
  }
}


// ------------------------------------------------------------------ //
// tensor-core path: bf16 / fp16 inputs, head_dim 64 or 128
// ------------------------------------------------------------------ //
// The same three functions with the products on the tensor cores
// (WMMA 16x16x16, fp32 accumulation): one block of 4 warps per 64-row
// tile, each warp owning 16 rows.  Tiles stay in the input dtype in
// shared memory (row stride d + 8); a warp's score products land in an
// fp32 tile, the masking / online softmax / dropout / dS step is the
// scalar code above (two lanes per row, 32 columns each), and its
// probabilities and dS are written in the input dtype as the next
// product's operand — the rounding the Pallas kernels and the scalar
// path make too.  The forward keeps its output accumulator in shared
// memory so the scalar step can rescale it; the backward accumulates dq,
// dk and dv in WMMA fragments.

constexpr int kTcThreads = 128;    // 4 warps x 16 rows

// The scalar step gives each row of a warp's 16 two lanes (half = 0, 1),
// which take the even and odd columns; rows 8-15 walk their columns
// rotated by one pair.  With row strides of 4 (mod 32) words, the 32
// lanes then touch 32 different banks at every step.
__device__ __forceinline__ int tc_col(int c, int n, int rot, int half) {
  return 2 * ((c + rot) & (n - 1)) + half;
}
constexpr int kLdF = kT + 4;       // fp32 score tile row stride
constexpr int kLdH = kT + 8;       // half score tile row stride

using namespace nvcuda;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <typename T>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
template <typename T, typename L>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, L>;

// rows [row0, row0 + 64) of a (seq, heads, d) slab into smem of row
// stride ld in the input dtype, 16 bytes per thread; rows past `rows`
// read as zero (d % 8 == 0)
template <typename T>
__device__ __forceinline__ void load_tile_h(T* dst, int ld, const T* src,
                                            long long row_stride, int row0,
                                            int rows, int d) {
  const int vpr = d / 8;
  for (int idx = threadIdx.x; idx < kT * vpr; idx += kTcThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    const int pos = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pos < rows)
      v = *reinterpret_cast<const uint4*>(src + (long long)pos * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// out[16 x 64] (fp32, row stride kLdF) = A[16 x d] . B[64 x d]^T
template <typename T, int DC>
__device__ __forceinline__ void warp_abt(float* out, const T* a, const T* b,
                                         int ld) {
  FragA<T> fa[DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) wmma::load_matrix_sync(fa[k], a + 16 * k, ld);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      FragB<T, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * ld + 16 * k, ld);
      wmma::mma_sync(acc, fa[k], fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, kLdF, wmma::mem_row_major);
  }
}

// acc[j] += A[16 x 64] (row stride kLdH) . B[64 x d] (row stride ld),
// column block j of the result
template <typename T, int DC>
__device__ __forceinline__ void warp_ab_acc(FragC (&acc)[DC], const T* a,
                                            const T* b, int ld) {
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    FragA<T> fa;
    wmma::load_matrix_sync(fa, a + kk, kLdH);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      FragB<T, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * ld + 16 * j, ld);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kTcThreads)
fa_fwd_tc_kernel(Params p, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int d = 16 * DC, ld = d + 8, ldo = d + 4;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kT * ld;
  T* Vs = Ks + kT * ld;
  T* Ps = Vs + kT * ld;
  float* Ss = reinterpret_cast<float*>(Ps + kT * kLdH);
  float* Os = Ss + kT * kLdF;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile_h(Qs, ld, (const T*)p.q + (long long)batch * p.sq * qstride +
                          (long long)head * d, qstride, q0, p.sq, d);
  for (int i = threadIdx.x; i < kT * ldo; i += kTcThreads) Os[i] = 0.f;
  // this thread's row of the tile and its half of the columns
  const int r = warp * 16 + (ln >> 1), half = ln & 1, rot = (ln >> 4) & 1;
  const int qpos = q0 + r;
  const uint32_t drow = p.dropout ? drop_row(p, (uint32_t)lane, qpos) : 0u;
  float m = kNegInf, l = 0.f;
  float* srow = Ss + r * kLdF;
  T* prow = Ps + r * kLdH;
  float* orow = Os + r * ldo;
  for (int k0 = 0; k0 < p.sk; k0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile_h(Ks, ld, kb, kstride, k0, p.sk, d);
    load_tile_h(Vs, ld, vb, kstride, k0, p.sk, d);
    __syncthreads();
    warp_abt<T, DC>(Ss + warp * 16 * kLdF, Qs + warp * 16 * ld, Ks, ld);
    __syncwarp();
    float mx = kNegInf;
    for (int c = 0; c < 32; ++c) {
      const int col = tc_col(c, 32, rot, half);
      const float v = score_at(p, srow[col], batch, head, qpos, k0 + col);
      srow[col] = v;
      mx = fmaxf(mx, v);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(apex::kFull, mx, 1)));
    const float alpha = exp2f(m - m_new);
    float rs = 0.f;
    for (int c = 0; c < 32; ++c) {
      const int col = tc_col(c, 32, rot, half);
      const float pr = prob(srow[col], m_new);
      rs += pr;
      float pv = pr;
      if (p.dropout)
        pv = drop_keep(p, drow, k0 + col) ? pr * p.drop_inv : 0.f;
      prow[col] = apex::from_f<T>(pv);
    }
    l = l * alpha + rs + __shfl_xor_sync(apex::kFull, rs, 1);
    for (int c = 0; c < d / 2; ++c) orow[tc_col(c, d / 2, rot, half)] *= alpha;
    m = m_new;
    __syncwarp();
    FragC acc[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      wmma::load_matrix_sync(acc[j], Os + warp * 16 * ldo + 16 * j, ldo,
                             wmma::mem_row_major);
    warp_ab_acc<T, DC>(acc, Ps + warp * 16 * kLdH, Vs, ld);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      wmma::store_matrix_sync(Os + warp * 16 * ldo + 16 * j, acc[j], ldo,
                              wmma::mem_row_major);
    __syncwarp();
  }
  if (qpos < p.sq) {
    const float ls = l == 0.f ? 1.f : l;
    T* out = o + (long long)batch * p.sq * qstride + qpos * qstride +
             (long long)head * d;
    for (int c = 0; c < d / 2; ++c) {
      const int col = tc_col(c, d / 2, rot, half);
      out[col] = apex::from_f<T>(orow[col] / ls);
    }
    if (half == 0) lse[(long long)lane * p.sq + qpos] = m + log2f(ls);
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dq_tc_kernel(Params p, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int d = 16 * DC, ld = d + 8, ldo = d + 4;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kT * ld;
  T* Ks = dOs + kT * ld;
  T* Vs = Ks + kT * ld;
  T* Ds = Vs + kT * ld;
  float* Ss = reinterpret_cast<float*>(Ds + kT * kLdH);
  float* DPs = Ss + kT * kLdF;
  float* stage = Ss;                 // the result, after the loop
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile_h(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d);
  load_tile_h(dOs, ld, dout + qoff, qstride, q0, p.sq, d);
  const int r = warp * 16 + (ln >> 1), half = ln & 1, rot = (ln >> 4) & 1;
  const int qpos = q0 + r;
  const float lr = qpos < p.sq ? lse[(long long)lane * p.sq + qpos] : 0.f;
  const float dr = qpos < p.sq ? delta[(long long)lane * p.sq + qpos] : 0.f;
  const uint32_t drow = p.dropout ? drop_row(p, (uint32_t)lane, qpos) : 0u;
  FragC acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < p.sk; k0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile_h(Ks, ld, kb, kstride, k0, p.sk, d);
    load_tile_h(Vs, ld, vb, kstride, k0, p.sk, d);
    __syncthreads();
    warp_abt<T, DC>(Ss + warp * 16 * kLdF, Qs + warp * 16 * ld, Ks, ld);
    warp_abt<T, DC>(DPs + warp * 16 * kLdF, dOs + warp * 16 * ld, Vs, ld);
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const int col = tc_col(c, 32, rot, half);
      const float s = score_at(p, Ss[r * kLdF + col], batch, head, qpos, k0 + col);
      float g = DPs[r * kLdF + col];
      if (p.dropout)
        g = drop_keep(p, drow, k0 + col) ? g * p.drop_inv : 0.f;
      Ds[r * kLdH + col] = apex::from_f<T>(prob(s, lr) * (g - dr));
    }
    __syncwarp();
    warp_ab_acc<T, DC>(acc, Ds + warp * 16 * kLdH, Ks, ld);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DC; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * ldo + 16 * j, acc[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  if (qpos < p.sq) {
    T* out = dq + qoff + qpos * qstride;
    const float* srow = stage + r * ldo;
    for (int c = 0; c < d / 2; ++c) {
      const int col = tc_col(c, d / 2, rot, half);
      out[col] = apex::from_f<T>(srow[col] * p.scale);
    }
  }
}

template <typename T, typename TO, int DC>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dkv_tc_kernel(Params p, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, TO* __restrict__ dk,
                     TO* __restrict__ dv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int d = 16 * DC, ld = d + 8, ldo = d + 4;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kT * ld;
  T* Qs = Vs + kT * ld;
  T* dOs = Qs + kT * ld;
  T* Pt = dOs + kT * ld;             // dropped probabilities, [key][q]
  T* Dt = Pt + kT * kLdH;            // dS, [key][q]
  float* St = reinterpret_cast<float*>(Dt + kT * kLdH);
  float* DPt = St + kT * kLdF;
  float* lse_s = DPt + kT * kLdF;
  float* delta_s = lse_s + kT;
  float* stage = St;                 // the results, after the loop
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int lane = blockIdx.y, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int k0 = blockIdx.x * kT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
  const long long koff = (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile_h(Ks, ld, (const T*)p.k + koff, kstride, k0, p.sk, d);
  load_tile_h(Vs, ld, (const T*)p.v + koff, kstride, k0, p.sk, d);
  // this thread's key row of the tile and its half of the query columns
  const int r = warp * 16 + (ln >> 1), half = ln & 1, rot = (ln >> 4) & 1;
  const int kpos = k0 + r;
  FragC adk[DC], adv[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    wmma::fill_fragment(adk[j], 0.f);
    wmma::fill_fragment(adv[j], 0.f);
  }
  for (int q0 = 0; q0 < p.sq; q0 += kT) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    load_tile_h(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d);
    load_tile_h(dOs, ld, dout + qoff, qstride, q0, p.sq, d);
    for (int i = threadIdx.x; i < kT; i += kTcThreads) {
      const int q = q0 + i;
      lse_s[i] = q < p.sq ? lse[(long long)lane * p.sq + q] : 0.f;
      delta_s[i] = q < p.sq ? delta[(long long)lane * p.sq + q] : 0.f;
    }
    __syncthreads();
    // transposed tiles: S^T = K Q^T and dP^T = V dO^T, keys on rows
    warp_abt<T, DC>(St + warp * 16 * kLdF, Ks + warp * 16 * ld, Qs, ld);
    warp_abt<T, DC>(DPt + warp * 16 * kLdF, Vs + warp * 16 * ld, dOs, ld);
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const int qi = tc_col(c, 32, rot, half), qpos = q0 + qi;
      const float s = score_at(p, St[r * kLdF + qi], batch, head, qpos, kpos);
      const float pr = prob(s, lse_s[qi]);
      float pd = pr, g = DPt[r * kLdF + qi];
      if (p.dropout) {
        const bool keep =
            drop_keep(p, drop_row(p, (uint32_t)lane, qpos), kpos);
        pd = keep ? pr * p.drop_inv : 0.f;
        g = keep ? g * p.drop_inv : 0.f;
      }
      Pt[r * kLdH + qi] = apex::from_f<T>(pd);
      Dt[r * kLdH + qi] = apex::from_f<T>(pr * (g - delta_s[qi]));
    }
    __syncwarp();
    // dV[key] += Pd^T dO;  dK[key] += dS^T Q
    warp_ab_acc<T, DC>(adv, Pt + warp * 16 * kLdH, dOs, ld);
    warp_ab_acc<T, DC>(adk, Dt + warp * 16 * kLdH, Qs, ld);
  }
  __syncthreads();
  const long long base = (((long long)batch * p.sk + kpos) * p.h + head) * d;
  const float* srow = stage + r * ldo;
#pragma unroll
  for (int j = 0; j < DC; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * ldo + 16 * j, adk[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  if (kpos < p.sk)
    for (int c = 0; c < d / 2; ++c) {
      const int col = tc_col(c, d / 2, rot, half);
      dk[base + col] = apex::from_f<TO>(srow[col] * p.scale);
    }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DC; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * ldo + 16 * j, adv[j], ldo,
                            wmma::mem_row_major);
  __syncwarp();
  if (kpos < p.sk)
    for (int c = 0; c < d / 2; ++c) {
      const int col = tc_col(c, d / 2, rot, half);
      dv[base + col] = apex::from_f<TO>(srow[col]);
    }
}

template <typename K>
int prepare(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t tiles_bytes(int d, int n_in, int n_score) {
  return ((size_t)n_in * kT * (d + 1) + (size_t)n_score * kT * kLdS) * sizeof(float);
}

template <typename T, int DC>
int fwd(const Params& p, void* o, float* lse, cudaStream_t st) {
  const size_t smem = tiles_bytes(p.d, 3, 1);
  auto kern = fa_fwd_kernel<T, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sq + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kThreads, smem, st>>>(p, (T*)o, lse);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int bwd_dq(const Params& p, const void* dout, const float* lse,
           const float* delta, void* dq, cudaStream_t st) {
  const size_t smem = tiles_bytes(p.d, 4, 1);
  auto kern = fa_bwd_dq_kernel<T, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sq + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kThreads, smem, st>>>(p, (const T*)dout, lse, delta, (T*)dq);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int DC>
int bwd_dkv(const Params& p, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, cudaStream_t st) {
  const size_t smem = tiles_bytes(p.d, 4, 2);
  auto kern = fa_bwd_dkv_kernel<T, TO, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sk + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kThreads, smem, st>>>(p, (const T*)dout, lse, delta, (TO*)dk,
                                     (TO*)dv);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int fwd_tc(const Params& p, void* o, float* lse, cudaStream_t st) {
  constexpr int d = 16 * DC, ld = d + 8;
  const size_t smem = (3 * kT * ld + kT * kLdH) * sizeof(T) +
                      (kT * kLdF + kT * (d + 4)) * sizeof(float);
  auto kern = fa_fwd_tc_kernel<T, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sq + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kTcThreads, smem, st>>>(p, (T*)o, lse);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int bwd_dq_tc(const Params& p, const void* dout, const float* lse,
              const float* delta, void* dq, cudaStream_t st) {
  constexpr int d = 16 * DC, ld = d + 8;
  const size_t smem = (4 * kT * ld + kT * kLdH) * sizeof(T) +
                      2 * kT * kLdF * sizeof(float);
  auto kern = fa_bwd_dq_tc_kernel<T, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sq + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kTcThreads, smem, st>>>(p, (const T*)dout, lse, delta, (T*)dq);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int DC>
int bwd_dkv_tc(const Params& p, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, cudaStream_t st) {
  constexpr int d = 16 * DC, ld = d + 8;
  const size_t smem = (4 * kT * ld + 2 * kT * kLdH) * sizeof(T) +
                      (2 * kT * kLdF + 2 * kT) * sizeof(float);
  auto kern = fa_bwd_dkv_tc_kernel<T, TO, DC>;
  int e = prepare(kern, smem);
  if (e) return e;
  dim3 grid((p.sk + kT - 1) / kT, p.b * p.h);
  kern<<<grid, kTcThreads, smem, st>>>(p, (const T*)dout, lse, delta, (TO*)dk,
                                       (TO*)dv);
  return (int)cudaGetLastError();
}

// the tensor-core kernels take half inputs with head_dim 64 or 128
bool use_tc(int dt, int d) { return dt != apex::kF32 && (d == 64 || d == 128); }

Params make_params(const void* q, const void* k, const void* v,
                   const void* bias, long long bsb, long long bsh,
                   long long bsq, int b, int h, int hk, int sq, int sk, int d,
                   float scale, int causal, int window, unsigned seed,
                   unsigned threshold, float drop_inv, int dropout) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = (const float*)bias;
  p.bias_sb = bsb;
  p.bias_sh = bsh;
  p.bias_sq = bsq;
  p.b = b;
  p.h = h;
  p.hk = hk;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.seed = seed;
  p.threshold = threshold;
  p.drop_inv = drop_inv;
  p.dropout = dropout;
  return p;
}

}  // namespace

#define APEX_FA_PARAMS                                                        \
  const void *q, const void *k, const void *v, const void *bias,              \
      long long bsb, long long bsh, long long bsq, int b, int h, int hk,      \
      int sq, int sk, int d, float scale, int causal, int window,             \
      unsigned seed, unsigned threshold, float drop_inv, int dropout, int dt
#define APEX_FA_ARGS                                                          \
  make_params(q, k, v, bias, bsb, bsh, bsq, b, h, hk, sq, sk, d, scale,      \
              causal, window, seed, threshold, drop_inv, dropout)

// Common arguments: q (b, sq, h, d), k and v (b, sk, hk, d), contiguous in
// dtype dt; bias float32 with element strides (bsb, bsh, bsq, 1) over
// (b, h, sq, sk), 0 on a broadcast axis, or null; scale the softmax
// scale; window <= 0 for none; dropout with keep iff hash >= threshold
// and kept probabilities times drop_inv.  d <= 128.

// o like q; lse (b * h, sq) float32, log2 domain.
extern "C" int apex_fa_fwd(APEX_FA_PARAMS, void* o, void* lse, void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  const bool wide = d > 64;
  if (use_tc(dt, d)) {
    if (dt == apex::kBF16)
      return wide ? fwd_tc<__nv_bfloat16, 8>(p, o, l, st) : fwd_tc<__nv_bfloat16, 4>(p, o, l, st);
    return wide ? fwd_tc<__half, 8>(p, o, l, st) : fwd_tc<__half, 4>(p, o, l, st);
  }
  switch (dt) {
    case apex::kF32: return wide ? fwd<float, 8>(p, o, l, st) : fwd<float, 4>(p, o, l, st);
    case apex::kBF16: return wide ? fwd<__nv_bfloat16, 8>(p, o, l, st) : fwd<__nv_bfloat16, 4>(p, o, l, st);
    default: return wide ? fwd<__half, 8>(p, o, l, st) : fwd<__half, 4>(p, o, l, st);
  }
}

// dout, dq like q; lse from apex_fa_fwd; delta (b * h, sq) float32 =
// rowsum(dout * o).
extern "C" int apex_fa_bwd_dq(APEX_FA_PARAMS, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  const bool wide = d > 64;
  if (use_tc(dt, d)) {
    if (dt == apex::kBF16)
      return wide ? bwd_dq_tc<__nv_bfloat16, 8>(p, dout, l, dl, dq, st)
                  : bwd_dq_tc<__nv_bfloat16, 4>(p, dout, l, dl, dq, st);
    return wide ? bwd_dq_tc<__half, 8>(p, dout, l, dl, dq, st)
                : bwd_dq_tc<__half, 4>(p, dout, l, dl, dq, st);
  }
  switch (dt) {
    case apex::kF32: return wide ? bwd_dq<float, 8>(p, dout, l, dl, dq, st) : bwd_dq<float, 4>(p, dout, l, dl, dq, st);
    case apex::kBF16: return wide ? bwd_dq<__nv_bfloat16, 8>(p, dout, l, dl, dq, st) : bwd_dq<__nv_bfloat16, 4>(p, dout, l, dl, dq, st);
    default: return wide ? bwd_dq<__half, 8>(p, dout, l, dl, dq, st) : bwd_dq<__half, 4>(p, dout, l, dl, dq, st);
  }
}

// dk, dv (b, sk, h, d) per query head: float32 when out_f32 (GQA: the
// wrapper sums each group of rep heads), else in dtype dt.
extern "C" int apex_fa_bwd_dkv(APEX_FA_PARAMS, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, int out_f32, void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  const bool wide = d > 64;
#define APEX_DKV(T, TO)                                                 \
  return wide ? bwd_dkv<T, TO, 8>(p, dout, l, dl, dk, dv, st)           \
              : bwd_dkv<T, TO, 4>(p, dout, l, dl, dk, dv, st)
#define APEX_DKV_TC(T, TO)                                              \
  return wide ? bwd_dkv_tc<T, TO, 8>(p, dout, l, dl, dk, dv, st)        \
              : bwd_dkv_tc<T, TO, 4>(p, dout, l, dl, dk, dv, st)
  if (use_tc(dt, d)) {
    if (dt == apex::kBF16) {
      if (out_f32) APEX_DKV_TC(__nv_bfloat16, float);
      APEX_DKV_TC(__nv_bfloat16, __nv_bfloat16);
    }
    if (out_f32) APEX_DKV_TC(__half, float);
    APEX_DKV_TC(__half, __half);
  }
  switch (dt) {
    case apex::kF32: APEX_DKV(float, float);
    case apex::kBF16:
      if (out_f32) APEX_DKV(__nv_bfloat16, float);
      APEX_DKV(__nv_bfloat16, __nv_bfloat16);
    default:
      if (out_f32) APEX_DKV(__half, float);
      APEX_DKV(__half, __half);
  }
#undef APEX_DKV
#undef APEX_DKV_TC
}
