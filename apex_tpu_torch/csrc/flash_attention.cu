// Flash attention: forward, and the backward's dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels of apex_tpu/ops/attention.py:
//   _fa_fwd_kernel (:367)      -> o and the log2-domain logsumexp per
//                                 query row (online softmax);
//   _fa_bwd_dq_kernel (:577)   -> dq, probabilities recomputed from the
//                                 saved logsumexp;
//   _fa_bwd_dkv_kernel (:649)  -> dk, dv, the GQA group of rep query
//                                 heads summed in the kernel's fp32
//                                 accumulators, in a fixed order.
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
// and sk are taken; head_dim up to 256 (a multiple of 8), and any batch *
// heads (the FMA kernels number their blocks on grid.x; the Hopper
// kernels' items are an int).
//
// Layout: q, o, dO, dq are (b, sq, h, d) and k, v, dk, dv (b, sk, hk, d),
// the JAX layout (BSHD), read in place with row stride heads * d.  lse
// and delta are (b * h, sq) float32, lane = batch * h + head.
//
// What bounds them on an H100: at BERT-Large (b 16, s 512, h 16, d 64)
// the products — 4 * b * h * sq * sk * d flops forward, 8 * ... backward
// (dq 3 of its 4 products and dk/dv 4, since each recomputes S) — against
// a few hundred bytes per query row: operations, far above the 295
// flop/byte ridge of the tensor cores, so the tensor cores' rate is the
// bound (at this size the forward's bound is still its bytes, 0.020 ms).
// Two paths, chosen by what the inputs allow:
//
// (1) bf16/fp16 inputs: the forward at head_dim 64 and 128, dq and dk/dv
//     at 64, 80 and 128 (use_tc; apex_fa_route reports the choice) run
//     Hopper kernels (fa_fwd_wgmma_kernel, fa_bwd_dq_wgmma_kernel,
//     fa_bwd_dkv_wgmma_kernel; sm_90a).  A Hopper kernel's rate needs
//     wgmma on register accumulators fed by asynchronous loads.  Tiles
//     arrive by TMA (tensor maps over the BSHD tensors, positions past
//     the end read as zero; panels of 64 columns with the 128-byte
//     swizzle, or at head_dim 80 of 16 columns with the 32-byte swizzle:
//     panel_cols) into a ring of two stages that a producer warp keeps
//     full, so loads overlap the products; the grid is persistent, so
//     they also overlap the previous work item's end.  The products are
//     wgmma with fp32 accumulators in registers, and every softmax, mask
//     and dropout step works on those registers in the accumulator layout
//     (a row across a quad of lanes: two shuffles per reduction).  Probabilities and dS
//     are rounded to the input dtype in registers and enter the next
//     product as its register A operand, so nothing but the loaded tiles
//     touches shared memory.  Bias, causal/window and dropout are
//     compile-time variants, and the causal / window / ragged-edge masks
//     run only on the tiles that straddle an edge (the live tile range is
//     worked out up front), so BERT's path (no mask, no dropout) has no
//     per-element branch; a key-padding bias is read once per column.
//     At BERT-Large the forward's bound is its bytes, dq's its three
//     products and dk/dv's its four; what holds each above its bound (the
//     exp2 per score, an item of only four key tiles) is not measured.
//     At ViT's 257 rows (two tiles of 128 and one row) the backward's
//     bound is its bytes, and the ragged last tile is the waste.  See the
//     notes at each kernel for its tiling.
// (2) fp32 inputs, the forward at other head dims, dq and dk/dv at head
//     dims other than 64, 80 and 128: fp32 FMA on the CUDA cores.
//     Tiles are converted to fp32 in shared memory (row stride d + 1, so
//     the column reads of the score product hit 16 different banks);
//     each of 256 threads owns a 4 x 4 block of the 64 x 64 score tile
//     (rows ty + 16 i, columns tx + 16 j) and of the 64 x d accumulators;
//     row maxima and sums reduce over the 16 lanes of a half warp.  Above
//     head_dim 128 the tiles are 32 rows (2 x 2 a thread), so that dq's
//     and dk/dv's fp32 tiles fit the 227 KB of shared memory.
//
// Softmax, masking and dropout are fp32 in all; a probability or dS that
// feeds the next product is rounded to the input dtype first, as in the
// Pallas kernels.  Outputs are written in the input dtype.  Every sum
// runs in a fixed order, and no kernel uses atomics, so reruns are
// bit-identical.  Tiles that the causal or window mask kills entirely
// are skipped.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;           // rows of a tile (32 above head_dim 128)
constexpr int kThreads = 256;    // 16 x 16 threads
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

// Whether the tile of queries [q0, q0 + nq) and keys [k0, k0 + nk) holds
// any visible position.
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0,
                                          int nq = kT, int nk = kT) {
  if (!p.causal) return true;
  const int off = p.sk - p.sq;
  const int q_last = min(q0 + nq, p.sq) - 1 + off;
  if (k0 > q_last) return false;
  if (p.window > 0 && k0 + nk - 1 < q0 + off - p.window + 1) return false;
  return true;
}

// rows [row0, row0 + n) of a (seq, heads, d) slab at `src` (already
// offset to its batch and head) into fp32 smem of row stride ld; rows
// past `rows` read as zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int d, int n = kT) {
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int pos = row0 + r;
    dst[r * ld + c] =
        pos < rows ? apex::to_f(src[(long long)pos * row_stride + c]) : 0.f;
  }
}

// s[i][j] = <A[ty + 16 i], B[tx + 16 j]> over the first d columns
template <int R>
__device__ __forceinline__ void tile_dot(float (&s)[R][R], const float* A,
                                         const float* B, int ld, int d,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[R], bb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < R; ++j) bb[j] = B[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
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

template <int R>
__device__ __forceinline__ void finish_scores(float (&s)[R][R],
                                              const Params& p, int batch,
                                              int head, int q0, int k0,
                                              int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
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
// The FMA kernels are built at a tile of TT = 16 R rows (R = 4 up to
// head_dim 128, R = 2 above, so that the fp32 tiles of head_dim 256 fit
// the shared memory) and DC = ceil(d / 16) accumulator columns a thread.
// Blocks are numbered over (lane, tile) on grid.x, so any batch * heads
// runs.
template <typename T, int DC, int R>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(Params p, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int TT = 16 * R, LdS = TT + 1;
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Qs = smem;
  float* Ks = Qs + TT * ld;
  float* Vs = Ks + TT * ld;
  float* Ps = Vs + TT * ld;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ntq = (p.sq + TT - 1) / TT;
  const int lane = blockIdx.x / ntq, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = (blockIdx.x - lane * ntq) * TT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const T* qb = (const T*)p.q + (long long)batch * p.sq * qstride + (long long)head * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Qs, ld, qb, qstride, q0, p.sq, d, TT);

  float m[R], l[R], acc[R][DC];
  uint32_t drow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    drow[i] = p.dropout ? drop_row(p, (uint32_t)lane, q0 + ty + 16 * i) : 0u;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.sk; k0 += TT) {
    if (!tile_live(p, q0, k0, TT, TT)) continue;
    __syncthreads();
    load_tile(Ks, ld, kb, kstride, k0, p.sk, d, TT);
    load_tile(Vs, ld, vb, kstride, k0, p.sk, d, TT);
    __syncthreads();
    float s[R][R];
    tile_dot<R>(s, Qs, Ks, ld, d, ty, tx);
    finish_scores<R>(s, p, batch, head, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < R; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float pr[R], rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pr[j] = prob(s[i][j], m_new);
        rs += pr[j];
      }
      // the normaliser takes the undropped probabilities; only the
      // value accumulation sees the dropped, rescaled ones
      l[i] = l[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float pv = pr[j];
        if (p.dropout)
          pv = drop_keep(p, drow[i], k0 + tx + 16 * j) ? pv * p.drop_inv : 0.f;
        Ps[(ty + 16 * i) * LdS + tx + 16 * j] = as_operand<T>(pv);
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    for (int kk = 0; kk < TT; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < d ? Vs[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pv = Ps[(ty + 16 * i) * LdS + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
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
template <typename T, int DC, int R>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(Params p, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq) {
  constexpr int TT = 16 * R, LdS = TT + 1;
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Qs = smem;
  float* dOs = Qs + TT * ld;
  float* Ks = dOs + TT * ld;
  float* Vs = Ks + TT * ld;
  float* Ds = Vs + TT * ld;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ntq = (p.sq + TT - 1) / TT;
  const int lane = blockIdx.x / ntq, batch = lane / p.h, head = lane % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = (blockIdx.x - lane * ntq) * TT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
  const T* kb = (const T*)p.k + (long long)batch * p.sk * kstride + (long long)kvh * d;
  const T* vb = (const T*)p.v + (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d, TT);
  load_tile(dOs, ld, dout + qoff, qstride, q0, p.sq, d, TT);

  float lr[R], dr[R], acc[R][DC];
  uint32_t drow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < p.sq ? lse[(long long)lane * p.sq + row] : 0.f;
    dr[i] = row < p.sq ? delta[(long long)lane * p.sq + row] : 0.f;
    drow[i] = p.dropout ? drop_row(p, (uint32_t)lane, row) : 0u;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < p.sk; k0 += TT) {
    if (!tile_live(p, q0, k0, TT, TT)) continue;
    __syncthreads();
    load_tile(Ks, ld, kb, kstride, k0, p.sk, d, TT);
    load_tile(Vs, ld, vb, kstride, k0, p.sk, d, TT);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<R>(s, Qs, Ks, ld, d, ty, tx);
    finish_scores<R>(s, p, batch, head, q0, k0, ty, tx);
    tile_dot<R>(dp, dOs, Vs, ld, d, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float g = dp[i][j];
        if (p.dropout)
          g = drop_keep(p, drow[i], k0 + tx + 16 * j) ? g * p.drop_inv : 0.f;
        // dS = P * (dP - delta); delta = rowsum(dO . O) already holds
        // the dropout factor
        Ds[(ty + 16 * i) * LdS + tx + 16 * j] =
            as_operand<T>(prob(s[i][j], lr[i]) * (g - dr[i]));
      }
    __syncthreads();
    for (int kk = 0; kk < TT; ++kk) {
      float kv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < d ? Ks[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float g = Ds[(ty + 16 * i) * LdS + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(g, kv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
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
// backward: dk, dv, the GQA group summed in the accumulators
// ------------------------------------------------------------------ //
template <typename T, int DC, int R>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(Params p, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv) {
  constexpr int TT = 16 * R, LdS = TT + 1;
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* Ks = smem;
  float* Vs = Ks + TT * ld;
  float* Qs = Vs + TT * ld;
  float* dOs = Qs + TT * ld;
  float* Ps = dOs + TT * ld;
  float* Ds = Ps + TT * LdS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ntk = (p.sk + TT - 1) / TT;
  const int kl = blockIdx.x / ntk;
  const int batch = kl / p.hk, kvh = kl % p.hk;
  const int rep = p.h / p.hk;
  const int k0 = (blockIdx.x - kl * ntk) * TT;
  const long long qstride = (long long)p.h * d, kstride = (long long)p.hk * d;
  const long long koff = (long long)batch * p.sk * kstride + (long long)kvh * d;
  load_tile(Ks, ld, (const T*)p.k + koff, kstride, k0, p.sk, d, TT);
  load_tile(Vs, ld, (const T*)p.v + koff, kstride, k0, p.sk, d, TT);

  float adk[R][DC], adv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int head = kvh * rep; head < (kvh + 1) * rep; ++head) {
    const int lane = batch * p.h + head;
    const long long qoff = (long long)batch * p.sq * qstride + (long long)head * d;
    for (int q0 = 0; q0 < p.sq; q0 += TT) {
      if (!tile_live(p, q0, k0, TT, TT)) continue;
      __syncthreads();
      load_tile(Qs, ld, (const T*)p.q + qoff, qstride, q0, p.sq, d, TT);
      load_tile(dOs, ld, dout + qoff, qstride, q0, p.sq, d, TT);
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_dot<R>(s, Qs, Ks, ld, d, ty, tx);
      finish_scores<R>(s, p, batch, head, q0, k0, ty, tx);
      tile_dot<R>(dp, dOs, Vs, ld, d, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + ty + 16 * i;
        const float lr = row < p.sq ? lse[(long long)lane * p.sq + row] : 0.f;
        const float dr = row < p.sq ? delta[(long long)lane * p.sq + row] : 0.f;
        const uint32_t drow = p.dropout ? drop_row(p, (uint32_t)lane, row) : 0u;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float pr = prob(s[i][j], lr);
          float pd = pr, g = dp[i][j];
          if (p.dropout) {
            const bool keep = drop_keep(p, drow, k0 + tx + 16 * j);
            pd = keep ? pr * p.drop_inv : 0.f;
            g = keep ? g * p.drop_inv : 0.f;
          }
          Ps[(ty + 16 * i) * LdS + tx + 16 * j] = as_operand<T>(pd);
          Ds[(ty + 16 * i) * LdS + tx + 16 * j] = as_operand<T>(pr * (g - dr));
        }
      }
      __syncthreads();
      // dV[key] += sum_q Pd[q][key] dO[q];  dK[key] += sum_q dS[q][key] Q[q]
      for (int qq = 0; qq < TT; ++qq) {
        float dov[DC], qv[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const int c = tx + 16 * j;
          dov[j] = c < d ? dOs[qq * ld + c] : 0.f;
          qv[j] = c < d ? Qs[qq * ld + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pd = Ps[qq * LdS + ty + 16 * i];
          const float g = Ds[qq * LdS + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            adv[i][j] = fmaf(pd, dov[j], adv[i][j]);
            adk[i][j] = fmaf(g, qv[j], adk[i][j]);
          }
        }
      }
    }
  }
  // outputs (b, sk, hk, d): one slab per kv head
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.sk) continue;
    const long long base = (((long long)batch * p.sk + key) * p.hk + kvh) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[base + c] = apex::from_f<T>(adk[i][j] * p.scale);
        dv[base + c] = apex::from_f<T>(adv[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ //
// Hopper path: forward, dq and dk/dv with TMA and wgmma (sm_90a)
// ------------------------------------------------------------------ //
// The three kernels run 384 threads: two consumer warpgroups (warps 0-7),
// each owning 64 rows of the block's tile, and a producer warpgroup
// whose first warp (warp 8; its lane 0 issues every TMA load) does the
// loading while the other three idle.  The producer fills a ring of
// kHStages stages; a stage's "full" barrier completes when its bytes
// have landed, its "empty" barrier when all 256 consumer threads are
// done with it.  One block a multiprocessor, and the grid is persistent:
// a block walks over many work items, so the next item's loads overlap
// this item's last products and its epilogue.  A block of 9 warps would
// be held to 168 registers a thread (3 warps on one scheduler's 16K);
// with three warpgroups the producer gives back all but 40 and the
// consumers take 232 (setmaxnreg), so the accumulators — up to 64 x 128
// scores plus a 64 x 128 output in the forward at d = 128 — do not
// spill.
namespace hp = apex::hopper;

constexpr int kHThreads = 384;   // 2 consumer + 1 producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kHStages = 2;      // ring depth
constexpr int kHM = 128;         // forward and dq: query rows per item
constexpr int kHN = 128;         // forward: keys per tile
constexpr int kHK = 128;         // dk/dv: keys per block
// dk/dv: queries per tile — 64 at d = 64 and 80 (dK and dV 32 or 40
// registers each, S^T and dP^T 32 each); 32 at d = 128 keeps dK, dV (64
// registers each), S^T and dP^T (16 each) and their packed operands
// within the register file
__host__ __device__ constexpr int dkv_bq(int d) { return d <= 80 ? 64 : 32; }
// dq: keys per tile — 128 at d = 64 (S and dP 64 registers each, dQ 32,
// packed dS 32); 64 at d = 128, where dQ alone takes 64, with dropout,
// whose hashes spilled 44 bytes at d = 64 with 128 keys, and at d = 80,
// where 128 keys fit but ran 3% slower at ViT's 257 (a third tile of one
// live key against a fifth of 64)
__host__ __device__ constexpr int dq_bn(int d, bool drop) {
  return d == 64 && !drop ? 128 : 64;
}

using hp::acc_col;
using hp::acc_row;
using hp::quad_max;
using hp::quad_sum;

// A tile of R rows x D columns lies in shared memory as D / panel_cols(D)
// panels of R rows (hopper.cuh): 64 columns with the 128-byte swizzle at
// head dims 64 and 128; 16 columns with the 32-byte swizzle at 80, whose
// 160-byte rows no 64-column panel divides.  Five 16-column panels make
// the D-wide products one m64n80k16 each.
__host__ __device__ constexpr int panel_cols(int d) {
  return d % 64 == 0 ? 64 : 16;
}

// rows [row0, row0 + R) of one head of map m into a tile, a TMA box a
// panel, completing on bar
template <int D, int R, typename T>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* m,
                                         uint64_t* bar, int head, int row0,
                                         int batch) {
  constexpr int PW = panel_cols(D);
#pragma unroll
  for (int pn = 0; pn < D / PW; ++pn)
    hp::tma_load_4d(dst + pn * R * PW, m, bar, PW * pn, head, row0, batch);
}

// a K-major operand (the depth runs along the row): the rows from r0 of
// a tile of R rows, depth columns 16 kk ... 16 kk + 15
template <int D, int R, typename T>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int r0, int kk) {
  constexpr int PW = panel_cols(D);
  return hp::desc_panel<PW>(
      tile + (16 * kk / PW) * R * PW + r0 * PW + 16 * kk % PW, 16, 16 * PW);
}

// an MN-major operand (the depth runs down the rows): rows 16 kk ... 16 kk
// + 15 of a tile of R rows, all D columns
template <int D, int R, typename T>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int kk) {
  constexpr int PW = panel_cols(D);
  return hp::desc_panel<PW>(tile + kk * 16 * PW, R * PW * 2, 16 * PW);
}

// One key tile of the forward for a warpgroup's 64 rows, on the scores
// in registers: scale (and bias), the masks where kMasked, the online
// softmax update of m, l (this lane's partial row sums) and the output
// accumulator, and the probabilities (dropped and rescaled for the value
// product) packed to T as the A operand of O += P V.
template <typename T, int D, bool kBias, bool kCausal, bool kDrop,
          bool kMasked>
__device__ __forceinline__ void fwd_tile_softmax(
    float (&sc)[kHN / 2], float (&acc)[D / 2], float (&m)[2], float (&l)[2],
    uint32_t (&pf)[kHN / 16][4], const Params& p, const float* const* brow,
    const uint32_t (&drow)[2], int qa, int k0, int wl) {
  const float c = p.scale * kLog2e;
  const int off = p.sk - p.sq;
  // a bias without a query axis (key padding) is read once per column
  const bool bias_shared = kBias && p.bias_sq == 0;
  float mx[2] = {m[0], m[1]};
  // registers i + e (row qa) and i + 2 + e (row qa + 8) share a column
#pragma unroll
  for (int i = 0; i < kHN / 2; i += 4)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = k0 + acc_col(i + e, wl);
      float b[2] = {0.f, 0.f};
      if (kBias && kpos < p.sk) {
        b[0] = brow[0][kpos] * kLog2e;
        b[1] = bias_shared ? b[0] : brow[1][kpos] * kLog2e;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = sc[i + e + 2 * r] * c;
        if (kBias) v += b[r];
        if (kMasked) {
          const int qpos = qa + 8 * r;
          bool dead = kpos >= p.sk;
          if (kCausal) {
            dead = dead || kpos > qpos + off;
            if (p.window > 0) dead = dead || kpos <= qpos + off - p.window;
          }
          if (dead) v = kNegInf;
        }
        sc[i + e + 2 * r] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = quad_max(mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kHN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    float p0, p1;
    if (kBias || kMasked) {
      p0 = prob(sc[i], m[r]);
      p1 = prob(sc[i + 1], m[r]);
    } else {
      p0 = exp2f(sc[i] - m[r]);
      p1 = exp2f(sc[i + 1] - m[r]);
    }
    // the normaliser takes the undropped probabilities; only the value
    // accumulation sees the dropped, rescaled ones
    rs[r] += p0 + p1;
    if (kDrop) {
      const int kpos = k0 + acc_col(i, wl);
      p0 = drop_keep(p, drow[r], kpos) ? p0 * p.drop_inv : 0.f;
      p1 = drop_keep(p, drow[r], kpos + 1) ? p1 * p.drop_inv : 0.f;
    }
    pf[i >> 3][(i & 7) >> 1] = hp::pack2<T>(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// The work of one item of a Q-stationary kernel (the forward, dq):
// (lane, 128 query rows) and its live tiles of BN keys [kt_lo, kt_hi) —
// the tiles outside are dead for every row of the item and never loaded.
struct QItem {
  int lane, batch, head, kvh, q0, kt_lo, kt_hi;
};

template <int BN, bool kCausal>
__device__ __forceinline__ QItem q_item(const Params& p, int item) {
  const int nqb = (p.sq + kHM - 1) / kHM;
  QItem it;
  it.lane = item / nqb;
  it.batch = it.lane / p.h;
  it.head = it.lane % p.h;
  it.kvh = it.head / (p.h / p.hk);
  it.q0 = (item % nqb) * kHM;
  it.kt_lo = 0;
  it.kt_hi = (p.sk + BN - 1) / BN;
  if (kCausal) {
    const int off = p.sk - p.sq;
    const int last_key = min(it.q0 + kHM, p.sq) - 1 + off;
    it.kt_hi = last_key < 0 ? 0 : min(it.kt_hi, last_key / BN + 1);
    if (p.window > 0) {
      const int first_key = it.q0 + off - p.window + 1;
      it.kt_lo = first_key > 0 ? first_key / BN : 0;
    }
  }
  return it;
}

// Forward.  Persistent: one block per multiprocessor walks the items
// item = blockIdx.x, + gridDim.x, ... (lane-major, so the blocks of a
// wave share K and V in L2).  Each consumer warpgroup keeps its 64
// rows' scores (64 x 128 fp32) and output (64 x d fp32) in registers.
// An item's Q tile is loaded once; K and V tiles of 128 keys stream
// through the ring, whose stages and phases run on across items.  S =
// Q K^T is wgmma with both operands in shared memory (K-major); O += P V
// takes P from registers and V transposed through its descriptor.  The
// consumers hand Q back as soon as the item's last S is done, so the
// producer loads the next item's Q and first K/V tile while they finish
// the item and write its output.
template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
__global__ void __launch_bounds__(kHThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p,
                    int n_items, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int kQElems = kHM * D, kKElems = kHN * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* Qs = reinterpret_cast<T*>(base);
  T* Ks = Qs + kQElems;                     // stage s at + s * kKElems
  T* Vs = Ks + kHStages * kKElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kHStages * kKElems);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kHStages;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    hp::mbar_init(q_empty, 256);
    for (int s = 0; s < kHStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 256);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int off = p.sk - p.sq;

  if (warp >= 8) {
    // producer warpgroup
    hp::reg_dealloc<kProducerRegs>();
    if (warp == 8 && wl == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const QItem it = q_item<kHN, kCausal>(p, item);
        hp::mbar_wait(q_empty, qph ^ 1);
        qph ^= 1;
        hp::mbar_expect_tx(q_full, kQElems * (int)sizeof(T));
        tma_tile<D, kHM>(Qs, &tq, q_full, it.head, it.q0, it.batch);
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
          hp::mbar_wait(&empty[s], ph ^ 1);
          hp::mbar_expect_tx(&full[s], 2 * kKElems * (int)sizeof(T));
          tma_tile<D, kHN>(Ks + s * kKElems, &tk, &full[s], it.kvh, kt * kHN,
                           it.batch);
          tma_tile<D, kHN>(Vs + s * kKElems, &tv, &full[s], it.kvh, kt * kHN,
                           it.batch);
          if (++s == kHStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // consumers: warpgroup wg owns rows q0 + 64 wg ... + 63 of an item
    const int wg = warp >> 2, ww = warp & 3;
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const QItem it = q_item<kHN, kCausal>(p, item);
      const int wq0 = it.q0 + 64 * wg;
      // this lane's rows: qa and qa + 8
      const int qa = wq0 + 16 * ww + (wl >> 2);
      const float* brow[2] = {nullptr, nullptr};
      uint32_t drow[2] = {0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qa + 8 * r;
        if (kBias)
          brow[r] = p.bias + (long long)it.batch * p.bias_sb +
                    (long long)it.head * p.bias_sh +
                    (long long)min(qpos, p.sq - 1) * p.bias_sq;
        if (kDrop) drow[r] = drop_row(p, (uint32_t)it.lane, qpos);
      }
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      hp::mbar_wait(q_full, qph);
      qph ^= 1;
      if (it.kt_hi <= it.kt_lo) hp::mbar_arrive(q_empty);
      for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
        const int k0 = kt * kHN;
        hp::mbar_wait(&full[s], ph);
        float sc[kHN / 2];
        const T* Kst = Ks + s * kKElems;
        const T* Vst = Vs + s * kKElems;
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hp::wgmma_ss<kHN, T>(sc, desc_k<D, kHM>(Qs, 64 * wg, kk),
                               desc_k<D, kHN>(Kst, 0, kk), kk > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(sc);
        if (kt == it.kt_hi - 1) hp::mbar_arrive(q_empty);  // Q is read
        // this warpgroup's rows meet an edge of the mask in this tile
        const bool edge =
            k0 + kHN > p.sk ||
            (kCausal && (k0 + kHN - 1 > wq0 + off ||
                         (p.window > 0 && k0 <= wq0 + 63 + off - p.window)));
        uint32_t pf[kHN / 16][4];
        if (edge)
          fwd_tile_softmax<T, D, kBias, kCausal, kDrop, true>(
              sc, acc, m, l, pf, p, brow, drow, qa, k0, wl);
        else
          fwd_tile_softmax<T, D, kBias, kCausal, kDrop, false>(
              sc, acc, m, l, pf, p, brow, drow, qa, k0, wl);
        hp::fence_regs(acc);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHN / 16; ++kk)
          hp::wgmma_rs_tb<D, T>(acc, pf[kk], desc_mn<D, kHN>(Vst, kk), 1);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        hp::fence_regs(pf);
        hp::mbar_arrive(&empty[s]);
        if (++s == kHStages) {
          s = 0;
          ph ^= 1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qa + 8 * r;
        const float lsum = quad_sum(l[r]);
        if (qpos >= p.sq) continue;
        const float ls = lsum == 0.f ? 1.f : lsum;
        T* orow = o + (((long long)it.batch * p.sq + qpos) * p.h + it.head) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(orow + acc_col(i, wl)) =
              hp::pack2<T>(acc[i] / ls, acc[i + 1] / ls);
        }
        if ((wl & 3) == 0)
          lse[(long long)it.lane * p.sq + qpos] = m[r] + log2f(ls);
      }
    }
  }
}

// One key tile of dq for a warpgroup's 64 rows, on S and dP in
// registers: P = exp2(S scale log2e + bias - lse) (exactly 0 at a dead
// position), dropout on dP through the forward's hash, dS = P (dP -
// delta), packed to T as the A operand of dQ += dS K.  Registers i + e
// (row qa) and i + 2 + e (row qa + 8) share a column, so a key-padding
// bias is read once for both rows.
template <typename T, int BN, bool kBias, bool kCausal, bool kDrop,
          bool kMasked>
__device__ __forceinline__ void dq_tile_ds(
    const float (&sc)[BN / 2], const float (&dp)[BN / 2],
    uint32_t (&df)[BN / 16][4], const Params& p, const float* const* brow,
    const uint32_t (&drow)[2], const float (&lr)[2], const float (&dr)[2],
    int qa, int k0, int wl) {
  const float c = p.scale * kLog2e;
  const int off = p.sk - p.sq;
  const bool bias_shared = kBias && p.bias_sq == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 4) {
    float ds[2][2];                  // [e][r]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = k0 + acc_col(i + e, wl);
      float b[2] = {0.f, 0.f};
      // off the edge every kpos < sk, and loads free of that test can
      // issue together
      if (kBias && (!kMasked || kpos < p.sk)) {
        b[0] = brow[0][kpos] * kLog2e;
        b[1] = bias_shared ? b[0] : brow[1][kpos] * kLog2e;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = sc[i + e + 2 * r] * c;
        if (kBias) v += b[r];
        if (kMasked) {
          const int qpos = qa + 8 * r;
          bool dead = kpos >= p.sk;
          if (kCausal) {
            dead = dead || kpos > qpos + off;
            if (p.window > 0) dead = dead || kpos <= qpos + off - p.window;
          }
          if (dead) v = kNegInf;
        }
        const float pr = (kBias || kMasked) ? prob(v, lr[r])
                                            : exp2f(v - lr[r]);
        float g = dp[i + e + 2 * r];
        // delta = rowsum(dO . O) already holds the dropout factor
        if (kDrop) g = drop_keep(p, drow[r], kpos) ? g * p.drop_inv : 0.f;
        ds[e][r] = pr * (g - dr[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      df[i >> 3][((i & 7) >> 1) + r] = hp::pack2<T>(ds[0][r], ds[1][r]);
  }
}

// dq.  Q-stationary as the forward, persistent over the same items
// (lane, 128 query rows), lane-major; each consumer warpgroup keeps its
// 64 rows' dQ (64 x d fp32) in registers.  An item's Q and dO tiles
// arrive once by TMA; K and V tiles of dq_bn keys stream through the
// ring.  Per key tile, S = Q K^T and dP = dO V^T are wgmma with both
// operands in shared memory (K-major) — the forward's S product, issued
// twice; dS is formed on their registers (dq_tile_ds) and enters dQ +=
// dS K as the register A operand, K read MN-major through its descriptor
// from the same swizzled tile, as the forward feeds V to O += P V.  Each
// consumer thread reads its two rows' lse and delta once per item.  Q
// and dO go back to the producer once the item's last S and dP are done,
// so the next item's loads overlap this item's last product and its
// epilogue.  dq = scale * dQ, rows past sq not written.
template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
__global__ void __launch_bounds__(kHThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Params p,
                       int n_items, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq) {
  constexpr int BN = dq_bn(D, kDrop);
  constexpr int kQElems = kHM * D, kKElems = BN * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* Qs = reinterpret_cast<T*>(base);
  T* dOs = Qs + kQElems;
  T* Ks = dOs + kQElems;                    // stage s at + s * kKElems
  T* Vs = Ks + kHStages * kKElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kHStages * kKElems);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kHStages;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    hp::mbar_init(q_empty, 256);
    for (int s = 0; s < kHStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 256);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int off = p.sk - p.sq;

  if (warp >= 8) {
    // producer warpgroup
    hp::reg_dealloc<kProducerRegs>();
    if (warp == 8 && wl == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const QItem it = q_item<BN, kCausal>(p, item);
        hp::mbar_wait(q_empty, qph ^ 1);
        qph ^= 1;
        hp::mbar_expect_tx(q_full, 2 * kQElems * (int)sizeof(T));
        tma_tile<D, kHM>(Qs, &tq, q_full, it.head, it.q0, it.batch);
        tma_tile<D, kHM>(dOs, &tdo, q_full, it.head, it.q0, it.batch);
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
          hp::mbar_wait(&empty[s], ph ^ 1);
          hp::mbar_expect_tx(&full[s], 2 * kKElems * (int)sizeof(T));
          tma_tile<D, BN>(Ks + s * kKElems, &tk, &full[s], it.kvh, kt * BN,
                          it.batch);
          tma_tile<D, BN>(Vs + s * kKElems, &tv, &full[s], it.kvh, kt * BN,
                          it.batch);
          if (++s == kHStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // consumers: warpgroup wg owns rows q0 + 64 wg ... + 63 of an item
    const int wg = warp >> 2, ww = warp & 3;
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const QItem it = q_item<BN, kCausal>(p, item);
      const int wq0 = it.q0 + 64 * wg;
      // this lane's rows: qa and qa + 8
      const int qa = wq0 + 16 * ww + (wl >> 2);
      const float* brow[2] = {nullptr, nullptr};
      uint32_t drow[2] = {0u, 0u};
      float lr[2], dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qa + 8 * r;
        const bool in = qpos < p.sq;
        lr[r] = in ? lse[(long long)it.lane * p.sq + qpos] : 0.f;
        dr[r] = in ? delta[(long long)it.lane * p.sq + qpos] : 0.f;
        if (kBias)
          brow[r] = p.bias + (long long)it.batch * p.bias_sb +
                    (long long)it.head * p.bias_sh +
                    (long long)min(qpos, p.sq - 1) * p.bias_sq;
        if (kDrop) drow[r] = drop_row(p, (uint32_t)it.lane, qpos);
      }
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      hp::mbar_wait(q_full, qph);
      qph ^= 1;
      if (it.kt_hi <= it.kt_lo) hp::mbar_arrive(q_empty);
      for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
        const int k0 = kt * BN;
        hp::mbar_wait(&full[s], ph);
        const T* Kst = Ks + s * kKElems;
        const T* Vst = Vs + s * kKElems;
        float sc[BN / 2], dp[BN / 2];
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hp::wgmma_ss<BN, T>(sc, desc_k<D, kHM>(Qs, 64 * wg, kk),
                              desc_k<D, BN>(Kst, 0, kk), kk > 0);
          hp::wgmma_ss<BN, T>(dp, desc_k<D, kHM>(dOs, 64 * wg, kk),
                              desc_k<D, BN>(Vst, 0, kk), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(sc);
        hp::fence_regs(dp);
        if (kt == it.kt_hi - 1) hp::mbar_arrive(q_empty);  // Q, dO are read
        // this warpgroup's rows meet an edge of the mask in this tile
        const bool edge =
            k0 + BN > p.sk ||
            (kCausal && (k0 + BN - 1 > wq0 + off ||
                         (p.window > 0 && k0 <= wq0 + 63 + off - p.window)));
        uint32_t df[BN / 16][4];
        if (edge)
          dq_tile_ds<T, BN, kBias, kCausal, kDrop, true>(
              sc, dp, df, p, brow, drow, lr, dr, qa, k0, wl);
        else
          dq_tile_ds<T, BN, kBias, kCausal, kDrop, false>(
              sc, dp, df, p, brow, drow, lr, dr, qa, k0, wl);
        hp::fence_regs(acc);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hp::wgmma_rs_tb<D, T>(acc, df[kk], desc_mn<D, BN>(Kst, kk), 1);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        hp::fence_regs(df);
        hp::mbar_arrive(&empty[s]);
        if (++s == kHStages) {
          s = 0;
          ph ^= 1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = qa + 8 * r;
        if (qpos >= p.sq) continue;
        T* orow = dq + (((long long)it.batch * p.sq + qpos) * p.h + it.head) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(orow + acc_col(i, wl)) =
              hp::pack2<T>(acc[i] * p.scale, acc[i + 1] * p.scale);
        }
      }
    }
  }
}

// One q tile of dk/dv for a warpgroup's 64 keys, on S^T and dP^T in
// registers: P^T = exp2(S^T - lse[q]), dS^T = P^T (dP^T - delta[q]) with
// dropout from the stage's per-query drop_row values, both packed to T
// as the A operands of dV += P^T dO and dK += dS^T Q.
template <typename T, int BQ, bool kBias, bool kCausal, bool kDrop,
          bool kMasked>
__device__ __forceinline__ void dkv_tile_grads(
    const float (&st)[BQ / 2], const float (&dpt)[BQ / 2],
    uint32_t (&pf)[BQ / 16][4], uint32_t (&df)[BQ / 16][4], const Params& p,
    const float* lse_s, const float* delta_s, const uint32_t* drow_s,
    const float* bias_hq, int ka, int q0, int wl) {
  const float c = p.scale * kLog2e;
  const int off = p.sk - p.sq;
  // a bias without a query axis (key padding) holds one value per key:
  // this lane's two keys' values, read once a tile
  const bool bias_shared = kBias && p.bias_sq == 0;
  float bkey[2] = {0.f, 0.f};
  if (bias_shared) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ka + 8 * r < p.sk) bkey[r] = bias_hq[ka + 8 * r] * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < BQ / 2; i += 2) {
    const int kpos = ka + acc_row(i);
    const int qi = acc_col(i, wl);
    float pd[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qpos = q0 + qi + e;
      float v = st[i + e] * c;
      bool dead = false;
      if (kMasked) {
        dead = kpos >= p.sk || qpos >= p.sq;
        if (kCausal) {
          dead = dead || kpos > qpos + off;
          if (p.window > 0) dead = dead || kpos <= qpos + off - p.window;
        }
      }
      if (bias_shared)
        v += bkey[(i >> 1) & 1];
      else if (kBias && kpos < p.sk && qpos < p.sq)
        v += bias_hq[(long long)qpos * p.bias_sq + kpos] * kLog2e;
      if (dead) v = kNegInf;
      const float pr = (kBias || kMasked) ? prob(v, lse_s[qi + e])
                                          : exp2f(v - lse_s[qi + e]);
      float g = dpt[i + e];
      pd[e] = pr;
      if (kDrop) {
        const bool keep = drop_keep(p, drow_s[qi + e], kpos);
        pd[e] = keep ? pr * p.drop_inv : 0.f;
        g = keep ? g * p.drop_inv : 0.f;
      }
      ds[e] = pr * (g - delta_s[qi + e]);
    }
    pf[i >> 3][(i & 7) >> 1] = hp::pack2<T>(pd[0], pd[1]);
    df[i >> 3][(i & 7) >> 1] = hp::pack2<T>(ds[0], ds[1]);
  }
}

// The work of one dk/dv item: (kv lane = batch * hk + kv head, 128 keys)
// and its live q tiles [qt_lo, qt_hi), taken for each of the rep query
// heads of the GQA group: n_tiles in all.
struct DkvItem {
  int batch, kvh, k0, qt_lo, qt_hi, n_tiles;
};

template <int BQ, bool kCausal>
__device__ __forceinline__ DkvItem dkv_item(const Params& p, int item) {
  const int nkb = (p.sk + kHK - 1) / kHK;
  const int kv_lane = item / nkb;
  DkvItem it;
  it.batch = kv_lane / p.hk;
  it.kvh = kv_lane % p.hk;
  it.k0 = (item % nkb) * kHK;
  const int nqt = (p.sq + BQ - 1) / BQ;
  it.qt_lo = 0;
  it.qt_hi = nqt;
  if (kCausal) {
    const int off = p.sk - p.sq;
    const int first_q = it.k0 - off;           // the first query seeing k0
    it.qt_lo = first_q > 0 ? min(nqt, first_q / BQ) : 0;
    if (p.window > 0) {
      // the last query seeing the item's last key
      const int last_q = min(it.k0 + kHK, p.sk) - 1 - off + p.window - 1;
      it.qt_hi = last_q < 0 ? 0 : min(nqt, last_q / BQ + 1);
    }
  }
  it.n_tiles = it.qt_hi > it.qt_lo ? (p.h / p.hk) * (it.qt_hi - it.qt_lo) : 0;
  return it;
}

// dk/dv.  Persistent as the forward, over items (kv lane, 128 keys),
// lane-major; each consumer warpgroup keeps its 64 keys' dK and dV (64 x
// d fp32 each) in registers.  An item's K and V are loaded once.  Its
// loop runs over the rep query heads of the GQA group, then over the
// live q tiles, in a fixed order, so the group is summed in those
// registers and dk, dv are written once per kv head.  Each stage brings
// a q tile of Q and dO by TMA and the tile's lse, delta and dropout row
// hashes (computed once per query by the producer warp).  S^T = K Q^T
// and dP^T = V dO^T are wgmma with both operands in shared memory; dV +=
// P^T dO and dK += dS^T Q take their A operand from registers and dO, Q
// transposed through the descriptor.  K and V go back to the producer
// once the item's last S^T and dP^T are done.
template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
__global__ void __launch_bounds__(kHThreads, 1)
fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, Params p,
                        int n_items, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int BQ = dkv_bq(D);
  constexpr int kKElems = kHK * D, kQElems = BQ * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* Ks = reinterpret_cast<T*>(base);
  T* Vs = Ks + kKElems;
  T* Qs = Vs + kKElems;                      // stage s at + s * kQElems
  T* dOs = Qs + kHStages * kQElems;
  float* lse_s = reinterpret_cast<float*>(dOs + kHStages * kQElems);
  float* delta_s = lse_s + kHStages * BQ;
  uint32_t* drow_s = reinterpret_cast<uint32_t*>(delta_s + kHStages * BQ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(drow_s + kHStages * BQ);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kHStages;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    hp::mbar_init(kv_empty, 256);
    for (int s = 0; s < kHStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 256);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int rep = p.h / p.hk;
  const int off = p.sk - p.sq;

  if (warp >= 8) {
    // producer warpgroup
    hp::reg_dealloc<kProducerRegs>();
    if (warp == 8) {
      int s = 0;
      uint32_t ph = 0, kvph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const DkvItem it = dkv_item<BQ, kCausal>(p, item);
        if (wl == 0) {
          hp::mbar_wait(kv_empty, kvph ^ 1);
          hp::mbar_expect_tx(kv_full, 2 * kKElems * (int)sizeof(T));
          tma_tile<D, kHK>(Ks, &tk, kv_full, it.kvh, it.k0, it.batch);
          tma_tile<D, kHK>(Vs, &tv, kv_full, it.kvh, it.k0, it.batch);
        }
        kvph ^= 1;
        for (int t = 0; t < it.n_tiles; ++t) {
          const int head = it.kvh * rep + t / (it.qt_hi - it.qt_lo);
          const int q0 = (it.qt_lo + t % (it.qt_hi - it.qt_lo)) * BQ;
          const int lane = it.batch * p.h + head;
          hp::mbar_wait(&empty[s], ph ^ 1);
          for (int i = wl; i < BQ; i += 32) {
            const int q = q0 + i;
            const bool in = q < p.sq;
            lse_s[s * BQ + i] = in ? lse[(long long)lane * p.sq + q] : 0.f;
            delta_s[s * BQ + i] = in ? delta[(long long)lane * p.sq + q] : 0.f;
            if (kDrop) drow_s[s * BQ + i] = drop_row(p, (uint32_t)lane, q);
          }
          __syncwarp();
          if (wl == 0) {
            hp::mbar_expect_tx(&full[s], 2 * kQElems * (int)sizeof(T));
            tma_tile<D, BQ>(Qs + s * kQElems, &tq, &full[s], head, q0,
                            it.batch);
            tma_tile<D, BQ>(dOs + s * kQElems, &tdo, &full[s], head, q0,
                            it.batch);
          }
          if (++s == kHStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // consumers: warpgroup wg owns keys k0 + 64 wg ... + 63 of an item
    const int wg = warp >> 2, ww = warp & 3;
    int s = 0;
    uint32_t ph = 0, kvph = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const DkvItem it = dkv_item<BQ, kCausal>(p, item);
      const int kw0 = it.k0 + 64 * wg;
      // this lane's keys: ka and ka + 8
      const int ka = kw0 + 16 * ww + (wl >> 2);
      float adk[D / 2], adv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

      hp::mbar_wait(kv_full, kvph);
      kvph ^= 1;
      if (it.n_tiles == 0) hp::mbar_arrive(kv_empty);
      for (int t = 0; t < it.n_tiles; ++t) {
        const int head = it.kvh * rep + t / (it.qt_hi - it.qt_lo);
        const int q0 = (it.qt_lo + t % (it.qt_hi - it.qt_lo)) * BQ;
        hp::mbar_wait(&full[s], ph);
        const T* Qst = Qs + s * kQElems;
        const T* dOst = dOs + s * kQElems;
        float st[BQ / 2], dpt[BQ / 2];
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hp::wgmma_ss<BQ, T>(st, desc_k<D, kHK>(Ks, 64 * wg, kk),
                              desc_k<D, BQ>(Qst, 0, kk), kk > 0);
          hp::wgmma_ss<BQ, T>(dpt, desc_k<D, kHK>(Vs, 64 * wg, kk),
                              desc_k<D, BQ>(dOst, 0, kk), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(st);
        hp::fence_regs(dpt);
        if (t == it.n_tiles - 1) hp::mbar_arrive(kv_empty);  // K, V are read
        const bool edge =
            q0 + BQ > p.sq || kw0 + 64 > p.sk ||
            (kCausal &&
             (kw0 + 63 > q0 + off ||
              (p.window > 0 && kw0 <= q0 + BQ - 1 + off - p.window)));
        const float* bias_hq =
            kBias ? p.bias + (long long)it.batch * p.bias_sb +
                        (long long)head * p.bias_sh
                  : nullptr;
        uint32_t pf[BQ / 16][4], df[BQ / 16][4];
        if (edge)
          dkv_tile_grads<T, BQ, kBias, kCausal, kDrop, true>(
              st, dpt, pf, df, p, lse_s + s * BQ, delta_s + s * BQ,
              drow_s + s * BQ, bias_hq, ka, q0, wl);
        else
          dkv_tile_grads<T, BQ, kBias, kCausal, kDrop, false>(
              st, dpt, pf, df, p, lse_s + s * BQ, delta_s + s * BQ,
              drow_s + s * BQ, bias_hq, ka, q0, wl);
        hp::fence_regs(adk);
        hp::fence_regs(adv);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          hp::wgmma_rs_tb<D, T>(adv, pf[kk], desc_mn<D, BQ>(dOst, kk), 1);
          hp::wgmma_rs_tb<D, T>(adk, df[kk], desc_mn<D, BQ>(Qst, kk), 1);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(adk);
        hp::fence_regs(adv);
        hp::fence_regs(pf);
        hp::fence_regs(df);
        hp::mbar_arrive(&empty[s]);
        if (++s == kHStages) {
          s = 0;
          ph ^= 1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = ka + 8 * r;
        if (kpos >= p.sk) continue;
        const long long at =
            (((long long)it.batch * p.sk + kpos) * p.hk + it.kvh) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * r;
          const int col = acc_col(i, wl);
          *reinterpret_cast<uint32_t*>(dk + at + col) =
              hp::pack2<T>(adk[i] * p.scale, adk[i + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dv + at + col) =
              hp::pack2<T>(adv[i], adv[i + 1]);
        }
      }
    }
  }
}

template <typename K>
int prepare(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t tiles_bytes(int d, int n_in, int n_score, int tt) {
  return ((size_t)n_in * tt * (d + 1) + (size_t)n_score * tt * (tt + 1)) *
         sizeof(float);
}

template <typename T, int DC, int R>
int fwd(const Params& p, void* o, float* lse, cudaStream_t st) {
  constexpr int TT = 16 * R;
  const size_t smem = tiles_bytes(p.d, 3, 1, TT);
  auto kern = fa_fwd_kernel<T, DC, R>;
  int e = prepare(kern, smem);
  if (e) return e;
  const long long grid = (long long)(p.sq + TT - 1) / TT * p.b * p.h;
  kern<<<(unsigned)grid, kThreads, smem, st>>>(p, (T*)o, lse);
  return (int)cudaGetLastError();
}

template <typename T, int DC, int R>
int bwd_dq(const Params& p, const void* dout, const float* lse,
           const float* delta, void* dq, cudaStream_t st) {
  constexpr int TT = 16 * R;
  const size_t smem = tiles_bytes(p.d, 4, 1, TT);
  auto kern = fa_bwd_dq_kernel<T, DC, R>;
  int e = prepare(kern, smem);
  if (e) return e;
  const long long grid = (long long)(p.sq + TT - 1) / TT * p.b * p.h;
  kern<<<(unsigned)grid, kThreads, smem, st>>>(p, (const T*)dout, lse, delta,
                                               (T*)dq);
  return (int)cudaGetLastError();
}

template <typename T, int DC, int R>
int bwd_dkv(const Params& p, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, cudaStream_t st) {
  constexpr int TT = 16 * R;
  const size_t smem = tiles_bytes(p.d, 4, 2, TT);
  auto kern = fa_bwd_dkv_kernel<T, DC, R>;
  int e = prepare(kern, smem);
  if (e) return e;
  const long long grid = (long long)(p.sk + TT - 1) / TT * p.b * p.hk;
  kern<<<(unsigned)grid, kThreads, smem, st>>>(p, (const T*)dout, lse, delta,
                                               (T*)dk, (T*)dv);
  return (int)cudaGetLastError();
}

// The FMA kernels by head dim: DC = 4 (d <= 64), 8 (<= 128), 16 (<= 256)
// accumulator columns; tiles of 64 rows, 32 above 128.
#define APEX_FMA(FN, T, ...)                                             \
  (d <= 64 ? FN<T, 4, 4>(__VA_ARGS__)                                    \
   : d <= 128 ? FN<T, 8, 4>(__VA_ARGS__) : FN<T, 16, 2>(__VA_ARGS__))
#define APEX_FMA_DT(FN, ...)                                             \
  switch (dt) {                                                          \
    case apex::kF32: return APEX_FMA(FN, float, __VA_ARGS__);            \
    case apex::kBF16: return APEX_FMA(FN, __nv_bfloat16, __VA_ARGS__);   \
    default: return APEX_FMA(FN, __half, __VA_ARGS__);                   \
  }

// the Hopper kernels: one variant per (bias, causal, dropout)
#define APEX_FA_VARIANTS(LAUNCH)                                           \
  switch ((p.bias != nullptr) * 4 + (p.causal != 0) * 2 + (p.dropout != 0)) { \
    case 0: return LAUNCH(false, false, false);                            \
    case 1: return LAUNCH(false, false, true);                             \
    case 2: return LAUNCH(false, true, false);                             \
    case 3: return LAUNCH(false, true, true);                              \
    case 4: return LAUNCH(true, false, false);                             \
    case 5: return LAUNCH(true, false, true);                              \
    case 6: return LAUNCH(true, true, false);                              \
    default: return LAUNCH(true, true, true);                              \
  }

template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
int fwd_wgmma_launch(const Params& p, const CUtensorMap& tq,
                     const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                     float* lse, cudaStream_t st) {
  constexpr size_t smem = 1024 + (size_t)(kHM * D + 2 * kHStages * kHN * D) *
                                     sizeof(T) + (2 + 2 * kHStages) * 8;
  auto kern = fa_fwd_wgmma_kernel<T, D, kBias, kCausal, kDrop>;
  int e = prepare(kern, smem);
  if (e) return e;
  const int n_items = (p.sq + kHM - 1) / kHM * p.b * p.h;
  kern<<<apex::persistent_grid(n_items), kHThreads, smem, st>>>(tq, tk, tv, p,
                                                          n_items, (T*)o, lse);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd_wgmma(const Params& p, int dt, void* o, float* lse, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int e = hp::tmap_bshd(&tq, p.q, dt, D, p.h, p.sq, p.b, kHM);
  if (!e) e = hp::tmap_bshd(&tk, p.k, dt, D, p.hk, p.sk, p.b, kHN);
  if (!e) e = hp::tmap_bshd(&tv, p.v, dt, D, p.hk, p.sk, p.b, kHN);
  if (e) return e;
#define APEX_FWD(B, C, R) fwd_wgmma_launch<T, D, B, C, R>(p, tq, tk, tv, o, lse, st)
  APEX_FA_VARIANTS(APEX_FWD)
#undef APEX_FWD
}

template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
int dq_wgmma_launch(const Params& p, const CUtensorMap& tq,
                    const CUtensorMap& tdo, int dt, const float* lse,
                    const float* delta, void* dq, cudaStream_t st) {
  constexpr int BN = dq_bn(D, kDrop);
  CUtensorMap tk, tv;
  constexpr int PW = panel_cols(D);
  int e = hp::tmap_bshd(&tk, p.k, dt, D, p.hk, p.sk, p.b, BN, PW);
  if (!e) e = hp::tmap_bshd(&tv, p.v, dt, D, p.hk, p.sk, p.b, BN, PW);
  if (e) return e;
  constexpr size_t smem = 1024 + (size_t)(2 * kHM * D + 2 * kHStages * BN * D) *
                                     sizeof(T) + (2 + 2 * kHStages) * 8;
  auto kern = fa_bwd_dq_wgmma_kernel<T, D, kBias, kCausal, kDrop>;
  e = prepare(kern, smem);
  if (e) return e;
  const int n_items = (p.sq + kHM - 1) / kHM * p.b * p.h;
  kern<<<apex::persistent_grid(n_items), kHThreads, smem, st>>>(
      tq, tk, tv, tdo, p, n_items, lse, delta, (T*)dq);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq_wgmma(const Params& p, int dt, const void* dout, const float* lse,
             const float* delta, void* dq, cudaStream_t st) {
  constexpr int PW = panel_cols(D);
  CUtensorMap tq, tdo;
  int e = hp::tmap_bshd(&tq, p.q, dt, D, p.h, p.sq, p.b, kHM, PW);
  if (!e) e = hp::tmap_bshd(&tdo, dout, dt, D, p.h, p.sq, p.b, kHM, PW);
  if (e) return e;
#define APEX_DQ(B, C, R) \
  dq_wgmma_launch<T, D, B, C, R>(p, tq, tdo, dt, lse, delta, dq, st)
  APEX_FA_VARIANTS(APEX_DQ)
#undef APEX_DQ
}

template <typename T, int D, bool kBias, bool kCausal, bool kDrop>
int dkv_wgmma_launch(const Params& p, const CUtensorMap& tq,
                     const CUtensorMap& tk, const CUtensorMap& tv,
                     const CUtensorMap& tdo, const float* lse,
                     const float* delta, void* dk, void* dv, cudaStream_t st) {
  constexpr int BQ = dkv_bq(D);
  constexpr size_t smem =
      1024 + (size_t)(2 * kHK * D + 2 * kHStages * BQ * D) * sizeof(T) +
      (size_t)3 * kHStages * BQ * 4 + (2 + 2 * kHStages) * 8;
  auto kern = fa_bwd_dkv_wgmma_kernel<T, D, kBias, kCausal, kDrop>;
  int e = prepare(kern, smem);
  if (e) return e;
  const int n_items = (p.sk + kHK - 1) / kHK * p.b * p.hk;
  kern<<<apex::persistent_grid(n_items), kHThreads, smem, st>>>(
      tq, tk, tv, tdo, p, n_items, lse, delta, (T*)dk, (T*)dv);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv_wgmma(const Params& p, int dt, const void* dout, const float* lse,
              const float* delta, void* dk, void* dv, cudaStream_t st) {
  constexpr int BQ = dkv_bq(D), PW = panel_cols(D);
  CUtensorMap tq, tk, tv, tdo;
  int e = hp::tmap_bshd(&tq, p.q, dt, D, p.h, p.sq, p.b, BQ, PW);
  if (!e) e = hp::tmap_bshd(&tdo, dout, dt, D, p.h, p.sq, p.b, BQ, PW);
  if (!e) e = hp::tmap_bshd(&tk, p.k, dt, D, p.hk, p.sk, p.b, kHK, PW);
  if (!e) e = hp::tmap_bshd(&tv, p.v, dt, D, p.hk, p.sk, p.b, kHK, PW);
  if (e) return e;
#define APEX_DKV(B, C, R) \
  dkv_wgmma_launch<T, D, B, C, R>(p, tq, tk, tv, tdo, lse, delta, dk, dv, st)
  APEX_FA_VARIANTS(APEX_DKV)
#undef APEX_DKV
}

// which kernel: the forward, dq or dk/dv (apex_fa_route's argument)
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// the wgmma kernels take half inputs at head_dim 64 and 128, and dq and
// dk/dv also at 80; the FMA kernels take the rest
bool use_tc(int kernel, int dt, int d) {
  return dt != apex::kF32 &&
         (d == 64 || d == 128 || (kernel != kFwd && d == 80));
}

// the wgmma launch FN<T, D>(...) for the head dims of use_tc
#define APEX_TC_BY_D(FN, ...)                                              \
  if (dt == apex::kBF16)                                                   \
    return d == 64   ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                  \
           : d == 80 ? FN<__nv_bfloat16, 80>(__VA_ARGS__)                  \
                     : FN<__nv_bfloat16, 128>(__VA_ARGS__);                \
  return d == 64 ? FN<__half, 64>(__VA_ARGS__)                             \
         : d == 80 ? FN<__half, 80>(__VA_ARGS__)                           \
                   : FN<__half, 128>(__VA_ARGS__);

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
// and kept probabilities times drop_inv.  d a multiple of 8 up to 256.

// o like q; lse (b * h, sq) float32, log2 domain.  Pointers 16-byte
// aligned (TMA).
extern "C" int apex_fa_fwd(APEX_FA_PARAMS, void* o, void* lse, void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (use_tc(kFwd, dt, d)) {
    if (dt == apex::kBF16)
      return d == 128 ? fwd_wgmma<__nv_bfloat16, 128>(p, dt, o, l, st)
                      : fwd_wgmma<__nv_bfloat16, 64>(p, dt, o, l, st);
    return d == 128 ? fwd_wgmma<__half, 128>(p, dt, o, l, st)
                    : fwd_wgmma<__half, 64>(p, dt, o, l, st);
  }
  APEX_FMA_DT(fwd, p, o, l, st)
}

// dout, dq like q; lse from apex_fa_fwd; delta (b * h, sq) float32 =
// rowsum(dout * o).  Pointers 16-byte aligned (TMA).
extern "C" int apex_fa_bwd_dq(APEX_FA_PARAMS, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (use_tc(kDq, dt, d)) {
    APEX_TC_BY_D(dq_wgmma, p, dt, dout, l, dl, dq, st)
  }
  APEX_FMA_DT(bwd_dq, p, dout, l, dl, dq, st)
}

// dk, dv like k, v (b, sk, hk, d) in dtype dt: under GQA each kv head
// sums its group of rep query heads.  Pointers 16-byte aligned (TMA).
extern "C" int apex_fa_bwd_dkv(APEX_FA_PARAMS, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, void* stream) {
  const Params p = APEX_FA_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (use_tc(kDkv, dt, d)) {
    APEX_TC_BY_D(dkv_wgmma, p, dt, dout, l, dl, dk, dv, st)
  }
  APEX_FMA_DT(bwd_dkv, p, dout, l, dl, dk, dv, st)
}

// 1 if `kernel` (0 the forward, 1 dq, 2 dk/dv) runs the wgmma kernels for
// dtype dt at head_dim d, 0 if the FMA kernels; launches nothing
extern "C" int apex_fa_route(int kernel, int dt, int d) {
  return use_tc(kernel, dt, d) ? 1 : 0;
}
