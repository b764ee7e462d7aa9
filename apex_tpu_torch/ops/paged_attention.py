"""Attention over a paged KV pool: CUDA kernels and their plain versions.

Counterpart of ``apex_tpu/ops/paged_attention.py``.  The serving
engine's paged cache stores K/V in fixed-size pages of a shared pool:
page ``p`` of row ``b`` lives at pool block ``block_tables[b, p]``, and
physical block 0 is the null page pad writes land in.  Layouts, as in
the JAX module::

    q             (batch, s, num_heads, head_dim)   s = chunk (1 = decode)
    k_pages       (kv_heads, num_blocks, block_size, head_dim)
    v_pages       (kv_heads, num_blocks, block_size, head_dim)
    block_tables  (batch, pages_per_seq)  int32
    lengths       (batch,)  int32 — tokens cached before this chunk
    k/v_scales    (kv_heads, num_blocks)  float32 (quantized pools)

Key position ``p`` is visible to query ``i`` of row ``b`` iff ``p <=
lengths[b] + i``, so garbage past the cursor (freed pages, pad writes,
the null page) is never read.  A quantized pool stores int8 codes
(qmax 127, round half to even) or ``float8_e4m3fn`` codes (qmax 448,
clamped, then cast) with one fp32 amax scale per (kv head, page); the
plain versions dequantize after the gather, the kernels in registers.

- :func:`paged_attention` — chunk queries over the pool whose chunk K/V
  is already written (chunked prefill, the speculative verify).  CUDA
  kernel ``apex_paged_attention`` (``csrc/paged_attention.cu``) for a
  CUDA tensor, :func:`paged_attention_reference` for a CPU one.
- :func:`paged_decode_fused` — the width-1 decode step: RoPE of ``q`` and
  the new key at each row's position, the (quantized) write of the new
  K/V row into its page, and the attend.  CUDA kernel
  ``apex_paged_decode_fused``; plain :func:`paged_decode_fused_reference`.

Unlike the JAX functions, which return new pools, these update the pool
(and its scales) **in place** and return the same tensors: the pool is
the serving engine's largest allocation, and only one row of it moves
per decode step.

Tensor-parallel pools take no mesh argument: each rank holds
``kv_heads / tp`` heads of every page and their ``(kv head, page)``
scales, and passes its shard with the q heads that read them (its block
from :func:`tp_head_shards`, which a tensor-parallel layer's projection
already gives); the result is the unsharded op's slice of heads.  The
JAX op's ``mesh=`` / ``shard_axis=`` place a global array with
``shard_map``; a process here holds only its shard, so the ops stay
unsharded and the serving engine carries the mesh.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_decode_fused", "paged_decode_fused_reference",
           "paged_attention_splits", "paged_decode_fused_splits",
           "rope_rows", "kv_quant_spec", "kv_store_bytes_per_token",
           "quantize_kv", "quantize_kv_pages", "tp_head_shards",
           "pool_qmax", "paged_cost_bytes", "paged_kernel_ok",
           "MAX_HEAD_DIM"]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634

#: storage dtype -> qmax of a quantized pool
_QMAX_BY_DTYPE = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}

# scales below qmax / float32 max would overflow the quantization
# multiplier to +inf (0 * inf = NaN poisons zero K/V)
_TINY_SCALE = 448.0 / float(np.finfo(np.float32).max)


def kv_quant_spec(kv_dtype):
    """``None`` → ``(None, None)``; ``"int8"`` → ``(torch.int8, 127.0)``;
    ``"fp8"`` → ``(torch.float8_e4m3fn, 448.0)``; anything else raises."""
    if kv_dtype is None:
        return None, None
    if kv_dtype == "int8":
        return torch.int8, _QMAX_BY_DTYPE[torch.int8]
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn, _QMAX_BY_DTYPE[torch.float8_e4m3fn]
    raise ValueError(
        f"kv_dtype={kv_dtype!r} not in (None, 'int8', 'fp8')")


def kv_store_bytes_per_token(head_dim, block_size, kv_dtype=None, *,
                             dtype=None):
    """Pool bytes per cached token per (kv head, layer): K+V at the
    storage width plus, when quantized, the two fp32 page scales
    amortized over ``block_size`` tokens.  ``dtype`` (the compute
    dtype) is needed only for an unquantized pool."""
    store_dt, _ = kv_quant_spec(kv_dtype)
    if store_dt is None:
        if dtype is None:
            raise ValueError(
                "dtype is required for an unquantized pool "
                "(kv_dtype=None)")
        return 2 * int(head_dim) * torch.empty((), dtype=dtype).element_size()
    return (2 * int(head_dim) * torch.empty((), dtype=store_dt).element_size()
            + 2 * 4.0 / int(block_size))


def quantize_kv(x, scales, qmax, dtype):
    """Symmetric codes of ``x`` ``(..., d)`` against per-row amax
    ``scales`` ``(...)``: ``x * (qmax / scale)`` clamped to ±qmax,
    rounded half to even for int8, cast for fp8; ``scale`` at or below
    the tiny guard codes to exact 0."""
    scales = scales.float()
    ok = scales > _TINY_SCALE
    # a true division (``scalar / tensor`` would be a reciprocal and a
    # multiply in PyTorch: another rounding than the JAX function's)
    inv = torch.where(ok, torch.full_like(scales, qmax)
                      / torch.clamp(scales, min=_TINY_SCALE),
                      torch.zeros_like(scales))
    y = torch.clamp(x.float() * inv[..., None], -qmax, qmax)
    if not dtype.is_floating_point:
        y = torch.round(y)
    return y.to(dtype)


def quantize_kv_pages(k_pages, v_pages, kv_dtype):
    """Quantize a whole float pool: per-(kv head, page) amax over the
    ``(block_size, head_dim)`` tile.  Returns ``(kq, vq, k_scales,
    v_scales)`` (test and offline helper; the engine codes each write)."""
    store_dt, qmax = kv_quant_spec(kv_dtype)
    if store_dt is None:
        raise ValueError("quantize_kv_pages needs kv_dtype in "
                         "('int8', 'fp8'), got None")
    ks = k_pages.float().abs().amax(dim=(2, 3))
    vs = v_pages.float().abs().amax(dim=(2, 3))
    kq = quantize_kv(k_pages, ks[:, :, None], qmax, store_dt)
    vq = quantize_kv(v_pages, vs[:, :, None], qmax, store_dt)
    return kq, vq, ks, vs


def tp_head_shards(num_heads: int, kv_heads: int, tp: int):
    """Shard ``j`` of ``tp`` owns q heads ``[j·h/tp, (j+1)·h/tp)`` and kv
    heads ``[j·hk/tp, (j+1)·hk/tp)``; raises when ``kv_heads % tp``."""
    num_heads, kv_heads, tp = int(num_heads), int(kv_heads), int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if num_heads % kv_heads:
        raise ValueError(
            f"kv_heads ({kv_heads}) must divide num_heads ({num_heads})")
    if kv_heads % tp:
        raise ValueError(
            f"kv_heads ({kv_heads}) must be divisible by the "
            f"tensor-parallel degree ({tp}) — the paged KV pool shards "
            f"on the kv_heads axis, one equal slice per device")
    rep = num_heads // kv_heads
    hkl = kv_heads // tp
    return [((j * hkl * rep, (j + 1) * hkl * rep),
             (j * hkl, (j + 1) * hkl)) for j in range(tp)]


def pool_qmax(dtype) -> Optional[float]:
    """qmax of a pool stored in ``dtype``: 127 for int8, 448 for e4m3,
    None for a float pool."""
    return _QMAX_BY_DTYPE.get(dtype)


def _qmax_for_pool(dtype) -> float:
    try:
        return _QMAX_BY_DTYPE[dtype]
    except KeyError:
        raise ValueError(
            f"no KV quantization spec for pool dtype {dtype}") from None


# --------------------------------------------------------------------- #
# plain versions (golden semantics; the CPU path)
# --------------------------------------------------------------------- #
def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths,
                              *, scale: Optional[float] = None,
                              k_scales=None, v_scales=None):
    """Gather-then-attend: every row's pages through its table, masked
    by absolute position, fp32 softmax, output in ``q.dtype``.  Coded
    pages are dequantized after the gather (``code · scale / qmax``)."""
    b, s, h, d = q.shape
    hk, _nb, bs, _ = k_pages.shape
    rep = h // hk
    scale = (d ** -0.5) if scale is None else scale
    mb = block_tables.shape[1]
    tables = block_tables.long()
    # (hk, b, mb, bs, d) -> (b, mb, bs, hk, d): key position == index
    keys = k_pages[:, tables].permute(1, 2, 3, 0, 4)
    vals = v_pages[:, tables].permute(1, 2, 3, 0, 4)
    if k_scales is not None:
        qmax = _qmax_for_pool(k_pages.dtype)
        ks = k_scales[:, tables].permute(1, 2, 0)            # (b, mb, hk)
        vs = v_scales[:, tables].permute(1, 2, 0)
        keys = keys.float() * (ks.float() / qmax)[:, :, None, :, None]
        vals = vals.float() * (vs.float() / qmax)[:, :, None, :, None]
    keys = keys.reshape(b, mb * bs, hk, d).float()
    vals = vals.reshape(b, mb * bs, hk, d).float()
    qg = q.reshape(b, s, hk, rep, d).float()
    scores = torch.einsum("bsgrd,bkgd->bsgrk", qg, keys) * scale
    pos_q = lengths.long()[:, None] + torch.arange(s, device=q.device)
    k_pos = torch.arange(mb * bs, device=q.device)
    visible = k_pos[None, None, :] <= pos_q[:, :, None]          # (b, s, K)
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bsgrk,bkgd->bsgrd", p, vals)
    return o.reshape(b, s, h, d).to(q.dtype)


def rope_rows(x, cos_b, sin_b):
    """Half-rotation RoPE with per-row tables: ``x`` (b, s, heads, d),
    ``cos_b``/``sin_b`` (b, s, 1, rot/2) — fp32 math, cast back, the
    tail past the rotary span passed through."""
    half = cos_b.shape[-1]
    rot = 2 * half
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    c, s = cos_b.float(), sin_b.float()
    o1 = (x1 * c - x2 * s).to(x.dtype)
    o2 = (x2 * c + x1 * s).to(x.dtype)
    return torch.cat([o1, o2, x[..., rot:]], dim=-1)


def paged_decode_fused_reference(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, lengths, *,
                                 max_seq_len: int, cos_b=None, sin_b=None,
                                 scale: Optional[float] = None,
                                 k_scales=None, v_scales=None,
                                 chunk_lens=None):
    """The unfused decode step: per-row RoPE of ``q`` / ``k_new``, the
    new row's write at ``lengths[b]`` (past ``max_seq_len``, or on a pad
    row when quantized, into the null page), then the gathered attend.
    Quantized pools code the row under the running-amax chain: the
    page's scale is reset at offset 0, the row's amax is chained through
    its previous page's scale, and the page's scale takes the max.
    Updates the pool (and scales) in place; returns ``(o, k_pages,
    v_pages)`` plus ``(k_scales, v_scales)`` when quantized."""
    return _write_then_attend(
        paged_attention_reference, q, k_new, v_new, k_pages, v_pages,
        block_tables, lengths, max_seq_len=max_seq_len, cos_b=cos_b,
        sin_b=sin_b, scale=scale, k_scales=k_scales, v_scales=v_scales,
        chunk_lens=chunk_lens)


def _write_then_attend(attend, q, k_new, v_new, k_pages, v_pages,
                       block_tables, lengths, *, max_seq_len, cos_b, sin_b,
                       scale, k_scales, v_scales, chunk_lens):
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(
            f"paged_decode_fused is the width-1 decode step, got s={s}")
    hk, _nb, BS, _ = k_pages.shape
    MB = block_tables.shape[1]
    S = int(max_seq_len)
    scale = (d ** -0.5) if scale is None else scale
    if cos_b is not None:
        q = rope_rows(q, cos_b, sin_b)
        k_new = rope_rows(k_new, cos_b, sin_b)
    tables = block_tables.long()
    pos = lengths.long()                                      # (b,)
    logical = torch.clamp(pos // BS, max=MB - 1)
    phys = tables.gather(1, logical[:, None])[:, 0]
    phys = torch.where(pos < S, phys, torch.zeros_like(phys))
    off = pos % BS
    kT = k_new[:, 0].transpose(0, 1)                          # (hk, b, d)
    vT = v_new[:, 0].transpose(0, 1)
    if k_scales is None:
        k_pages[:, phys, off] = kT.to(k_pages.dtype)
        v_pages[:, phys, off] = vT.to(v_pages.dtype)
        o = attend(q, k_pages, v_pages, block_tables, lengths, scale=scale)
        return o, k_pages, v_pages
    qmax = _qmax_for_pool(k_pages.dtype)
    store_dt = k_pages.dtype
    real = (torch.ones_like(pos, dtype=torch.bool) if chunk_lens is None
            else chunk_lens > 0)
    phys = torch.where(real, phys, torch.zeros_like(phys))
    ka = kT.float().abs().amax(dim=-1)                       # (hk, b)
    va = vT.float().abs().amax(dim=-1)
    ka = torch.where(real[None], ka, torch.zeros_like(ka))
    va = torch.where(real[None], va, torch.zeros_like(va))
    base_logical = torch.clamp(torch.div(pos - 1, BS, rounding_mode="floor"),
                               0, MB - 1)
    base_phys = tables.gather(1, base_logical[:, None])[:, 0]
    has_prefix = (pos > 0)[None, :]
    zero = torch.zeros((), device=q.device)
    k_run = torch.maximum(ka, torch.where(has_prefix, k_scales[:, base_phys],
                                          zero))
    v_run = torch.maximum(va, torch.where(has_prefix, v_scales[:, base_phys],
                                          zero))
    fresh = torch.where(off == 0, phys, torch.zeros_like(phys))
    for sc, run in ((k_scales, k_run), (v_scales, v_run)):
        sc[:, fresh] = 0.0
        sc.scatter_reduce_(1, phys[None].expand(hk, -1), run, "amax")
    k_pages[:, phys, off] = quantize_kv(kT, k_scales[:, phys], qmax, store_dt)
    v_pages[:, phys, off] = quantize_kv(vT, v_scales[:, phys], qmax, store_dt)
    o = attend(q, k_pages, v_pages, block_tables, lengths, scale=scale,
               k_scales=k_scales, v_scales=v_scales)
    return o, k_pages, v_pages, k_scales, v_scales


# --------------------------------------------------------------------- #
# a plain model of the split-K kernels (tests only)
# --------------------------------------------------------------------- #
def paged_attention_splits(q, k_pages, v_pages, block_tables, lengths, *,
                           split_pages: int, scale: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """The arithmetic of the CUDA kernels for up to 8 query lanes per
    (row, kv head), in plain PyTorch.  A row of ``n`` visible keys (``len
    + s``, at most the table's) is cut into ``ceil(n / split)`` splits of
    ``ceil(n / splits)`` keys rounded up to whole pages (``split`` =
    ``split_pages`` pages; the kernels take the smallest split, at least
    ``_SPLIT_KEYS`` keys, whose items fit their grid); per split, in fp32
    and the log2 domain, the scores ``(q * scale * log2 e) . k`` (codes
    cast up, times the page's ``scale / qmax``), the split's maximum
    ``m``, ``p = exp2(s - m)``, ``l = sum p`` and ``acc = sum (p *
    v_scale / qmax) v``; then the merge: ``M = max m``, ``f = exp2(m -
    M)`` (0 for a split with no visible key), ``o = sum f acc / sum f l``
    (a sum of 0 counts as 1), in q's dtype.  Used by the tests to hold the
    split-and-merge against the JAX function; the serving path never
    calls it."""
    b, s, h, d = q.shape
    hk, _nb, bs, _ = k_pages.shape
    rep = h // hk
    scale = (d ** -0.5) if scale is None else scale
    mb = block_tables.shape[1]
    kmax = mb * bs
    split = int(split_pages) * bs
    keys = torch.clamp(lengths.long() + s, max=kmax)               # (b,)
    ns = torch.clamp(torch.div(keys + split - 1, split, rounding_mode="floor"),
                     min=1)
    per = torch.div(keys + ns - 1, ns, rounding_mode="floor")
    sk = torch.clamp(torch.div(per + bs - 1, bs, rounding_mode="floor") * bs,
                     min=bs)
    nsmax = int(ns.max()) if b else 1
    k_pos = torch.arange(kmax, device=q.device)
    sid = torch.div(k_pos[None, :], sk[:, None], rounding_mode="floor")
    onehot = sid[:, :, None] == torch.arange(nsmax, device=q.device)
    tables = block_tables.long()
    kc = k_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(
        b, kmax, hk, d).float()
    vc = v_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(
        b, kmax, hk, d).float()
    kf = torch.ones(b, kmax, hk, device=q.device)
    vf = torch.ones(b, kmax, hk, device=q.device)
    if k_scales is not None:
        dq = torch.tensor(1.0 / _qmax_for_pool(k_pages.dtype))
        kf = (k_scales[:, tables].float() * dq).permute(
            1, 2, 0).repeat_interleave(bs, dim=1)
        vf = (v_scales[:, tables].float() * dq).permute(
            1, 2, 0).repeat_interleave(bs, dim=1)
    qs = q.reshape(b, s, hk, rep, d).float() * torch.tensor(
        scale * _LOG2E, dtype=torch.float32)
    sc = torch.einsum("bsgrd,bkgd->bsgrk", qs, kc)
    sc = sc * kf.permute(0, 2, 1)[:, None, :, None, :]
    pos_q = lengths.long()[:, None] + torch.arange(s, device=q.device)
    visible = k_pos[None, None, :] <= pos_q[:, :, None]            # (b,s,K)
    sc = torch.where(visible[:, :, None, None, :], sc,
                     torch.full_like(sc, -math.inf))
    oh = onehot[:, None, None, None]                            # (b,1,1,1,K,n)
    m = torch.where(oh, sc[..., None], torch.full_like(
        sc[..., None], -math.inf)).amax(dim=-2)                    # (...,n)
    base = torch.where(m == -math.inf, torch.zeros_like(m), m)
    base_k = torch.gather(base, -1, sid[:, None, None, None, :].expand(
        b, s, hk, rep, kmax).clamp(max=nsmax - 1))
    p = torch.exp2(sc - base_k)
    l = (p[..., None] * oh).sum(dim=-2)
    pv = p * vf.permute(0, 2, 1)[:, None, :, None, :]
    acc = torch.einsum("bsgrk,bkn,bkgd->bsgrnd", pv, onehot.float(), vc)
    mx = m.amax(dim=-1, keepdim=True)
    mx = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
    f = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - mx))
    lsum = (l * f).sum(dim=-1)
    o = (acc * f[..., None]).sum(dim=-2)
    o = o / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    return o.reshape(b, s, h, d).to(q.dtype)


def paged_decode_fused_splits(q, k_new, v_new, k_pages, v_pages,
                              block_tables, lengths, *, split_pages: int,
                              max_seq_len: int, cos_b=None, sin_b=None,
                              scale: Optional[float] = None, k_scales=None,
                              v_scales=None, chunk_lens=None):
    """:func:`paged_decode_fused_reference`'s write, then
    :func:`paged_attention_splits`: the fused decode kernel's split
    model (tests only).  Same returns."""
    def attend(*args, **kw):
        return paged_attention_splits(*args, split_pages=split_pages, **kw)
    return _write_then_attend(
        attend, q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
        max_seq_len=max_seq_len, cos_b=cos_b, sin_b=sin_b, scale=scale,
        k_scales=k_scales, v_scales=v_scales, chunk_lens=chunk_lens)


# --------------------------------------------------------------------- #
# CUDA kernels
# --------------------------------------------------------------------- #
#: the widest head_dim the kernels take
MAX_HEAD_DIM = 256
#: the head-dim widths the split and tile kernels are built at; a head
#: dim runs at the narrowest that holds it (``width_cpt`` of the source)
_WIDTHS = (64, 96, 128, 256)


def paged_kernel_ok(d: int, q_dtype, kv_dtype) -> bool:
    """Whether the paged kernels take head_dim ``d`` with q of
    ``q_dtype`` over pages of ``kv_dtype``: the JAX package's Pallas
    envelope (``d % 8 == 0``; pages of q's dtype or 1-byte codes) up to
    :data:`MAX_HEAD_DIM`.  Its other conditions (pages a multiple of 8
    tokens, rotary halves a multiple of 8) do not apply: the kernels take
    every page size and half, as they did before the envelope."""
    return (d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM
            and (kv_dtype == q_dtype or kv_dtype in _QMAX_BY_DTYPE))


def _route(implementation, q, k_pages, op):
    """``"kernel"`` or ``"torch"`` for a paged call (see
    :func:`._dispatch.resolve_impl`)."""
    d = q.shape[-1]
    return resolve_impl(
        implementation, q, inside=paged_kernel_ok(d, q.dtype, k_pages.dtype),
        op=op, shape=(tuple(q.shape), str(q.dtype), str(k_pages.dtype)),
        why=f"head_dim {d} or pool dtype outside d % 8 == 0, d <= "
            f"{MAX_HEAD_DIM}, pages of q's dtype or 1-byte codes")


def _width(d: int) -> int:
    return next(w for w in _WIDTHS if d <= w)


def _ptr_ok(t: torch.Tensor, align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(
            f"tensor of {t.dtype} not aligned to {align} bytes for the "
            f"paged kernels")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied when its data is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_args(q, k_pages, tables, lengths, *rest):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("block_tables", tables),
                    ("lengths", lengths)) + tuple(rest):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported q dtype {q.dtype}")
    d = q.shape[-1]
    if not paged_kernel_ok(d, q.dtype, k_pages.dtype):
        raise ValueError(
            f"the paged kernels take head_dim 8 .. {MAX_HEAD_DIM}, a "
            f"multiple of 8, over pages of q's dtype or int8 / "
            f"float8_e4m3fn codes; got {d} over {k_pages.dtype}")
    if not k_pages.is_contiguous():
        raise ValueError("the pool must be contiguous")


#: the fewest keys of a split of the kernels for up to 8 query lanes per
#: (row, kv head), rounded down to whole pages (at least one); the kernels
#: widen the splits until their items fit the grid
_SPLIT_KEYS = 32
#: rows one split launch enumerates (``kMaxRows`` of the source)
_SPLIT_ROWS = 128
#: (device, stream) -> the split kernels' int32 tickets, zero between calls
_TICKETS = {}
_SM_COUNT = {}


def _split_args(q, lanes, hk, bs, mb, groups=1):
    """``(workspace, tickets, split keys, workspace items)`` of a split
    kernel launch with ``lanes`` query lanes an item and ``groups`` items
    per (row, split, kv head): the workspace from the caching allocator,
    one item's partials at the kernel's width for every warp the launch
    can have (one a block, at most 32 blocks an SM, no more than the
    items at the smallest split), the tickets from a zeroed buffer kept
    per device and stream (the kernels leave it zero)."""
    b, d = q.shape[0], q.shape[-1]
    if mb * bs >= 1 << 21 or hk > 1024 or bs > 1024:
        raise ValueError(
            f"the split kernels take tables of fewer than 2^21 keys and up "
            f"to 1024 kv heads and page tokens, got {mb} pages of {bs}, "
            f"{hk} kv heads")
    split = max(1, _SPLIT_KEYS // bs) * bs
    dev = q.device
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    rows = min(b, _SPLIT_ROWS)
    items = min(rows * hk * groups * max(1, -(-(mb * bs) // split)),
                _SM_COUNT[dev] * 32)
    ws = torch.empty(items * lanes * (_width(d) + 2), dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < b * hk * groups:
        tickets = torch.zeros(max(b * hk * groups, 1024), dtype=torch.int32,
                              device=dev)
        _TICKETS[key] = tickets
    return ws, tickets, split, items


def _paged_kernel(q, k_pages, v_pages, tables, lengths, scale, k_scales,
                  v_scales):
    b, s, h, d = q.shape
    hk, nb, bs, _ = k_pages.shape
    _check_kernel_args(q, k_pages, tables, lengths)
    if not v_pages.is_contiguous() or v_pages.dtype != k_pages.dtype:
        raise ValueError("v_pages must be contiguous and of k_pages' dtype")
    coded = k_pages.dtype in _QMAX_BY_DTYPE
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    if b == 0 or s == 0:
        return o
    ks = vs = None
    if coded:
        ks = k_scales.to(torch.float32).contiguous()
        vs = v_scales.to(torch.float32).contiguous()
    mb = tables.shape[1]
    lanes = (h // hk) * s
    ws = tickets = None
    split = ws_items = 0
    if lanes <= 8:
        # the split kernels copy rows by bulk copies of 16-byte vectors
        q = _aligned16(q)
        for t in (k_pages, v_pages):
            _ptr_ok(t, 16)
        ws, tickets, split, ws_items = _split_args(q, lanes, hk, bs, mb)
    fn = _build.function("paged_attention", "apex_paged_attention", [
        ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              0 if ks is None else ks.data_ptr(),
              0 if vs is None else vs.data_ptr(),
              tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
              0 if ws is None else ws.data_ptr(),
              0 if tickets is None else tickets.data_ptr(),
              b, s, h, hk, d, nb, bs, mb, split, ws_items,
              float(scale) * _LOG2E,
              1.0 / _qmax_for_pool(k_pages.dtype) if coded else 1.0,
              _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pages.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_attention")
    return o


def _decode_fused_kernel(q, k_new, v_new, k_pages, v_pages, tables, lengths,
                         S, cos_b, sin_b, scale, k_scales, v_scales,
                         chunk_lens):
    b, _s, h, d = q.shape
    hk, nb, bs, _ = k_pages.shape
    _check_kernel_args(q, k_pages, tables, lengths, ("k_new", k_new),
                       ("chunk_lens", chunk_lens))
    if not v_pages.is_contiguous() or v_pages.dtype != k_pages.dtype:
        raise ValueError("v_pages must be contiguous and of k_pages' dtype")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("k_new / v_new must be of q's dtype")
    coded = k_pages.dtype in _QMAX_BY_DTYPE
    if coded and not (k_scales.is_contiguous() and v_scales.is_contiguous()
                      and k_scales.dtype == v_scales.dtype == torch.float32):
        raise ValueError("k_scales / v_scales must be contiguous float32 "
                         "(they are updated in place)")
    q, k_new, v_new = (t.contiguous() for t in (q, k_new, v_new))
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    cl = None if chunk_lens is None else chunk_lens.to(
        torch.int32).contiguous()
    half = 0
    cs = sn = None
    if cos_b is not None:
        half = int(cos_b.shape[-1])
        cs = cos_b.reshape(b, half).to(torch.float32).contiguous()
        sn = sin_b.reshape(b, half).to(torch.float32).contiguous()
    o = torch.empty_like(q)
    if b == 0:
        return o
    q, k_new, v_new = (_aligned16(t) for t in (q, k_new, v_new))
    for t in (k_pages, v_pages):
        _ptr_ok(t, 16)
    mb = tables.shape[1]
    # an item per group of up to 8 query heads of a kv head
    rep = h // hk
    ws, tickets, split, ws_items = _split_args(q, min(rep, 8), hk, bs, mb,
                                               groups=-(-rep // 8))
    fn = _build.function("paged_attention", "apex_paged_decode_fused", [
        ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    code = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
              k_pages.data_ptr(), v_pages.data_ptr(),
              k_scales.data_ptr() if coded else 0,
              v_scales.data_ptr() if coded else 0,
              tables.data_ptr(), lengths.data_ptr(),
              0 if cl is None else cl.data_ptr(),
              0 if cs is None else cs.data_ptr(),
              0 if sn is None else sn.data_ptr(), o.data_ptr(),
              ws.data_ptr(), tickets.data_ptr(),
              b, h, hk, d, nb, bs, mb, int(S), half, split, ws_items,
              float(scale) * _LOG2E,
              _qmax_for_pool(k_pages.dtype) if coded else 1.0,
              _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pages.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode_fused")
    return o


# --------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------- #
def _check_pool(q, k_pages, v_pages, block_tables, lengths, k_scales,
                v_scales):
    b, s, h, d = q.shape
    if k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages shapes differ: {tuple(k_pages.shape)} vs "
            f"{tuple(v_pages.shape)}")
    hk, nb, bs, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pages have {dk}")
    if h % hk:
        raise ValueError(f"kv_heads ({hk}) must divide num_heads ({h})")
    if block_tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {b}")
    quantized = k_pages.dtype in _QMAX_BY_DTYPE
    if quantized:
        if k_pages.dtype != v_pages.dtype:
            raise ValueError(
                f"k_pages/v_pages dtypes differ: {k_pages.dtype} vs "
                f"{v_pages.dtype}")
        if k_scales is None or v_scales is None:
            raise ValueError(
                f"quantized pages ({k_pages.dtype}) need k_scales AND "
                "v_scales (per-page fp32 amax arrays)")
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(sc.shape) != (hk, nb):
                raise ValueError(
                    f"{name} shape {tuple(sc.shape)} != (kv_heads, "
                    f"num_blocks) = {(hk, nb)}")
    elif k_scales is not None or v_scales is not None:
        raise ValueError(
            f"k_scales/v_scales only apply to quantized pools; pages are "
            f"{k_pages.dtype}")
    return quantized


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None,
                    implementation: Optional[str] = None,
                    k_scales=None, v_scales=None):
    """Attention of chunk queries over a paged pool (layouts in the
    module docstring); the chunk's own K/V must already be written.
    Quantized pools need ``k_scales`` / ``v_scales``.  ``implementation``
    as in :mod:`._dispatch`: under ``"auto"`` a CUDA call outside
    :func:`paged_kernel_ok` (head_dim not a multiple of 8 or above 256,
    pages of another float dtype) runs the plain version, logged once per
    shape.  A tensor-parallel pool: the module docstring."""
    _check_pool(q, k_pages, v_pages, block_tables, lengths, k_scales,
                v_scales)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if _route(implementation, q, k_pages, "paged_attention") == "torch":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    return _paged_kernel(q, k_pages, v_pages, block_tables, lengths, scale,
                         k_scales, v_scales)


def paged_decode_fused(q, k_new, v_new, k_pages, v_pages, block_tables,
                       lengths, *, max_seq_len: int, cos_b=None, sin_b=None,
                       scale: Optional[float] = None,
                       implementation: Optional[str] = None,
                       k_scales=None, v_scales=None, chunk_lens=None):
    """One decode step over the paged pool: per-row RoPE of ``q`` (b, 1,
    h, d) and ``k_new`` (b, 1, hk, d) with tables ``cos_b`` / ``sin_b``
    (b, 1, 1, rot/2) gathered at ``lengths`` (``None``: no rotation), the
    (quantized) write of the new K/V row at ``lengths[b]``, and the
    attend.  ``chunk_lens`` (quantized pools) routes pad rows (``<= 0``)
    to the null page.  The pool and scales are updated in place; returns
    ``(o, k_pages, v_pages[, k_scales, v_scales])``.  The kernel's
    written pages, codes and scales equal the plain version's bitwise on
    live pages; ``o`` agrees up to the order of the sums.  Any number of
    query heads per kv head.  ``implementation`` as in
    :func:`paged_attention`."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(
            f"paged_decode_fused handles the width-1 decode step only, "
            f"got s={s}")
    if tuple(k_new.shape) != tuple(v_new.shape):
        raise ValueError(
            f"k_new/v_new shapes differ: {tuple(k_new.shape)} vs "
            f"{tuple(v_new.shape)}")
    hk = k_pages.shape[0]
    if tuple(k_new.shape) != (b, 1, hk, d):
        raise ValueError(
            f"k_new shape {tuple(k_new.shape)} != (b, 1, kv_heads, d) = "
            f"{(b, 1, hk, d)}")
    if (cos_b is None) != (sin_b is None):
        raise ValueError("cos_b and sin_b come together")
    quantized = k_pages.dtype in _QMAX_BY_DTYPE
    if quantized and (k_scales is None or v_scales is None):
        raise ValueError(
            f"quantized pages ({k_pages.dtype}) need k_scales AND "
            "v_scales")
    if not quantized and (k_scales is not None or chunk_lens is not None):
        raise ValueError(
            "k_scales/v_scales/chunk_lens only apply to quantized pools; "
            f"pages are {k_pages.dtype}")
    _check_pool(q, k_pages, v_pages, block_tables, lengths, k_scales,
                v_scales)
    scale = (d ** -0.5) if scale is None else float(scale)
    if _route(implementation, q, k_pages, "paged_decode_fused") == "torch":
        return paged_decode_fused_reference(
            q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
            max_seq_len=int(max_seq_len), cos_b=cos_b, sin_b=sin_b,
            scale=scale, k_scales=k_scales, v_scales=v_scales,
            chunk_lens=chunk_lens)
    o = _decode_fused_kernel(q, k_new, v_new, k_pages, v_pages,
                             block_tables, lengths, int(max_seq_len), cos_b,
                             sin_b, scale, k_scales, v_scales, chunk_lens)
    if quantized:
        return o, k_pages, v_pages, k_scales, v_scales
    return o, k_pages, v_pages


def paged_cost_bytes(q, k_pages, lengths, *, written_rows: bool = False):
    """Device-memory bytes one call must move: every visible K/V row once
    (rows ``0 .. lengths[b] + s - 1``), the live pages' scales when
    coded, q read and o written, and, for the fused decode step, the new
    K/V rows read and written.  ``lengths`` on the host (list or array)."""
    b, s, h, d = q.shape
    hk, _nb, bs, _ = k_pages.shape
    lens = [int(x) for x in lengths]
    keys = sum(n + s for n in lens)
    pages = sum(math.ceil((n + s) / bs) for n in lens)
    kv_isz = k_pages.element_size()
    total = 2 * keys * hk * d * kv_isz + 2 * q.numel() * q.element_size()
    if k_pages.dtype in _QMAX_BY_DTYPE:
        total += 2 * pages * hk * 4
    if written_rows:
        total += 2 * b * hk * d * (q.element_size() + kv_isz)
    return total
