"""Flash multi-head attention — CUDA kernels plus plain PyTorch.

Counterpart of ``apex_tpu/ops/attention.py``.  Layout ``(batch, seq,
heads, head_dim)`` (BSHD), GQA through fewer kv heads.  Three kernels
(``csrc/flash_attention.cu``) replace the Pallas ones:

- ``_fa_fwd_kernel``: ``o`` and the log2-domain logsumexp per query
  row, by online softmax over key tiles;
- ``_fa_bwd_dq_kernel``: ``dq`` from the saved logsumexp;
- ``_fa_bwd_dkv_kernel``: ``dk``, ``dv``, each kv head summing its
  GQA group of query heads in the kernel's fp32 accumulators.

bf16/fp16 inputs run the kernels' products on the tensor cores as
Hopper kernels (TMA loads, wgmma, the softmax or dS on the accumulators
in registers; 128 query rows or keys a block): all three kernels at
head_dim 64, 80 (ViT-Huge's) and 128.  fp32 and the other head dims run
them as fp32 FMA (64 rows a block, 32 above head_dim 128).
:func:`flash_route` says which a kernel takes.

The kernels take every head_dim of the JAX package's Pallas envelope
(``d % 8 == 0``) up to :data:`MAX_HEAD_DIM`, any ``batch * heads``, and
ragged sequence lengths.  :func:`flash_kernel_ok` is the envelope: under
``"auto"`` a CUDA call outside it (``d % 8 != 0`` or q, k, v of mixed
dtypes, which the JAX package also sends to its composition; head_dim
above 256, which no preset of the repo's models reaches) runs the
plain versions, as ``implementation="torch"`` does, with a log line once
per shape.
Softmax, masks and dropout are fp32 either way, and a probability or dS
entering the next product is rounded to the input dtype first, as the
Pallas kernels do.  ``delta = rowsum(dO * O)`` is plain PyTorch, as XLA
computes it in the JAX package.  Beside each kernel is its plain version
(:func:`flash_fwd_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference`), with the kernel's semantics: the
CPU path and the yardstick the kernels are held against on the card.
:func:`attention_reference` is the JAX package's differentiable
composition, the golden semantics of the whole function.
:func:`flash_fwd` is the forward as one dispatcher op
(``torch.ops.apex_tpu_torch.flash_fwd``) with the saved-logsumexp
backward registered on it, so a selective checkpoint policy can keep
its ``(o, lse)``.

Attention-probability dropout is the JAX package's counter hash
(murmur3 ``fmix32`` of seed, lane, query and key position), so
:func:`dropout_keep_mask` equals the JAX mask bit for bit for the same
integer seed, and the kernels regenerate it without storing a mask.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_attention", "attention_reference", "mask_to_bias",
           "flash_kernel_ok", "MAX_HEAD_DIM",
           "dropout_keep_mask", "flash_fwd_reference",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
           "flash_fwd", "flash_route",
           "attention_delta"]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_U32 = 0xFFFFFFFF
#: the FMA kernels' tile (rows of q and of k per block); the Hopper
#: kernels take 128 rows of q or k a block
BLOCK = 64
#: the widest head_dim the kernels take
MAX_HEAD_DIM = 256
_logger = logging.getLogger(__name__)


def flash_kernel_ok(d: int, same_dtype: bool = True) -> bool:
    """Whether the flash kernels take head_dim ``d`` (with q, k and v of
    one dtype when ``same_dtype``): the JAX package's Pallas envelope
    (``d % 8 == 0``, one dtype; its tile conditions do not apply, as the
    kernels mask ragged tiles) up to :data:`MAX_HEAD_DIM`."""
    return d % 8 == 0 and d <= MAX_HEAD_DIM and bool(same_dtype)


# ------------------------------------------------------------------ #
# dropout counter hash (uint32 arithmetic carried in int64)
# ------------------------------------------------------------------ #
def _fmix32(x):
    """murmur3 finalizer on int64 tensors holding uint32 values; every
    product is cut back to 32 bits (int64 multiplication wraps, which
    keeps the low 32 bits exact)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    return x ^ (x >> 16)


def _drop_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_mask(seed, b, h, sq, sk, rate, device=None, lanes=None):
    """``(b, h, sq, sk)`` boolean keep-mask of the counter hash,
    bit-identical to the JAX package's ``dropout_keep_mask``: the lane
    is ``batch * h + head``, the integer ``seed`` an int32 taken as
    uint32 (``None`` is 0).  ``lanes`` ``(heads, offset)``: the ``h``
    heads are heads ``offset ..`` of ``heads`` (a tensor-parallel rank's
    share), whose lanes are ``batch * heads + offset + head`` — the mask
    of those heads in the unsharded call."""
    seed_u = (0 if seed is None else int(seed)) & _U32
    heads, offset = lanes if lanes is not None else (h, 0)
    lane = (torch.arange(b, dtype=torch.int64, device=device).view(
        b, 1, 1, 1) * heads + offset + torch.arange(
        h, dtype=torch.int64, device=device).view(1, h, 1, 1))
    hh = seed_u ^ ((lane * 0x9E3779B9) & _U32)
    q_pos = torch.arange(sq, dtype=torch.int64, device=device).view(
        1, 1, sq, 1)
    k_pos = torch.arange(sk, dtype=torch.int64, device=device).view(
        1, 1, 1, sk)
    row = _fmix32((((q_pos * 0x9E3779B9) & _U32) + hh) & _U32)
    x = _fmix32(row ^ ((k_pos * 0x85EBCA6B) & _U32))
    return x >= _drop_threshold(rate)


def mask_to_bias(masked):
    """Boolean mask (True = masked) → additive fp32 bias at the -1e30
    sentinel, which the kernels' dead-position zeroing recognises."""
    return torch.where(masked, torch.tensor(_NEG_INF, dtype=torch.float32,
                                            device=masked.device),
                       torch.tensor(0.0, dtype=torch.float32,
                                    device=masked.device))


# ------------------------------------------------------------------ #
# the JAX package's composition (golden semantics)
# ------------------------------------------------------------------ #
def _dead_positions(sq, sk, causal, window, device):
    """``(sq, sk)`` True where the causal / window mask hides a key, or
    None without masking."""
    if not causal:
        return None
    q_idx = torch.arange(sq, device=device)[:, None]
    k_idx = torch.arange(sk, device=device)[None, :]
    dead = k_idx > q_idx + (sk - sq)
    if window is not None:
        dead = dead | (k_idx <= q_idx + (sk - sq) - window)
    return dead


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, bias=None,
                        window: Optional[int] = None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        dropout_lanes=None):
    """Plain differentiable attention: softmax(q·kᵀ·scale + bias
    [causal]) · v in fp32, output in ``q.dtype``.  Rows with no visible
    key output zeros; dropout drops post-softmax probabilities with
    :func:`dropout_keep_mask`."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    b, sq, h, d = q.shape
    hk = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    dead = _dead_positions(sq, sk, causal, window, q.device)
    if dead is not None:
        s = s.masked_fill(dead, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if causal or bias is not None:
        p = torch.where(s < 0.5 * _NEG_INF, torch.zeros_like(p), p)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, b, h, sq, sk, dropout_rate,
                                 q.device, dropout_lanes)
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


# ------------------------------------------------------------------ #
# plain versions of the three kernels
# ------------------------------------------------------------------ #
def _scores_log2(q, k, bias, scale, causal, window):
    """``(b, h, sq, sk)`` log2-domain scores as the kernels form them,
    dead positions at the sentinel."""
    sq, h = q.shape[1], q.shape[2]
    sk, hk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (scale * _LOG2E)
    if bias is not None:
        s = s + bias.float() * _LOG2E
    dead = _dead_positions(sq, sk, causal, window, q.device)
    if dead is not None:
        s = s.masked_fill(dead, _NEG_INF)
    return s


def _probs(s, m):
    p = torch.exp2(s - m)
    return torch.where(s < 0.5 * _NEG_INF, torch.zeros_like(p), p)


def _as_operand(t, dtype):
    """``t`` rounded to ``dtype`` where it feeds the next product, as
    the kernels (and the Pallas ones) feed it; kept in fp32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _keep(q, k, rate, seed, lanes):
    b, sq, h = q.shape[:3]
    return dropout_keep_mask(seed, b, h, sq, k.shape[1], rate, q.device,
                             lanes)


def flash_fwd_reference(q, k, v, bias, scale, causal, window, rate, seed,
                        lanes=None):
    """Plain version of the forward kernel: ``(o, lse)``, ``o`` like
    ``q`` and ``lse`` ``(b*h, sq)`` fp32 in the log2 domain (-1e30 on a
    row with no visible key).  Softmax in fp32; the probabilities enter
    the value product in the input dtype.  ``lanes``: the dropout lanes
    of :func:`dropout_keep_mask`."""
    b, sq, h, d = q.shape
    s = _scores_log2(q, k, bias, scale, causal, window)
    m = s.amax(-1, keepdim=True).clamp(min=_NEG_INF)
    p = _probs(s, m)
    ls = p.sum(-1, keepdim=True)
    ls = torch.where(ls == 0, torch.ones_like(ls), ls)
    if rate > 0.0:
        p = torch.where(_keep(q, k, rate, seed, lanes),
                        p * (1.0 / (1.0 - rate)),
                        torch.zeros_like(p))
    vf = v.float().repeat_interleave(h // v.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", _as_operand(p, v.dtype), vf) \
        / ls.permute(0, 2, 1, 3)
    lse = (m + torch.log2(ls)).reshape(b * h, sq)
    return o.to(q.dtype), lse


def _bwd_parts(q, k, v, bias, dout, lse, delta, scale, causal, window,
               rate, seed, lanes):
    """(dropped p, dS) of the backward, ``(b, h, sq, sk)`` fp32, each
    rounded to the input dtype as the operand of its product."""
    b, sq, h, d = q.shape
    s = _scores_log2(q, k, bias, scale, causal, window)
    p = _probs(s, lse.view(b, h, sq, 1))
    vf = v.float().repeat_interleave(h // v.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    pd = p
    if rate > 0.0:
        keep = _keep(q, k, rate, seed, lanes)
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    ds = p * (dp - delta.view(b, h, sq, 1))
    return _as_operand(pd, q.dtype), _as_operand(ds, q.dtype)


def flash_bwd_dq_reference(q, k, v, bias, dout, lse, delta, scale, causal,
                           window, rate, seed, lanes=None):
    """Plain version of the dq kernel."""
    h, hk = q.shape[2], k.shape[2]
    _, ds = _bwd_parts(q, k, v, bias, dout, lse, delta, scale, causal,
                       window, rate, seed, lanes)
    kf = k.float().repeat_interleave(h // hk, dim=2)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, bias, dout, lse, delta, scale, causal,
                            window, rate, seed, lanes=None):
    """Plain version of the dk/dv kernel, GQA groups summed: ``(dk,
    dv)`` like ``k``, ``v``."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    pd, ds = _bwd_parts(q, k, v, bias, dout, lse, delta, scale, causal,
                        window, rate, seed, lanes)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, dout.float())
    dk = dk.view(b, sk, hk, h // hk, d).sum(3)
    dv = dv.view(b, sk, hk, h // hk, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(dout, o):
    """``delta = rowsum(dO * O)`` as ``(b*h, sq)`` fp32, the backward
    kernels' per-row term."""
    b, sq, h, _ = o.shape
    return (dout.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, sq).contiguous()


# ------------------------------------------------------------------ #
# kernel wrappers
# ------------------------------------------------------------------ #
def _common_args(q, k, v, bias, scale, causal, window, rate, seed, lanes):
    """Checked, contiguous operands and the C entries' common argument
    list; ``keep`` holds tensors that must outlive the launch."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in _build.FLOAT_CODES:
        raise TypeError(
            f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: one of "
            f"{tuple(_build.FLOAT_CODES)} is needed")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if not flash_kernel_ok(d):
        raise ValueError(f"head_dim {d}: the kernels take d <= "
                         f"{MAX_HEAD_DIM}, a multiple of 8")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    keep = [q, k, v]
    bias_ptr, strides = None, (0, 0, 0)
    if bias is not None:
        bf = bias.to(device=q.device, dtype=torch.float32)
        bf = bf.expand(b, h, sq, sk)
        if bf.stride(3) != 1:
            bf = bf.contiguous()
        keep.append(bf)
        bias_ptr = bf.data_ptr()
        strides = (bf.stride(0), bf.stride(1), bf.stride(2))
    heads, offset = lanes if lanes is not None else (h, 0)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
            b, h, hk, sq, sk, d, float(scale), int(bool(causal)),
            int(window or 0), (0 if seed is None else int(seed)) & _U32,
            _drop_threshold(rate) if rate > 0.0 else 0,
            float(1.0 / (1.0 - rate)) if rate > 0.0 else 1.0,
            int(rate > 0.0), int(heads), int(offset),
            _build.DTYPE_CODES[q.dtype]]
    return q, k, v, keep, args


def _aligned(t):
    """``t``, copied if its data does not start on 16 bytes (the Hopper
    kernels load it by TMA)."""
    return t.clone() if t.data_ptr() % 16 else t


_COMMON_TYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_ROUTE_KERNELS = ("fwd", "dq", "dkv")


def flash_route(kernel: str, dtype: torch.dtype, d: int) -> str:
    """``"wgmma"`` or ``"fma"``: the kernels that ``kernel`` (``"fwd"``,
    ``"dq"`` or ``"dkv"``) runs on the card for inputs of ``dtype`` at
    head_dim ``d``, as the built library decides (``apex_fa_route``).
    Builds the library at first use and launches nothing."""
    fn = _build.function("flash_attention", "apex_fa_route",
                         [ctypes.c_int] * 3)
    return "wgmma" if fn(_ROUTE_KERNELS.index(kernel),
                         _build.FLOAT_CODES[dtype], int(d)) else "fma"


def flash_fwd_kernel(q, k, v, bias, scale, causal, window, rate, seed,
                     lanes=None):
    """The forward kernel: ``(o, lse)`` as :func:`flash_fwd_reference`."""
    q, k, v, keep, args = _common_args(q, k, v, bias, scale, causal,
                                       window, rate, seed, lanes)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0 or k.shape[1] == 0:
        return o.zero_(), lse.fill_(_NEG_INF)
    fn = _build.function("flash_attention", "apex_fa_fwd", _COMMON_TYPES + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    code = fn(*args, o.data_ptr(), lse.data_ptr(), _stream(q))
    _build.check(code, "flash_attention_fwd")
    return o, lse


def flash_bwd_dq_kernel(q, k, v, bias, dout, lse, delta, scale, causal,
                        window, rate, seed, lanes=None):
    """The dq kernel: ``dq`` like ``q``."""
    q, k, v, keep, args = _common_args(q, k, v, bias, scale, causal,
                                       window, rate, seed, lanes)
    dout = _aligned(dout.to(q.dtype).contiguous())
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty_like(q)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    fn = _build.function("flash_attention", "apex_fa_bwd_dq",
                         _COMMON_TYPES + [ctypes.c_void_p] * 5)
    code = fn(*args, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), _stream(q))
    _build.check(code, "flash_attention_bwd_dq")
    return dq


def flash_bwd_dkv_kernel(q, k, v, bias, dout, lse, delta, scale, causal,
                         window, rate, seed, lanes=None):
    """The dk/dv kernel: ``(dk, dv)`` like ``k``, ``v``; under GQA each
    kv head sums its group of query heads inside the kernel."""
    q, k, v, keep, args = _common_args(q, k, v, bias, scale, causal,
                                       window, rate, seed, lanes)
    dout = _aligned(dout.to(q.dtype).contiguous())
    lse, delta = lse.contiguous(), delta.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    fn = _build.function("flash_attention", "apex_fa_bwd_dkv",
                         _COMMON_TYPES + [ctypes.c_void_p] * 6)
    code = fn(*args, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), _stream(q))
    _build.check(code, "flash_attention_bwd_dkv")
    return dk, dv


# ------------------------------------------------------------------ #
# autograd
# ------------------------------------------------------------------ #
@torch.library.custom_op("apex_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], scale: float, causal: bool,
              window: Optional[int], rate: float, seed: int,
              lane_heads: int, lane_offset: int,
              kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as one dispatcher op, ``(o, lse)`` — the JAX
    kernel's residuals ``attn_out`` and ``attn_lse``: a selective
    checkpoint policy can keep both and skip the forward in the
    recomputation (``TransformerConfig.remat_policy``).  ``lane_heads``
    / ``lane_offset``: the dropout lanes (``dropout_keep_mask``'s
    ``lanes``).  ``kernel`` picks :func:`flash_fwd_kernel` or
    :func:`flash_fwd_reference`."""
    fwd = flash_fwd_kernel if kernel else flash_fwd_reference
    return fwd(q, k, v, bias, scale, causal, window, rate, seed,
               (lane_heads, lane_offset))


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, bias, scale, causal, window, rate, seed,
                    lane_heads, lane_offset, kernel):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, sq),
                                            dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    """Saved-logsumexp backward of ``_fa_pallas_fwd`` / ``_fa_pallas_bwd``;
    the bias is a constant."""
    (q, k, v, bias, scale, causal, window, rate, seed, lane_heads,
     lane_offset, kernel) = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, bias, o, lse)
    ctx.cfg = (scale, causal, window, rate, seed, (lane_heads, lane_offset))
    ctx.kernel = kernel
    ctx.set_materialize_grads(False)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, bias, o, lse = ctx.saved_tensors
    if dout is None:
        return (None,) * 12
    delta = attention_delta(dout, o)
    if ctx.kernel:
        dq_fn, dkv_fn = flash_bwd_dq_kernel, flash_bwd_dkv_kernel
    else:
        dq_fn, dkv_fn = flash_bwd_dq_reference, flash_bwd_dkv_reference
    args = (q, k, v, bias, dout, lse, delta, *ctx.cfg)
    dq = dq_fn(*args) if ctx.needs_input_grad[0] else None
    dk = dv = None
    if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
        dk, dv = dkv_fn(*args)
    return (dq, dk, dv) + (None,) * 9


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


def fused_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, bias=None,
                    bias_requires_grad: bool = False,
                    window: Optional[int] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    dropout_lanes: Optional[Tuple[int, int]] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    implementation: Optional[str] = None):
    """Flash multi-head attention (BSHD), O(S) memory.

    ``bias``: an additive fp32 bias broadcastable to ``(b, h, sq, sk)``
    (key padding from :func:`mask_to_bias`, per-head, per-query), a
    constant for the backward; ``bias_requires_grad=True`` takes the
    differentiable composition :func:`attention_reference` instead (a
    learned bias), as the JAX API routes it.  ``window``: sliding window
    (requires ``causal``).  ``dropout_rate`` with an integer
    ``dropout_seed`` (the caller draws it, e.g. from a
    ``torch.Generator``) drops probabilities with the counter hash;
    ``dropout_lanes`` ``(heads, offset)``: ``q``'s heads are heads
    ``offset ..`` of a call with ``heads`` (a tensor-parallel rank's
    heads), and drop as they would there (:func:`dropout_keep_mask`).
    ``block_q`` / ``block_k``: tile hints, as in the JAX package; any
    positive value is taken and ignored — the kernels choose their own
    tiles (64 or 128 rows) and the outputs do not depend on the tile.
    ``implementation`` as in :mod:`._dispatch`; under ``"auto"`` a CUDA
    call outside :func:`flash_kernel_ok` (head_dim not a multiple of 8
    or above 256, mixed dtypes) runs the plain versions, as
    ``implementation="torch"`` does, logged once per shape.
    """
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(
            f"num_kv_heads ({hk}) must divide num_heads ({h})")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and int(blk) < 1:
            raise ValueError(f"{name} must be a positive tile hint, got "
                             f"{blk}")
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not causal:
            raise ValueError(
                "sliding-window attention requires causal=True")
        if window >= sk:
            window = None              # the window covers everything
    scale = (d ** -0.5) if scale is None else float(scale)
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError(
            "fused_attention: dropout_rate > 0 requires dropout_seed (an "
            "integer) — a silent constant seed would drop the same "
            "positions every step")
    seed = int(dropout_seed) if rate > 0.0 else 0
    kernel = resolve_impl(
        implementation, q, inside=flash_kernel_ok(
            d, q.dtype == k.dtype == v.dtype),
        op="fused_attention", shape=(tuple(q.shape), str(q.dtype),
                                     str(k.dtype), str(v.dtype)),
        why=f"head_dim {d} or dtypes outside d % 8 == 0, d <= "
            f"{MAX_HEAD_DIM}, one dtype") == "kernel"
    if bias is not None and bias_requires_grad:
        _logger.info("fused_attention: bias_requires_grad takes the O(S^2) "
                     "differentiable composition; q=%s bias=%s",
                     tuple(q.shape), tuple(bias.shape))
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   bias=bias, window=window,
                                   dropout_rate=rate, dropout_seed=seed,
                                   dropout_lanes=dropout_lanes)
    if bias is not None:
        bias = bias.detach()
    heads, offset = dropout_lanes if dropout_lanes is not None else (h, 0)
    return flash_fwd(q, k, v, bias, scale, bool(causal), window, rate,
                     seed, int(heads), int(offset), kernel)[0]
