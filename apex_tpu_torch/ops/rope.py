"""Rotary position embedding (half rotation): CUDA kernel, plain PyTorch.

Counterpart of ``apex_tpu/ops/rope.py``.  The kernel (``csrc/rope.cu``)
replaces the Pallas ``_rope_kernel``: the first ``rot_dim`` channels of
every head are rotated as ``[x1, x2] -> [x1*cos - x2*sin,
x2*cos + x1*sin]`` in fp32, and the tail of a partial rotary span passes
through.  The gradient is the same rotation by ``-theta``: the backward
launches the same kernel with the sign of ``sin`` flipped, as
``_rope_pallas_bwd`` calls its kernel with ``-sin``.

The kernel reads its inputs through their strides (channels
contiguous) and writes contiguous outputs, and takes two operands in one
launch: the model rotates q and k with :func:`_rope_qk`, straight from
the packed qkv projection — in the grouped layout q is the ``(b, s, kv
heads, rep, d)`` view of it — without copying either.

Beside the shared ``(seq, rot_dim/2)`` tables of the JAX function, the
port takes per-row tables ``(batch, seq, rot_dim/2)``: the batched
serving engine rotates every slot at its own position, which the JAX
engine gets from its ``vmap`` over slots.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_rope", "rope_reference", "rope_cos_sin"]


def rope_cos_sin(seq_len: int, rot_dim: int, *, base: float = 10000.0,
                 dtype=torch.float32, device=None):
    """``(seq, rot_dim/2)`` cos/sin tables, computed in fp32 and then
    cast to ``dtype``, as the JAX package builds them."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def _as_4d(x, cos):
    """View ``x`` as ``(b, s, heads, d)`` for tables ``cos``."""
    if x.ndim == 4:
        return x
    if x.ndim != 3:
        raise ValueError(f"unsupported rope input rank {x.ndim}")
    if cos.ndim == 2 and x.shape[0] == cos.shape[0]:
        return x.unsqueeze(0)                   # (s, h, d)
    return x.unsqueeze(2)                       # (b, s, d)


def _check_tables(x4, cos, sin):
    b, s = x4.shape[0], x4.shape[1]
    if cos.shape != sin.shape:
        raise ValueError(
            f"cos {tuple(cos.shape)} and sin {tuple(sin.shape)} differ")
    want = (s, cos.shape[-1]) if cos.ndim == 2 else (b, s, cos.shape[-1])
    if tuple(cos.shape) != want:
        raise ValueError(
            f"rope tables {tuple(cos.shape)} do not match input "
            f"{tuple(x4.shape)}: want {want}")
    if 2 * cos.shape[-1] > x4.shape[-1]:
        raise ValueError(
            f"rotary span {2 * cos.shape[-1]} exceeds head_dim "
            f"{x4.shape[-1]}")


def rope_reference(x, cos, sin):
    """Plain composition (half rotation).

    ``x``: ``(b, s, heads, d)``, ``(s, heads, d)`` or ``(b, s, d)``;
    ``cos``/``sin``: ``(s, rot/2)`` shared over the batch or
    ``(b, s, rot/2)`` per row.  The tail of ``d`` beyond ``rot`` passes
    through unchanged.
    """
    x4 = _as_4d(x, cos)
    _check_tables(x4, cos, sin)
    half = cos.shape[-1]
    c = cos.float().unsqueeze(-2)               # broadcast over heads
    s = sin.float().unsqueeze(-2)
    xf1 = x4[..., :half].float()
    xf2 = x4[..., half:2 * half].float()
    o1 = xf1 * c - xf2 * s
    o2 = xf2 * c + xf1 * s
    y = torch.cat([o1.to(x.dtype), o2.to(x.dtype), x4[..., 2 * half:]],
                  dim=-1)
    return y.reshape(x.shape)


def _operand(x):
    """``(x, heads, rep, strides)`` of a ``(b, s, heads, d)`` tensor or a
    grouped ``(b, s, groups, rep, d)`` view: the element strides of its
    ``(b, s, groups, rep)`` axes, its channels made contiguous."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    if x.ndim == 4:
        return x, x.shape[2], 1, (*x.stride()[:3], 0)
    return x, x.shape[2] * x.shape[3], x.shape[3], tuple(x.stride()[:4])


def _span(x):
    """Elements from the first to the last that ``x`` addresses."""
    return 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))


def _rope_launch(xs, cos, sin, sign):
    """Rotate each of ``xs`` (one or two operands of one batch, sequence,
    head dim and dtype, as :func:`_operand` takes them) in one kernel
    launch, by ``-theta`` for ``sign`` -1; returns their contiguous
    ``(b, s, heads, d)`` outputs."""
    x0 = xs[0]
    if x0.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported dtype {x0.dtype}")
    if any(x.dtype != x0.dtype or x.device != x0.device for x in xs):
        raise ValueError("rope operands differ in dtype or device")
    if cos.device != x0.device or sin.device != x0.device:
        raise ValueError("rope tables must be on the input's device")
    b, s, d = x0.shape[0], x0.shape[1], x0.shape[-1]
    ops = [_operand(x) for x in xs]
    outs = [torch.empty((b, s, heads, d), dtype=x0.dtype, device=x0.device)
            for _, heads, _, _ in ops]
    if b * s * d == 0 or sum(heads for _, heads, _, _ in ops) == 0:
        return outs
    c = cos.to(torch.float32).contiguous()
    sn = sin.to(torch.float32).contiguous()
    half = c.shape[-1]
    vec = 16 // x0.element_size()
    whole = (half % vec == 0 and d % vec == 0
             and all(t.data_ptr() % 16 == 0 for t in (c, sn, *outs))
             and all(x.data_ptr() % 16 == 0 and all(
                 st % vec == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1])
                 if n > 1)
                 for x, _, _, _ in ops))
    idx64 = max(*(_span(x) for x, _, _, _ in ops),
                *(y.numel() for y in outs), c.numel()) >= 2 ** 31
    args = []
    for (x, heads, rep, st), y in zip(ops, outs):
        args += [x.data_ptr(), y.data_ptr(), *st, heads, rep]
    if len(ops) == 1:
        args += [None, None, 0, 0, 0, 0, 0, 1]
    operand = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 4 \
        + [ctypes.c_int] * 2
    fn = _build.function("rope", "apex_rope", operand * 2 + [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    code = fn(*args, c.data_ptr(), sn.data_ptr(), b, s, d, half,
              int(c.ndim == 3), float(sign), _build.DTYPE_CODES[x0.dtype],
              vec if whole else 1, int(idx64),
              torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(code, "rope")
    return outs


def _rope_kernel(x, cos, sin, sign=1.0):
    x4 = _as_4d(x, cos)
    _check_tables(x4, cos, sin)
    return _rope_launch([x4], cos, sin, sign)[0].reshape(x.shape)


class _RopeFn(torch.autograd.Function):
    """Rotation forward; rotation by ``-theta`` backward (the tables
    are constants)."""

    @staticmethod
    def forward(ctx, x, cos, sin, kernel):
        ctx.save_for_backward(cos, sin)
        ctx.kernel = kernel
        return (_rope_kernel if kernel else rope_reference)(x, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        if ctx.kernel:
            return _rope_kernel(dy, cos, sin, -1.0), None, None, None
        return rope_reference(dy, cos, -sin), None, None, None


def fused_rope(x, cos, sin, *, implementation: Optional[str] = None):
    """Apply rotary position embedding; differentiable in ``x``.

    Shapes as in :func:`rope_reference`; output in ``x.dtype``.
    ``implementation`` as in :mod:`._dispatch`.
    """
    kernel = resolve_impl(implementation, x) == "kernel"
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeFn.apply(x, cos.detach(), sin.detach(), kernel)
    return (_rope_kernel if kernel else rope_reference)(x, cos, sin)


def _rope_pair(q, k, cos, sin, sign, kernel):
    """``q`` and ``k`` rotated (by ``-theta`` for ``sign`` -1): one kernel
    launch, or the plain version twice."""
    b, s, d = k.shape[0], k.shape[1], k.shape[-1]
    if k.ndim != 4 or q.ndim not in (4, 5) or (
            q.shape[0], q.shape[1], q.shape[-1]) != (b, s, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} are "
                         "not (b, s, heads, d) operands of one (b, s, d)")
    _check_tables(k, cos, sin)
    if kernel:
        return tuple(_rope_launch([q, k], cos, sin, sign))
    sn = sin if sign > 0 else -sin
    return (rope_reference(q.reshape(b, s, -1, d), cos, sn),
            rope_reference(k, cos, sn))


class _RopeQKFn(torch.autograd.Function):
    """q and k rotated in one launch forward, dq and dk by ``-theta`` in
    one launch backward."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, kernel):
        ctx.save_for_backward(cos, sin)
        ctx.kernel, ctx.q_shape = kernel, q.shape
        return _rope_pair(q, k, cos, sin, 1.0, kernel)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        gq, gk = _rope_pair(dq, dk, cos, sin, -1.0, ctx.kernel)
        return gq.reshape(ctx.q_shape), gk, None, None, None


def _rope_qk(q, k, cos, sin, *, implementation: Optional[str] = None):
    """Rotate the model's q and k together; differentiable in both.

    ``q``: ``(b, s, h, d)``, or the grouped qkv layout's ``(b, s, hk,
    rep, d)`` view; ``k``: ``(b, s, hk, d)``; either may be a strided
    view of the packed projection.  Tables as in :func:`rope_reference`.
    Returns ``(b, s, h, d)`` and ``(b, s, hk, d)``: on a CUDA tensor from
    one kernel launch (one backward launch too), equal to two
    :func:`fused_rope` calls.
    """
    kernel = resolve_impl(implementation, q) == "kernel"
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _RopeQKFn.apply(q, k, cos.detach(), sin.detach(), kernel)
    return _rope_pair(q, k, cos, sin, 1.0, kernel)
