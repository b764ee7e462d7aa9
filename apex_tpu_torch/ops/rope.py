"""Rotary position embedding (half rotation): CUDA kernel, plain PyTorch.

Counterpart of ``apex_tpu/ops/rope.py``.  The kernel (``csrc/rope.cu``)
replaces the Pallas ``_rope_kernel``: the first ``rot_dim`` channels of
every head are rotated as ``[x1, x2] -> [x1*cos - x2*sin,
x2*cos + x1*sin]`` in fp32, and the tail of a partial rotary span passes
through.  The gradient is the same rotation by ``-theta``: the backward
launches the same kernel with ``-sin``, as ``_rope_pallas_bwd`` does.

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


def _rope_kernel(x, cos, sin):
    if x.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    x4 = _as_4d(x, cos)
    _check_tables(x4, cos, sin)
    if cos.device != x.device or sin.device != x.device:
        raise ValueError("rope tables must be on the input's device")
    b, s, h, d = x4.shape
    x4 = x4.contiguous()
    c = cos.to(torch.float32).contiguous()
    sn = sin.to(torch.float32).contiguous()
    y = torch.empty_like(x4)
    rows = b * s * h
    if rows == 0:
        return y.reshape(x.shape)
    fn = _build.function("rope", "apex_rope_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    code = fn(x4.data_ptr(), c.data_ptr(), sn.data_ptr(), y.data_ptr(),
              rows, s, h, d, c.shape[-1], int(c.ndim == 3),
              _build.DTYPE_CODES[x.dtype],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rope")
    return y.reshape(x.shape)


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
        fn = _rope_kernel if ctx.kernel else rope_reference
        return fn(dy.contiguous(), cos, -sin), None, None, None


def fused_rope(x, cos, sin, *, implementation: Optional[str] = None):
    """Apply rotary position embedding; differentiable in ``x``.

    Shapes as in :func:`rope_reference`; output in ``x.dtype``.
    ``implementation`` as in :mod:`._dispatch`.
    """
    kernel = resolve_impl(implementation, x) == "kernel"
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeFn.apply(x, cos.detach(), sin.detach(), kernel)
    return (_rope_kernel if kernel else rope_reference)(x, cos, sin)
