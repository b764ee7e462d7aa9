"""Fused scale-mask-softmax (Megatron's attention-score softmax): CUDA
kernels plus plain PyTorch.

Counterpart of ``apex_tpu/ops/softmax.py``.  The kernels
(``csrc/softmax.cu``, persistent row pipelines) replace the
Pallas ``_softmax_fwd_kernel`` —
``softmax(where(mask, -30000, x * scale))`` over the last axis, with the
causal fill ``k > q + (sk - sq)``, in fp32, stored in ``x.dtype`` — and
``_softmax_bwd_kernel`` — ``dx = (dy - sum(dy * y)) * y * scale`` from
the saved output.  The fill is -30000 after scaling, not -inf, so a fully
masked row comes out uniform ``1 / sk``.  The mask is boolean (True =
masked out) and broadcastable to ``x``; the kernel reads it through its
broadcast strides.  Any ``sk`` works (the JAX package's ``sk % 128``
envelope is a TPU tiling rule).

The gradient follows the path the JAX package's dispatch takes at each
width (``apex_tpu/ops/softmax.py:190``): where ``sk % 128 == 0`` it runs
the Pallas kernels, whose backward is the formula above — nonzero on a
fully masked row; elsewhere it differentiates the reference composition
through ``where``, which gives ``dx = 0`` at every masked position.  The
port's backward (kernel and plain alike) takes the mask and the causal
flag and writes those zeros at the widths where JAX would; on a partly
masked row that changes nothing, since ``y`` is 0 at its masked places.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_scale_mask_softmax", "scale_mask_softmax_reference",
           "softmax_bwd_reference", "softmax_fwd_kernel",
           "softmax_bwd_kernel"]

_NEG = -30000.0  # large-negative fill, safe in fp16 (the reference's)


def scale_mask_softmax_reference(x, mask=None, scale: float = 1.0,
                                 causal: bool = False):
    """Plain composition: ``softmax(x*scale masked_fill mask)`` in fp32,
    returned in ``x.dtype`` (``scale_mask_softmax_reference`` of the JAX
    package, with ``jax.nn.softmax``'s ``exp(x - max) / sum``)."""
    xf = x.float() * scale
    if mask is not None:
        xf = torch.where(mask.to(torch.bool), _NEG, xf)
    if causal:
        sq, sk = x.shape[-2], x.shape[-1]
        q = torch.arange(sq, device=x.device)[:, None]
        k = torch.arange(sk, device=x.device)[None, :]
        xf = torch.where(k > q + (sk - sq), _NEG, xf)
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_bwd_reference(dy, y, scale: float = 1.0, mask=None,
                          causal: bool = False):
    """Plain composition of the backward: ``(dy - sum(dy*y)) * y *
    scale`` in fp32, in ``dy.dtype``; with a ``mask`` or ``causal``, 0
    at every masked position (the ``where`` gradient of the reference
    composition)."""
    dyf, yf = dy.float(), y.float()
    inner = (dyf * yf).sum(-1, keepdim=True)
    dx = (dyf - inner) * yf * scale
    dead = _masked(dy.shape, mask, causal, dy.device)
    if dead is not None:
        dx = torch.where(dead, 0.0, dx)
    return dx.to(dy.dtype)


def _masked(shape, mask, causal, device):
    """Boolean positions masked out by ``mask`` or the causal fill,
    broadcastable to ``shape``; None when neither is given."""
    dead = None if mask is None else mask.to(torch.bool)
    if causal:
        sq, sk = shape[-2], shape[-1]
        q = torch.arange(sq, device=device)[:, None]
        k = torch.arange(sk, device=device)[None, :]
        c = k > q + (sk - sq)
        dead = c if dead is None else dead | c
    return dead


def _zero_masked(sk: int) -> bool:
    """Whether the backward zeroes masked positions at width ``sk``: where
    the JAX dispatch takes the reference composition, ``sk % 128 != 0``."""
    return sk % 128 != 0


def _dims(shape):
    """``(B, heads, sq, sk)`` of a score tensor of any rank."""
    sk = shape[-1] if len(shape) >= 1 else 1
    sq = shape[-2] if len(shape) >= 2 else 1
    heads = shape[-3] if len(shape) >= 3 else 1
    return math.prod(shape[:-3]), heads, sq, sk


def _vec(sk, *tensors):
    """Whether 16-byte loads fit: ``sk`` a multiple of the vector and
    every pointer 16-byte aligned."""
    isz = tensors[0].element_size()
    return int(sk % (16 // isz) == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _magic(d: int) -> tuple:
    """``(m, l)`` with ``x // d == (umulhi(x, m) + x) >> l`` for every
    ``0 <= x < 2^31`` (Granlund and Montgomery's round-up multiplier: ``l
    = ceil(log2 d)``, ``m = floor(2^32 (2^l - d) / d) + 1``): the forward
    and backward kernels' row splits into (batch, head, query)."""
    d = int(d)
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


def _magic_div(x: int, magic: tuple) -> int:
    """``x // d`` as the kernel computes it from ``_magic(d)``."""
    m, l = magic
    return (((x * m) >> 32) + x) >> l


def _mask_view(mask, x):
    """The mask (or None) as a ``(B, heads, sq, sk)`` broadcast view of
    bytes and its element strides."""
    if mask is None:
        return None, (0, 0, 0, 0)
    if mask.device != x.device:
        raise ValueError("mask must be on the input's device")
    b, heads, sq, sk = _dims(tuple(x.shape))
    m4 = mask.to(torch.bool).expand(x.shape).reshape(b, heads, sq, sk)
    return m4, m4.stride()


def softmax_fwd_kernel(x, mask=None, scale: float = 1.0,
                       causal: bool = False):
    """The forward kernel on a CUDA tensor: ``y`` in ``x.dtype``."""
    if x.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"softmax kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    b, heads, sq, sk = _dims(tuple(x.shape))
    rows = x.numel() // max(sk, 1)
    if x.numel() == 0:
        return y
    m4, strides = _mask_view(mask, x)
    fn = _build.function("softmax", "apex_softmax_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p])
    code = fn(x.data_ptr(), None if m4 is None else m4.data_ptr(),
              y.data_ptr(), rows, sk, sq, heads, *strides, int(causal),
              float(scale), _build.DTYPE_CODES[x.dtype], _vec(sk, x, y),
              *_magic(sq), *_magic(heads),
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "softmax_fwd")
    return y


def softmax_bwd_kernel(dy, y, scale: float = 1.0, mask=None,
                       causal: bool = False):
    """The backward kernel on CUDA tensors: ``dx`` in ``dy.dtype`` from
    the saved ``y``; with a ``mask`` or ``causal``, 0 at every masked
    position (the kernel writes the zeros)."""
    if dy.shape != y.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != y {tuple(y.shape)}")
    if dy.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported dtype {dy.dtype}")
    if not dy.is_cuda:
        raise ValueError(
            f"softmax kernel needs a CUDA tensor, got {dy.device}")
    dy = dy.contiguous()
    y = y.to(dy.dtype).contiguous()
    dx = torch.empty_like(dy)
    if dy.numel() == 0:
        return dx
    b, heads, sq, sk = _dims(tuple(dy.shape))
    m4, strides = _mask_view(mask, dy)
    fn = _build.function("softmax", "apex_softmax_bwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_uint,
        ctypes.c_int, ctypes.c_void_p])
    code = fn(dy.data_ptr(), y.data_ptr(),
              None if m4 is None else m4.data_ptr(), dx.data_ptr(),
              dy.numel() // sk, sk, sq, heads, *strides, int(causal),
              float(scale), _build.DTYPE_CODES[dy.dtype],
              _vec(sk, dy, y, dx), *_magic(sq), *_magic(heads),
              torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(code, "softmax_bwd")
    return dx


class _SoftmaxFn(torch.autograd.Function):
    """Forward kernel; backward kernel from the saved ``y`` (in
    ``x.dtype``, as ``_softmax_pallas_fwd`` saves it), with the mask and
    the causal flag where the JAX dispatch differentiates ``where``
    (``sk % 128 != 0``); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal, kernel):
        if kernel:
            y = softmax_fwd_kernel(x, mask, scale, causal)
        else:
            y = scale_mask_softmax_reference(x, mask, scale, causal)
        zero = _zero_masked(x.shape[-1])
        ctx.save_for_backward(y, mask if zero else None)
        ctx.scale, ctx.kernel = scale, kernel
        ctx.causal = causal and zero
        return y

    @staticmethod
    def backward(ctx, dy):
        y, mask = ctx.saved_tensors
        fn = softmax_bwd_kernel if ctx.kernel else softmax_bwd_reference
        return (fn(dy, y, ctx.scale, mask, ctx.causal), None, None, None,
                None)


def fused_scale_mask_softmax(x, mask=None, *, scale: float = 1.0,
                             causal: bool = False,
                             implementation: Optional[str] = None):
    """``softmax(x * scale, masked)`` over the last axis, fused.

    - ``x``: scores, typically ``(batch, heads, sq, sk)``, fp32/bf16/fp16.
    - ``mask``: optional boolean, True = masked; broadcastable to ``x``.
    - ``causal``: the upper-triangular fill ``k > q + (sk - sq)``.

    Differentiable in ``x``; ``implementation`` as in :mod:`._dispatch`.
    """
    kernel = resolve_impl(implementation, x) == "kernel"
    if mask is not None and mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    if torch.is_grad_enabled() and x.requires_grad:
        return _SoftmaxFn.apply(x, mask, float(scale), bool(causal), kernel)
    if kernel:
        return softmax_fwd_kernel(x, mask, scale, causal)
    return scale_mask_softmax_reference(x, mask, scale, causal)
