"""Fused LayerNorm / RMSNorm — CUDA kernels plus plain PyTorch.

Counterpart of ``apex_tpu/ops/layer_norm.py``.  The kernels
(``csrc/layer_norm.cu``) replace the Pallas ``_ln_fwd_kernel`` /
``_ln_fwd_kernel_nobias`` (statistics in fp32 whatever the input dtype,
weight and bias in their own dtype multiplied in fp32, output in
``x.dtype``; the per-row mean and rstd saved for the backward) and
``_ln_bwd_dx_kernel`` (dx from the saved statistics).  The parameter
gradients are plain column sums, as the JAX package leaves them to XLA.

``fused_layer_norm`` / ``fused_rms_norm`` are a ``torch.autograd.
Function`` when a gradient is needed; without one (serving) the forward
kernel runs without writing the statistics.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_reference",
           "rms_norm_reference", "layer_norm_stats_reference",
           "layer_norm_bwd_dx_reference", "layer_norm_fwd_kernel",
           "layer_norm_bwd_dx_kernel"]


def layer_norm_stats_reference(x, weight=None, bias=None, eps: float = 1e-5,
                               rms: bool = False):
    """Plain composition of the forward kernel: ``(y, mean, rstd)`` with
    fp32 ``(rows,)`` statistics over the last axis (the mean is zero for
    RMSNorm, as in ``_ln_fwd_kernel``)."""
    xf = x.float()
    if rms:
        mu = torch.zeros(xf.shape[:-1] + (1,), dtype=torch.float32,
                         device=x.device)
        xc = xf
    else:
        mu = xf.mean(-1, keepdim=True)
        xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), mu.reshape(-1), rstd.reshape(-1)


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain composition matching ``torch.nn.functional.layer_norm``."""
    return layer_norm_stats_reference(x, weight, bias, eps)[0]


def rms_norm_reference(x, weight=None, eps: float = 1e-5):
    """Plain composition of RMSNorm (Zhang & Sennrich)."""
    return layer_norm_stats_reference(x, weight, None, eps, rms=True)[0]


def layer_norm_bwd_dx_reference(dy, x, weight, mean, rstd, rms: bool):
    """Plain composition of the backward kernel, on ``(rows, h)``:
    ``dx = rstd * (w*dy - mean(w*dy) - xhat * mean(w*dy*xhat))`` (the
    ``mean(w*dy)`` term drops for RMSNorm); ``dx`` in ``x.dtype``."""
    rs = rstd[:, None]
    xhat = (x.float() - mean[:, None]) * rs
    wdy = dy.float() if weight is None else dy.float() * weight.float()
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    dx = wdy - xhat * c2
    if not rms:
        dx = dx - wdy.mean(-1, keepdim=True)
    return (dx * rs).to(x.dtype)


def _check_params(x, weight, bias):
    h = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (h,) or t.device != x.device):
            raise ValueError(
                f"{name} must be ({h},) on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if weight is not None and bias is not None \
            and weight.dtype != bias.dtype:
        raise TypeError("weight and bias must share a dtype")
    w_dtype = (weight if weight is not None else
               bias if bias is not None else x).dtype
    if w_dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported parameter dtype {w_dtype}")
    return w_dtype


def _ptr(t):
    return None if t is None else t.data_ptr()


def layer_norm_fwd_kernel(x2d, weight, bias, eps: float, rms: bool,
                          stats: bool):
    """The forward kernel on a ``(rows, h)`` CUDA tensor: ``(y, mean,
    rstd)``, the statistics ``None`` unless ``stats``."""
    w_dtype = _check_params(x2d, weight, bias)
    rows, h = x2d.shape
    x2d = x2d.contiguous()
    y = torch.empty_like(x2d)
    mean = rstd = None
    if stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
        rstd = torch.empty_like(mean)
    if rows == 0 or h == 0:
        return y, mean, rstd
    fn = _build.function("layer_norm", "apex_ln_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    w = None if weight is None else weight.contiguous()
    b = None if bias is None else bias.contiguous()
    code = fn(x2d.data_ptr(), _ptr(w), _ptr(b), y.data_ptr(), _ptr(mean),
              _ptr(rstd), rows, h, float(eps), int(rms),
              _build.DTYPE_CODES[x2d.dtype], _build.DTYPE_CODES[w_dtype],
              torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(code, "layer_norm")
    return y, mean, rstd


def layer_norm_bwd_dx_kernel(dy, x2d, weight, mean, rstd, rms: bool):
    """The backward kernel on ``(rows, h)`` CUDA tensors: ``dx`` in
    ``x.dtype`` from the saved fp32 ``mean`` / ``rstd``."""
    w_dtype = _check_params(x2d, weight, None)
    rows, h = x2d.shape
    if dy.shape != x2d.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != x {tuple(x2d.shape)}")
    dy = dy.to(x2d.dtype).contiguous()
    x2d = x2d.contiguous()
    dx = torch.empty_like(x2d)
    if rows == 0 or h == 0:
        return dx
    fn = _build.function("layer_norm", "apex_ln_bwd_dx", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    w = None if weight is None else weight.contiguous()
    code = fn(dy.data_ptr(), x2d.data_ptr(), _ptr(w),
              mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
              dx.data_ptr(), rows, h, int(rms),
              _build.DTYPE_CODES[x2d.dtype], _build.DTYPE_CODES[w_dtype],
              torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(code, "layer_norm_bwd")
    return dx


class _NormFn(torch.autograd.Function):
    """``y = norm(x2d) * w + b`` with the saved-statistics backward of
    ``_ln_pallas_fwd`` / ``_ln_pallas_bwd``."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, rms, kernel):
        if kernel:
            y, mean, rstd = layer_norm_fwd_kernel(x2d, weight, bias, eps,
                                                  rms, stats=True)
        else:
            y, mean, rstd = layer_norm_stats_reference(x2d, weight, bias,
                                                       eps, rms)
        ctx.save_for_backward(x2d, weight, mean, rstd)
        ctx.rms, ctx.kernel = rms, kernel
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if ctx.kernel:
                dx = layer_norm_bwd_dx_kernel(dy, x2d, weight, mean, rstd,
                                              ctx.rms)
            else:
                dx = layer_norm_bwd_dx_reference(dy, x2d, weight, mean,
                                                 rstd, ctx.rms)
        # parameter grads: cross-row sums, plain PyTorch (XLA's in JAX)
        dyf = dy.float()
        if ctx.needs_input_grad[1]:
            xhat = (x2d.float() - mean[:, None]) * rstd[:, None]
            dw = (dyf * xhat).sum(0).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = dyf.sum(0).to(ctx.bias_dtype)
        return dx, dw, db, None, None, None


def _norm(x, weight, bias, eps, rms, implementation):
    kernel = resolve_impl(implementation, x) == "kernel"
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if not needs_grad:
        if kernel:
            y = layer_norm_fwd_kernel(x.reshape(-1, x.shape[-1]), weight,
                                      bias, eps, rms, stats=False)[0]
            return y.reshape(x.shape)
        return layer_norm_stats_reference(x, weight, bias, eps, rms)[0]
    y = _NormFn.apply(x.reshape(-1, x.shape[-1]), weight, bias, float(eps),
                      rms, kernel)
    return y.reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, *, eps: float = 1e-5,
                     implementation: Optional[str] = None):
    """LayerNorm over the last axis (apex ``FusedLayerNorm``).

    ``weight``/``bias`` may be ``None``.  Statistics in fp32; output in
    ``x.dtype``; differentiable in ``x``, ``weight`` and ``bias``.
    ``implementation`` as in :mod:`._dispatch`.
    """
    return _norm(x, weight, bias, eps, False, implementation)


def fused_rms_norm(x, weight=None, *, eps: float = 1e-5,
                   implementation: Optional[str] = None):
    """RMSNorm over the last axis (apex ``FusedRMSNorm``)."""
    return _norm(x, weight, None, eps, True, implementation)
