"""Fused LayerNorm / RMSNorm forward — CUDA kernel plus plain PyTorch.

Counterpart of ``apex_tpu/ops/layer_norm.py``.  The kernel
(``csrc/layer_norm.cu``) replaces the Pallas ``_ln_fwd_kernel`` /
``_ln_fwd_kernel_nobias``: statistics in fp32 whatever the input dtype,
weight and bias in their own dtype multiplied in fp32, output in
``x.dtype``.  Forward only in this slice (serving needs no gradient).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_reference",
           "rms_norm_reference"]


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain composition matching ``torch.nn.functional.layer_norm``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm_reference(x, weight=None, eps: float = 1e-5):
    """Plain composition of RMSNorm (Zhang & Sennrich)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _ln_kernel(x, weight, bias, eps: float, rms: bool):
    h = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (h,) or t.device != x.device):
            raise ValueError(
                f"{name} must be ({h},) on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if weight is not None and bias is not None \
            and weight.dtype != bias.dtype:
        raise TypeError("weight and bias must share a dtype")
    w_dtype = (weight if weight is not None else
               bias if bias is not None else x).dtype
    if w_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"unsupported parameter dtype {w_dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    if rows == 0:
        return y
    fn = _build.function("layer_norm", "apex_ln_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    w = None if weight is None else weight.contiguous()
    b = None if bias is None else bias.contiguous()
    code = fn(x.data_ptr(), None if w is None else w.data_ptr(),
              None if b is None else b.data_ptr(), y.data_ptr(), rows, h,
              float(eps), int(rms), _build.DTYPE_CODES[x.dtype],
              _build.DTYPE_CODES[w_dtype], torch.cuda.current_stream(
                  x.device).cuda_stream)
    _build.check(code, "layer_norm")
    return y


def fused_layer_norm(x, weight=None, bias=None, *, eps: float = 1e-5,
                     implementation: Optional[str] = None):
    """LayerNorm over the last axis (apex ``FusedLayerNorm``).

    ``weight``/``bias`` may be ``None``.  Statistics in fp32; output in
    ``x.dtype``.  ``implementation`` as in :mod:`._dispatch`.
    """
    if resolve_impl(implementation, x) == "torch":
        return layer_norm_reference(x, weight, bias, eps=eps)
    return _ln_kernel(x, weight, bias, eps, rms=False)


def fused_rms_norm(x, weight=None, *, eps: float = 1e-5,
                   implementation: Optional[str] = None):
    """RMSNorm over the last axis (apex ``FusedRMSNorm``)."""
    if resolve_impl(implementation, x) == "torch":
        return rms_norm_reference(x, weight, eps=eps)
    return _ln_kernel(x, weight, None, eps, rms=True)
