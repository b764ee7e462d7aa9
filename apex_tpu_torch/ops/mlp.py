"""Fused dense / MLP blocks, and the activation resolver they share.

Counterpart of ``apex_tpu/ops/mlp.py`` (apex's ``fused_dense`` and
``mlp``: dense + bias + activation with the epilogue fused to the GEMM).
These are modules, not kernels, in both packages: the products stay
``F.linear`` (the JAX package leaves them to XLA), and the epilogue —
bias, then activation — runs on the fp32 accumulator, rounded once to
``x.dtype``, as the JAX ``fused_dense`` computes it with
``preferred_element_type=float32``.

- fp32 inputs, and any input on the CPU: the product in fp32 (half
  inputs upcast exactly), so the epilogue sees the fp32 accumulator.
- bf16 / fp16 inputs on a CUDA device: the product in the input dtype
  (cuBLAS accumulates in fp32) whose result is rounded to that dtype
  before the fp32 epilogue — one rounding more than the JAX expression:
  the pre-activation is off by at most half an ulp of ``x.dtype``, so
  the output by at most that times the activation's slope (≤ 1.13 for
  GELU) plus the final rounding.

Weights use PyTorch's ``(out, in)`` layout, under the JAX parameter
names (``kernel``/``bias``, ``kernel1``/``bias1``/``kernel2``/``bias2``,
``kernel_{i}``/``bias_{i}``); :func:`fused_dense` takes the JAX
function's ``(in, out)`` kernel, and
:func:`apex_tpu_torch.models.mlp_params_from_jax` transposes a JAX
module's kernels.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["resolve_activation", "fused_dense", "FusedDense",
           "FusedDenseGeluDense", "MLP"]


def resolve_activation(name: str, *, gelu_approximate: bool = False):
    """The activation function called ``name``.  Unknown names
    (including ``None``) raise: an unset activation silently becoming
    the identity would degrade a model with no error."""
    if name == "gelu":
        return functools.partial(
            F.gelu, approximate="tanh" if gelu_approximate else "none")
    if name == "relu":
        return F.relu
    if name == "silu":
        return F.silu
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(f"unknown activation {name!r}")


def fused_dense(x, kernel, bias=None, activation: Optional[str] = None):
    """``act(x @ kernel + bias)``, ``kernel`` ``(in, out)`` as in the JAX
    package: bias and activation on the fp32 accumulator, the result in
    ``x.dtype`` (see the module docstring for half inputs on a card)."""
    act = None if activation is None else resolve_activation(activation)
    if x.is_cuda and x.dtype != torch.float32:
        y = F.linear(x, kernel.to(x.dtype).t()).float()
    else:
        y = F.linear(x.float(), kernel.float().t())
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = act(y)
    return y.to(x.dtype)


def _kernel_param(module, name, n_in, n_out, param_dtype, device):
    """A ``(out, in)`` weight under ``name``, normal at fan-in scale."""
    w = nn.Parameter(torch.empty(n_out, n_in, dtype=param_dtype,
                                 device=device))
    nn.init.normal_(w, 0.0, 1.0 / math.sqrt(n_in))
    module.register_parameter(name, w)


def _bias_param(module, name, n, use, param_dtype, device):
    module.register_parameter(name, nn.Parameter(torch.zeros(
        n, dtype=param_dtype, device=device)) if use else None)


def _dense(module, x, i, dtype, activation=None):
    """One layer of ``module`` (its ``kernel{i}`` / ``bias{i}``) in the
    compute dtype."""
    k, b = getattr(module, f"kernel{i}"), getattr(module, f"bias{i}")
    return fused_dense(x, k.to(dtype).t(),
                       None if b is None else b.to(dtype), activation)


class FusedDense(nn.Module):
    """Linear + bias in one fused expression (``apex.fused_dense.
    FusedDense``): ``features`` outputs from ``in_features`` inputs."""

    def __init__(self, features: int, *, in_features: int,
                 use_bias: bool = True, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        _kernel_param(self, "kernel", in_features, features, param_dtype,
                      dev)
        _bias_param(self, "bias", features, use_bias, param_dtype, dev)

    def forward(self, x):
        dtype = self.dtype or x.dtype
        return _dense(self, x.to(dtype), "", dtype)


class FusedDenseGeluDense(nn.Module):
    """dense → bias → GELU → dense → bias (``apex.fused_dense.
    FusedDenseGeluDense``), exact GELU as ``resolve_activation("gelu")``.
    ``in_features`` defaults to ``out_features`` (a transformer MLP)."""

    def __init__(self, intermediate_features: int, out_features: int, *,
                 in_features: Optional[int] = None, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        n_in = out_features if in_features is None else in_features
        _kernel_param(self, "kernel1", n_in, intermediate_features,
                      param_dtype, dev)
        _bias_param(self, "bias1", intermediate_features, True, param_dtype,
                    dev)
        _kernel_param(self, "kernel2", intermediate_features, out_features,
                      param_dtype, dev)
        _bias_param(self, "bias2", out_features, True, param_dtype, dev)

    def forward(self, x):
        dtype = self.dtype or x.dtype
        h = _dense(self, x.to(dtype), 1, dtype, "gelu")
        return _dense(self, h, 2, dtype)


class MLP(nn.Module):
    """Stack of dense + bias + activation layers (``apex.mlp.MLP``):
    ``mlp_sizes`` are the widths after the input layer of
    ``in_features``; the activation applies to every layer but the
    last."""

    def __init__(self, mlp_sizes: Sequence[int], *, in_features: int,
                 activation: str = "relu", use_bias: bool = True,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        resolve_activation(activation)
        dev = resolve_device(device)
        self.mlp_sizes, self.activation = tuple(mlp_sizes), activation
        self.dtype = dtype
        n_in = in_features
        for i, width in enumerate(self.mlp_sizes):
            _kernel_param(self, f"kernel_{i}", n_in, width, param_dtype, dev)
            _bias_param(self, f"bias_{i}", width, use_bias, param_dtype, dev)
            n_in = width

    def forward(self, x):
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        last = len(self.mlp_sizes) - 1
        for i in range(len(self.mlp_sizes)):
            x = _dense(self, x, f"_{i}", dtype,
                       self.activation if i < last else None)
        return x
