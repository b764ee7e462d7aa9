"""SyncBatchNorm on one card.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` for a single
process: the batch statistics reduce over every leading dim of a
channels-last ``(N, ..., C)`` input.  Reducing them across processes
(the JAX module's ``axis_names``, apex's ``process_group``) and
``convert_syncbn_model`` come with ROADMAP.md A-5 and raise until then.

``fused=True`` routes the train-mode math through
:func:`apex_tpu_torch.ops.batch_norm.batch_norm_train` (the fused
kernels, with the ``act`` / ``residual`` epilogue inside them); unfused,
the same epilogue runs as separate PyTorch ops, so the two modes are
interchangeable.

Running statistics keep the JAX module's convention, not
``torch.nn.BatchNorm``'s: with ``momentum=0.9``, ``running = 0.9 ·
running + 0.1 · batch``, and the variance stored is Bessel-corrected
(``var · n / (n - 1)``) while normalisation uses the biased one.  They
are fp32 buffers updated in the forward under ``no_grad`` (the torch
idiom for the JAX module's returned ``batch_stats``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from apex_tpu_torch.ops.batch_norm import (
    batch_norm_inference,
    batch_norm_train,
)
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["SyncBatchNorm", "sync_batch_norm_stats", "convert_syncbn_model"]


def _local_only(axis_names, process_group=None):
    if axis_names or process_group is not None:
        raise NotImplementedError(
            "SyncBatchNorm across processes (axis_names / process_group) "
            "comes with ROADMAP.md A-5")


def sync_batch_norm_stats(x, axis_names=None, *, reduce_dims):
    """``(mean, var)`` over ``reduce_dims`` of ``x`` from the Σx / Σx²
    sums, fp32 (the variance biased and not clamped, as in JAX)."""
    _local_only(axis_names)
    n = 1
    for d in reduce_dims:
        n *= x.shape[d]
    xf = x.float()
    mean = xf.sum(reduce_dims) / float(n)
    var = torch.square(xf).sum(reduce_dims) / float(n) - torch.square(mean)
    return mean, var


class SyncBatchNorm(nn.Module):
    """BatchNorm over a channels-last ``(N, ..., C)`` input (apex
    ``SyncBatchNorm`` on one card).  Train mode normalises with the batch
    statistics and updates the running ones; eval mode
    (``module.eval()``) uses the running statistics."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True,
                 axis_names: Optional[Sequence[str]] = None,
                 process_group=None, param_dtype=torch.float32,
                 fused: bool = False, act: Optional[str] = None,
                 device=None):
        super().__init__()
        _local_only(axis_names, process_group)
        if act not in (None, "relu"):
            raise ValueError(f"unknown act {act!r}")
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.eps = momentum, eps
        self.fused, self.act = fused, act
        kw = dict(dtype=param_dtype, device=dev)
        self.weight = (nn.Parameter(torch.ones(num_features, **kw))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("var", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def init_weights(self, generator=None):
        """Unit scale, zero bias, running statistics at (0, 1)."""
        with torch.no_grad():
            for t, v in ((self.weight, 1.0), (self.bias, 0.0),
                         (self.mean, 0.0), (self.var, 1.0)):
                if t is not None:
                    t.fill_(v)

    def forward(self, x, residual=None):
        if not self.training:
            return batch_norm_inference(
                x, self.mean, self.var, self.weight, self.bias, eps=self.eps,
                residual=residual, act=self.act)
        dims = tuple(range(x.ndim - 1))
        if self.fused:
            y, mean, var = batch_norm_train(
                x, self.weight, self.bias, eps=self.eps, residual=residual,
                act=self.act)
        else:
            mean, var = sync_batch_norm_stats(x, reduce_dims=dims)
            yf = (x.float() - mean) * torch.rsqrt(var + self.eps)
            if self.weight is not None:
                yf = yf * self.weight.float()
            if self.bias is not None:
                yf = yf + self.bias.float()
            if residual is not None:
                yf = yf + residual.float()
            if self.act == "relu":
                yf = torch.clamp_min(yf, 0.0)
            y = yf.to(x.dtype)
        with torch.no_grad():
            n = 1
            for d in dims:
                n *= x.shape[d]
            m = self.momentum
            rvar = var * (n / (n - 1)) if n > 1 else var
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * rvar)
        return y


def convert_syncbn_model(module: nn.Module) -> nn.Module:
    """``apex.parallel.convert_syncbn_model``: swapping BN layers for
    statistics shared across processes comes with ROADMAP.md A-5."""
    raise NotImplementedError(
        "convert_syncbn_model comes with ROADMAP.md A-5")
