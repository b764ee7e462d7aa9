"""SyncBatchNorm — batch statistics shared across processes.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` (reference
``apex/parallel/{optimized_,}sync_batchnorm.py``): the batch statistics
reduce over every leading dim of a channels-last ``(N, ..., C)`` input
and over a process group — the mesh group of ``axis_names`` (the JAX
module's; without a mesh the axes are unbound and the statistics local,
as in JAX) or apex's ``process_group``.  With equal local batches the
Welford combine is the sum of (Σx, Σx², n), one all-reduce; the
backward all-reduces the cotangents of those sums (the transpose of the
JAX ``psum``).  :func:`convert_syncbn_model` turns the BN layers of a
model of the port into cross-process ones.

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
import torch.distributed as dist
import torch.nn as nn

from apex_tpu_torch.core.mesh import DATA_AXIS
from apex_tpu_torch.ops.batch_norm import (
    AllReduceSum,
    batch_norm_inference,
    batch_norm_train,
    sync_group,
)
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["SyncBatchNorm", "sync_batch_norm_stats", "convert_syncbn_model"]


def sync_batch_norm_stats(x, axis_names=None, *, reduce_dims,
                          process_group=None):
    """``(mean, var)`` over ``reduce_dims`` of ``x`` and over the group of
    ``axis_names`` / ``process_group``, from the Σx / Σx² sums, fp32 (the
    variance biased and not clamped, as in JAX); differentiable through
    the group's sums."""
    group = sync_group(axis_names, process_group)
    n = 1
    for d in reduce_dims:
        n *= x.shape[d]
    xf = x.float()
    s1 = xf.sum(reduce_dims)
    s2 = torch.square(xf).sum(reduce_dims)
    if group is not None:
        s1, s2 = AllReduceSum.apply(torch.stack([s1, s2]), group)
        n *= dist.get_world_size(group)
    mean = s1 / float(n)
    var = s2 / float(n) - torch.square(mean)
    return mean, var


class SyncBatchNorm(nn.Module):
    """BatchNorm over a channels-last ``(N, ..., C)`` input, its
    statistics over the group of ``axis_names`` (a mesh's) or
    ``process_group`` (apex ``SyncBatchNorm``; neither: local).  Train
    mode normalises with the batch statistics and updates the running
    ones (the group's, identical on every rank); eval mode
    (``module.eval()``) uses the running statistics."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True,
                 axis_names: Optional[Sequence[str]] = None,
                 process_group=None, param_dtype=torch.float32,
                 fused: bool = False, act: Optional[str] = None,
                 device=None):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"unknown act {act!r}")
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.eps = momentum, eps
        self.fused, self.act = fused, act
        self.axis_names = tuple(axis_names) if axis_names else ()
        self.process_group = process_group
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
        group = sync_group(self.axis_names, self.process_group)
        if self.fused:
            y, mean, var = batch_norm_train(
                x, self.weight, self.bias, eps=self.eps, residual=residual,
                act=self.act, process_group=group)
        else:
            mean, var = sync_batch_norm_stats(x, reduce_dims=dims,
                                              process_group=group)
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
            n = 1 if group is None else dist.get_world_size(group)
            for d in dims:
                n *= x.shape[d]
            m = self.momentum
            rvar = var * (n / (n - 1)) if n > 1 else var
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * rvar)
        return y


def convert_syncbn_model(module: nn.Module, axis_names=(DATA_AXIS,),
                         process_group=None) -> nn.Module:
    """``apex.parallel.convert_syncbn_model``: every BN layer of the port
    in ``module`` (the :class:`SyncBatchNorm` its models build) takes
    its statistics over the group of ``axis_names`` / ``process_group``
    from now on; parameters and running statistics stay.  Returns
    ``module`` (converted in place).  ``torch.nn.BatchNorm*d`` layers are
    channels-first and are left to ``torch.nn.SyncBatchNorm``."""
    for mod in module.modules():
        if isinstance(mod, SyncBatchNorm):
            mod.axis_names = tuple(axis_names) if axis_names else ()
            mod.process_group = process_group
    return module
