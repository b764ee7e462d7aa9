"""Megatron-style linear and embedding layers, single device.

Counterparts of ``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` in ``apex_tpu/transformer/layers.py``.  This
slice runs on one card, so the layers hold whole weights and insert no
collectives; the names stay so that a tensor-parallel slice can shard
them without renaming a parameter.  Like every entry point of the port
they are built on ``device`` (default ``"cuda"``; raises when CUDA is
unavailable unless ``device="cpu"``).

Numerics follow the JAX layers: the product runs in the compute
``dtype`` (``None``: the input's, or under :func:`~apex_tpu_torch.amp.
o1.o1_intercept` the dtype O1 gives the layer) with fp32 accumulation
(``torch.nn.functional.linear``), the bias (in the compute dtype) is
added to the fp32 accumulator by the product itself, and the result is
rounded once to ``dtype``.  Weights
use PyTorch's ``(out_features, in_features)`` layout; the JAX kernels'
``(in, out)`` layout is transposed by
:func:`apex_tpu_torch.models.jax_import.params_from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.amp import o1
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class _Linear(nn.Module):
    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.features = int(in_features), int(features)
        self.dtype = dtype
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            features, in_features, dtype=param_dtype, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                features, dtype=param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Normal weights at fan-in scale (``std = in_features**-0.5``),
        zero bias; ``generator`` must live on the weights' device."""
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features),
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dtype = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class ColumnParallelLinear(_Linear):
    """Linear whose output features a tensor-parallel slice would
    shard (whole on one device)."""


class RowParallelLinear(_Linear):
    """Linear whose input features a tensor-parallel slice would shard
    (whole on one device)."""


class VocabParallelEmbedding(nn.Module):
    """Embedding whose vocab a tensor-parallel slice would shard;
    :meth:`attend` gives logits against the same table (tied output
    embedding)."""

    def __init__(self, num_embeddings: int, features: int, *, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.param_dtype = dtype, param_dtype
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=param_dtype,
            device=resolve_device(device)))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        self.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids):
        # the JAX layer's take(table.astype(dtype), ids): under O1 the
        # table's gradient is summed in dtype before one cast back
        dtype = self.dtype or self.param_dtype
        return F.embedding(ids, self.weight.to(dtype))

    def attend(self, x):
        # the JAX interceptor casts every method's inputs, this one's too
        dtype = o1.module_dtype(self)
        if dtype is not None:
            x = x.to(dtype)
        y = F.linear(x, self.weight.to(x.dtype))
        return y.to(x.dtype)
