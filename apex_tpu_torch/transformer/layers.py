"""Megatron-style tensor-parallel linear and embedding layers.

Counterparts of ``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` in ``apex_tpu/transformer/layers.py``
(reference ``apex/transformer/tensor_parallel/layers.py``), with the
functional forms :func:`column_parallel_linear`,
:func:`row_parallel_linear` and :func:`vocab_parallel_embedding`.

Built while a mesh is initialized (:mod:`apex_tpu_torch.core.mesh`),
a layer holds its rank's shard of the weight along the ``tensor`` axis
and calls the collectives of :mod:`~apex_tpu_torch.transformer.mappings`
on that axis's group, at any group size, one included:

- column: ``(out / tp, in)`` weight and ``out / tp`` bias; the input is
  copied in (``f``: all-reduce of its gradient), or all-gathered along
  ``seq_dim`` under ``sequence_parallel``; ``gather_output`` all-gathers
  the feature shards;
- row: ``(out, in / tp)`` weight and a whole bias; a whole input is
  scattered first unless ``input_is_parallel``; the partial products
  are all-reduced (``g``), or reduce-scattered along ``seq_dim`` under
  ``sequence_parallel``, and the bias is added after — in the product
  itself when the group has one rank, so that a world of one computes
  exactly what the layer computes without a mesh; on a sequence chunk
  the bias's gradient is summed over the group;
- embedding: ``(vocab / tp, features)`` table, a masked lookup whose
  rows are all-reduced; :meth:`VocabParallelEmbedding.attend` gives
  vocabulary-sharded logits.

Without a mesh, or with ``axis=None``, the layers hold whole weights
and call nothing.  Like
every entry point of the port they are built on ``device`` (default
``"cuda"``; raises when CUDA is unavailable unless ``device="cpu"``).

Numerics follow the JAX layers: the product runs in the compute
``dtype`` (``None``: the input's, or under :func:`~apex_tpu_torch.amp.
o1.o1_intercept` the dtype O1 gives the layer) with fp32 accumulation
(``torch.nn.functional.linear``) and is rounded once to ``dtype``.
Weights use PyTorch's ``(out_features, in_features)`` layout; the JAX
kernels' ``(in, out)`` layout is transposed by
:func:`apex_tpu_torch.models.jax_import.params_from_jax`, which also
cuts a rank's shard (``tp_rank`` / ``tp_size``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.amp import o1
from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import TENSOR_AXIS
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer.utils import divide

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "column_parallel_linear",
           "row_parallel_linear", "vocab_parallel_embedding",
           "tensor_parallel"]


def tensor_parallel(axis: Optional[str] = TENSOR_AXIS
                    ) -> Tuple[bool, int, int]:
    """``(active, size, rank)`` of the ``axis`` group: active while a
    mesh is initialized (a group of one included), else ``(False, 1,
    0)``, as for ``axis=None`` (a layer that is not split)."""
    if axis is None or not mesh_lib.mesh_is_initialized():
        return False, 1, 0
    m = mesh_lib.get_mesh()
    return True, m.axis_size(axis), m.axis_rank(axis)


class _Linear(nn.Module):
    def __init__(self, in_features: int, features: int, *, shard_in: bool,
                 use_bias: bool = True, sequence_parallel: bool = False,
                 seq_dim: int = 1, axis: str = TENSOR_AXIS, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.features = int(in_features), int(features)
        self.dtype = dtype
        self.axis, self.seq_dim = axis, seq_dim
        self.parallel, self.tp_size, self.tp_rank = tensor_parallel(axis)
        self.sequence_parallel = bool(sequence_parallel) and self.parallel
        local_in = (divide(self.in_features, self.tp_size) if shard_in
                    else self.in_features)
        local_out = (self.features if shard_in
                     else divide(self.features, self.tp_size))
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            local_out, local_in, dtype=param_dtype, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(
                local_out, dtype=param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Normal weights at fan-in scale (``std = in_features**-0.5``,
        the whole layer's fan-in), zero bias; ``generator`` must live on
        the weights' device."""
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features),
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class ColumnParallelLinear(_Linear):
    """Linear with its output features sharded over the tensor group
    (``gather_output`` all-gathers them)."""

    def __init__(self, in_features: int, features: int, *,
                 gather_output: bool = False, **kw):
        super().__init__(in_features, features, shard_in=False, **kw)
        self.gather_output = gather_output

    def forward(self, x):
        dtype = self.dtype or x.dtype
        if self.sequence_parallel:
            x = mappings.gather_from_sequence_parallel_region(
                x, self.axis, self.seq_dim)
        elif self.parallel:
            x = mappings.copy_to_tensor_parallel_region(x, self.axis)
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.linear(x.to(dtype), self.weight.to(dtype), bias)
        if self.gather_output and self.parallel:
            y = mappings.gather_from_tensor_parallel_region(y, self.axis)
        return y


class RowParallelLinear(_Linear):
    """Linear with its input features sharded over the tensor group; the
    output is reduced over the group (reduce-scattered along the
    sequence under ``sequence_parallel``)."""

    def __init__(self, in_features: int, features: int, *,
                 input_is_parallel: bool = True, **kw):
        super().__init__(in_features, features, shard_in=True, **kw)
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        dtype = self.dtype or x.dtype
        if self.parallel and not self.input_is_parallel:
            x = mappings.scatter_to_tensor_parallel_region(x, self.axis)
        # one rank holds the whole product: the bias goes into it, as
        # without a mesh; else it is added once, after the reduction
        fused = self.tp_size == 1
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.linear(x.to(dtype), self.weight.to(dtype),
                     bias if fused else None)
        if self.sequence_parallel:
            y = mappings.reduce_scatter_to_sequence_parallel_region(
                y, self.axis, self.seq_dim)
        elif self.parallel:
            y = mappings.reduce_from_tensor_parallel_region(y, self.axis)
        if bias is not None and not fused:
            if self.sequence_parallel:
                # added on the sequence chunk: each rank's gradient is a
                # part, summed over the group by copy_to's backward
                bias = mappings.copy_to_tensor_parallel_region(bias,
                                                               self.axis)
            y = y + bias
        return y


class VocabParallelEmbedding(nn.Module):
    """Embedding with its vocabulary sharded over the tensor group;
    :meth:`attend` gives logits against the same table (tied output
    embedding), sharded by vocabulary."""

    def __init__(self, num_embeddings: int, features: int, *,
                 axis: str = TENSOR_AXIS, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.param_dtype = dtype, param_dtype
        self.axis = axis
        self.num_embeddings = int(num_embeddings)
        self.parallel, self.tp_size, self.tp_rank = tensor_parallel(axis)
        per = divide(self.num_embeddings, self.tp_size)
        self.vocab_start = self.tp_rank * per
        self.weight = nn.Parameter(torch.empty(
            per, features, dtype=param_dtype,
            device=resolve_device(device)))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        self.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids):
        # the JAX layer's take(table.astype(dtype), ids): under O1 the
        # table's gradient is summed in dtype before one cast back
        dtype = self.dtype or self.param_dtype
        table = self.weight.to(dtype)
        if not self.parallel:
            return F.embedding(ids, table)
        return vocab_parallel_embedding(ids, table, start=self.vocab_start,
                                        axis=self.axis)

    def attend(self, x, sequence_parallel: bool = False):
        """Logits ``(..., vocab / tp)`` of ``x`` against this rank's
        rows.  ``sequence_parallel``: ``x`` is this rank's sequence
        chunk (dim 1), all-gathered first."""
        # the JAX interceptor casts every method's inputs, this one's too
        dtype = o1.module_dtype(self)
        if dtype is not None:
            x = x.to(dtype)
        if sequence_parallel and self.parallel:
            x = mappings.gather_from_sequence_parallel_region(
                x, self.axis, 1)
        elif self.parallel:
            x = mappings.copy_to_tensor_parallel_region(x, self.axis)
        y = F.linear(x, self.weight.to(x.dtype))
        return y.to(x.dtype)


# --------------------------------------------------------------------- #
# functional forms (the JAX package's shard_map functions)
# --------------------------------------------------------------------- #
def column_parallel_linear(x, weight_shard, bias_shard=None, *,
                           sequence_parallel: bool = False,
                           seq_dim: int = 1, axis=TENSOR_AXIS):
    """Per-shard column-parallel linear: ``weight_shard`` ``(out / tp,
    in)``; ``x`` replicated, or this rank's sequence chunk under
    ``sequence_parallel``.  Output: feature-sharded."""
    if sequence_parallel:
        x = mappings.gather_from_sequence_parallel_region(x, axis, seq_dim)
    else:
        x = mappings.copy_to_tensor_parallel_region(x, axis)
    y = F.linear(x, weight_shard.to(x.dtype))
    if bias_shard is not None:
        y = y + bias_shard.to(y.dtype)
    return y


def row_parallel_linear(x, weight_shard, bias=None, *,
                        sequence_parallel: bool = False,
                        seq_dim: int = 1, axis=TENSOR_AXIS):
    """Per-shard row-parallel linear: ``weight_shard`` ``(out, in /
    tp)``, ``x`` feature-sharded.  Output: whole (all-reduce), or this
    rank's sequence chunk (reduce-scatter) under ``sequence_parallel``;
    the bias is added after."""
    y = F.linear(x, weight_shard.to(x.dtype))
    if sequence_parallel:
        y = mappings.reduce_scatter_to_sequence_parallel_region(
            y, axis, seq_dim)
    else:
        y = mappings.reduce_from_tensor_parallel_region(y, axis)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def vocab_parallel_embedding(ids, table_shard, *, start=None,
                             axis=TENSOR_AXIS):
    """Per-shard vocab-parallel lookup: ``table_shard`` ``(vocab / tp,
    features)`` holding ids ``[start, start + vocab / tp)`` (default:
    this rank's block); a masked local lookup, all-reduced."""
    group = mesh_lib.group_of(axis)
    per = table_shard.shape[0]
    if start is None:
        start = dist.get_rank(group) * per
    in_range = (ids >= start) & (ids < start + per)
    local = torch.clamp(ids - start, 0, per - 1)
    y = F.embedding(local, table_shard)
    y = torch.where(in_range[..., None], y, torch.zeros_like(y))
    return mappings.reduce_from_tensor_parallel_region(y, group)
