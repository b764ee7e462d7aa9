"""Tensor-parallel autograd collectives (Megatron's "f" / "g").

Counterpart of ``apex_tpu/transformer/mappings.py`` (reference:
``apex/transformer/tensor_parallel/mappings.py``): each function is an
``autograd.Function`` whose backward is the JAX ``_*_bwd`` of its
``custom_vjp``, over the process group of a mesh axis:

==============================  ===============  ===============
function                        forward          backward
==============================  ===============  ===============
``copy_to_...``         ("f")   identity         all-reduce
``reduce_from_...``     ("g")   all-reduce       identity
``scatter_to_...``              own chunk        all-gather
``gather_from_...``             all-gather       own chunk
``reduce_scatter_to_sequence_parallel_...``  reduce-scatter  all-gather
``gather_from_sequence_parallel_...``        all-gather      reduce-scatter
``scatter_to_sequence_parallel_...``         own chunk       all-gather
==============================  ===============  ===============

``axis`` is a mesh axis name (its group from the current mesh) or a
process group.  Every function calls its collective at any group size,
a world of one included (it then moves nothing).  Outputs are
contiguous, in the layout the input had, so a product that follows
runs as it would on the unsharded tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.core.mesh import TENSOR_AXIS, group_of

__all__ = [
    "copy_to_tensor_parallel_region",
    "reduce_from_tensor_parallel_region",
    "scatter_to_tensor_parallel_region",
    "gather_from_tensor_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "split",
]


# --------------------------------------------------------------------- #
# the collectives (no autograd)
# --------------------------------------------------------------------- #
# the names torch gave these collectives before 2.13 and after
_all_gather_single = getattr(dist, "all_gather_single",
                             getattr(dist, "all_gather_into_tensor", None))
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 getattr(dist, "reduce_scatter_tensor", None))


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """A reduced copy of ``x`` over ``group``."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x, group, dim: int):
    """The group's chunks of ``x`` concatenated along ``dim``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x, group=group)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter(x, group, dim: int):
    """The sum over ``group`` of ``x``, this rank's chunk along ``dim``."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n}")
    chunks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    chunks = chunks.contiguous()
    out = x.new_empty(chunks.shape[1:])
    _reduce_scatter_single(out, chunks.reshape(
        (-1,) + tuple(chunks.shape[2:])), group=group)
    return out


def split(x, group, dim: int):
    """This rank's chunk of ``x`` along ``dim`` (a contiguous copy)."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


# --------------------------------------------------------------------- #
# autograd pairs
# --------------------------------------------------------------------- #
class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """Own chunk forward, all-gather backward (the tensor and the
    sequence form alike)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.group, ctx.dim), None, None


class _ReduceScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to_tensor_parallel_region(x, axis=TENSOR_AXIS):
    """Megatron ``f``: a replicated input entering a TP-sharded block."""
    return _CopyToTP.apply(x, group_of(axis))


def reduce_from_tensor_parallel_region(x, axis=TENSOR_AXIS):
    """Megatron ``g``: partial sums leaving a TP-sharded block."""
    return _ReduceFromTP.apply(x, group_of(axis))


def scatter_to_tensor_parallel_region(x, axis=TENSOR_AXIS, dim: int = -1):
    """This rank's feature chunk (forward) / all-gather (backward)."""
    return _Scatter.apply(x, group_of(axis), dim)


def gather_from_tensor_parallel_region(x, axis=TENSOR_AXIS, dim: int = -1):
    """All-gather feature chunks (forward) / own chunk (backward)."""
    return _GatherFromTP.apply(x, group_of(axis), dim)


def reduce_scatter_to_sequence_parallel_region(x, axis=TENSOR_AXIS,
                                               dim: int = 0):
    """Reduce partial sums and keep this rank's sequence chunk (forward);
    all-gather (backward): the exit of a TP block under sequence
    parallelism."""
    return _ReduceScatterToSP.apply(x, group_of(axis), dim)


def gather_from_sequence_parallel_region(x, axis=TENSOR_AXIS, dim: int = 0):
    """All-gather sequence chunks (forward); reduce-scatter (backward):
    the entry of a TP block under sequence parallelism."""
    return _GatherFromSP.apply(x, group_of(axis), dim)


def scatter_to_sequence_parallel_region(x, axis=TENSOR_AXIS, dim: int = 0):
    """This rank's sequence chunk (forward) / all-gather (backward): the
    embeddings entering a sequence-parallel region."""
    return _Scatter.apply(x, group_of(axis), dim)
