"""ZeRO-1/2: optimizer state sharded across the data-parallel group.

Counterpart of ``apex_tpu/parallel/distributed_optim.py`` (reference
``apex/contrib/optimizers/distributed_fused_{adam,lamb}.py``; Xu et al.,
"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training").  A step of the sharded state:

1. **reduce-scatter** the gradients over the ZeRO group: each rank gets
   only its shard of the mean gradient, in fp32 — stage 2 by an
   ``all_to_all_single`` of the ``(n, m)`` shard rows and a local fp32
   sum (or, with ``reduce_dtype="int8"``, the int8 leg of
   :func:`~apex_tpu_torch.parallel.ddp.all_reduce_mean_grads`); stage 1
   all-reduces the whole gradient and keeps its own row;
2. **shard-local update** of fp32 master shards by the port's fused
   optimizers — Adam is elementwise, LAMB takes ``shard_axis`` so its
   norms are all-reduced over the shards (:func:`distributed_fused_lamb`);
3. **all-gather** the updated shards into the module's parameters.

The layout is :func:`zero_partition`'s: a flat buffer zero-padded to
``n · m`` elements, row ``i`` (``m = ceil(size / n)``) on the group's
rank ``i``.  :meth:`~apex_tpu_torch.core.train_state.
MixedPrecisionTrainState.create` with ``zero=ZeroConfig(...)`` shards the
flat buffers the train state keeps, one a parameter dtype, and runs the
three steps in ``apply_gradients``.  Placement specs
(``zero_state_specs`` / ``zero_shardings`` of the JAX package) have no
counterpart: each process holds its own shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import FSDP_AXIS, group_of
from apex_tpu_torch.core.precision import tree_map
from apex_tpu_torch.optim.fused_adam import fused_adam
from apex_tpu_torch.optim.fused_lamb import fused_lamb
from apex_tpu_torch.parallel import ddp as _ddp
from apex_tpu_torch.transformer.mappings import all_gather

__all__ = [
    "ZeroConfig",
    "ZeroOptState",
    "distributed_fused_adam",
    "distributed_fused_lamb",
    "zero_partition",
    "zero_unpartition",
    "reduce_scatter_mean_grads",
    "all_gather_params",
    "shard_segments",
]


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """A ZeRO-sharded optimizer layout.

    ``axis``: the mesh axis the state shards over (and the gradients
    reduce-scatter over); ``stage``: 1 (all-reduce, keep the own row) or
    2 (reduce-scatter); ``reduce_dtype``: the gradient sync's wire dtype
    (None exact, a half dtype, or ``"int8"``); ``axis_size``: shards,
    0 to take the mesh's size of ``axis`` at :meth:`resolved`."""

    axis: str = FSDP_AXIS
    stage: int = 2
    reduce_dtype: Any = None
    axis_size: int = 0

    def resolved(self, mesh=None) -> "ZeroConfig":
        """Validate and fill ``axis_size`` from the mesh if unset."""
        if self.stage not in (1, 2):
            raise ValueError(f"ZeRO stage must be 1 or 2, got "
                             f"{self.stage!r}")
        _ddp._normalize_allreduce_dtype(self.reduce_dtype)
        n = self.axis_size
        if not n:
            mesh = mesh or mesh_lib.get_mesh()
            n = mesh.shape.get(self.axis, 0)
            if not n:
                raise ValueError(
                    f"mesh has no axis {self.axis!r} — name a mesh "
                    f"axis or pass axis_size explicitly")
        if n < 1:
            raise ValueError(f"axis_size must be >= 1, got {n}")
        return dataclasses.replace(self, axis_size=int(n))


@dataclasses.dataclass
class ZeroOptState:
    """The sharded optimizer state of a zero-mode train state:
    ``master`` the fp32 master shards ``(m,)`` (one a buffer), ``inner``
    the wrapped optimizer's state over them; ``local_master`` /
    ``local_inner`` the whole fp32 masters and the state of the
    parameters that are not replicas over the ZeRO axis (MoE experts
    sharded over it), which each rank updates alone."""

    master: List[torch.Tensor]
    inner: Any
    local_master: List[torch.Tensor] = dataclasses.field(
        default_factory=list)
    local_inner: Any = None


# ---------------------------------------------------------- shard layout

def zero_partition(tree: Any, axis_size: int, *,
                   dtype: Any = torch.float32) -> Any:
    """Every tensor of ``tree`` as ``(axis_size, m)`` ZeRO rows: flat,
    cast to ``dtype`` (floating tensors), zero-padded; row ``i`` is
    shard ``i``'s slice."""
    n = int(axis_size)

    def part(p):
        x = p.detach().reshape(-1)
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return _ddp._pad_rows(x, n)

    return tree_map(part, tree)


def zero_unpartition(shards: Any, like: Any) -> Any:
    """The inverse of :func:`zero_partition`: padding dropped, shapes
    from ``like``; dtypes stay the shards'."""
    return tree_map(lambda s, p: s.reshape(-1)[:p.numel()].view(p.shape),
                    shards, like)


def shard_segments(sizes: List[int], rank: int, n: int) -> List[int]:
    """The sizes of each tensor's part in row ``rank`` of a buffer of
    tensors of ``sizes`` laid end to end and cut into ``n`` rows, and
    last the row's padding: a per-tensor segmentation of the shard (a
    tensor absent from the row has size 0)."""
    m = -(-max(1, sum(sizes)) // n)
    lo, hi = rank * m, (rank + 1) * m
    out, off = [], 0
    for s in sizes:
        out.append(max(0, min(hi, off + s) - max(lo, off)))
        off += s
    out.append(m - sum(out))
    return out


# ------------------------------------------------------------- collectives

def reduce_scatter_mean_grads(grads: Any, axis=FSDP_AXIS, *,
                              reduce_dtype: Any = None, stage: int = 2,
                              average: bool = True) -> Any:
    """Each gradient of ``grads`` as this rank's ``(1, m)`` fp32 row of
    the :func:`zero_partition` layout of the mean (or sum) over the
    ``axis`` group — the ZeRO gradient sync.

    Stage 2 exchanges only rows: ``all_to_all_single`` hands every rank
    the ``n`` contributions to its row, summed locally in fp32 (a half
    ``reduce_dtype`` puts 2-byte elements on the wire; ``"int8"`` is the
    reduce-scatter leg of the quantized all-reduce, non-finite gradients
    poisoning the row with NaN).  Stage 1 all-reduces the whole gradient
    (:func:`~apex_tpu_torch.parallel.ddp.all_reduce_mean_grads`) and
    keeps its row."""
    dtype = _ddp._normalize_allreduce_dtype(reduce_dtype)
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage!r}")
    group = group_of(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)

    if stage == 1:
        full = _ddp.all_reduce_mean_grads(
            grads, group, allreduce_dtype=reduce_dtype, average=average)
        return tree_map(lambda g: _ddp._pad_rows(
            g.reshape(-1).float(), n)[rank:rank + 1], full)

    def rs(g):
        if dtype == "int8":
            s, inv_scale, amax = _ddp._q8_reduce_scatter(g, group, n)
            deq = s.float() * inv_scale
            if average:
                deq = deq / n
            deq = torch.where(torch.isfinite(amax), deq,
                              torch.full_like(deq, float("nan")))
            return deq.reshape(1, -1)
        wire = g if dtype is None else g.to(dtype)
        rows = _ddp._pad_rows(wire.reshape(-1), n)
        mine = torch.empty_like(rows)
        dist.all_to_all_single(mine, rows, group=group)
        # the n contributions summed in fp32 whatever the wire dtype
        s = mine.float().sum(0)
        if average:
            s = s / n
        return s.reshape(1, -1)

    return tree_map(rs, grads)


def all_gather_params(shards: Any, like: Any, axis=FSDP_AXIS) -> Any:
    """``(1, m)`` (or ``(m,)``) shards all-gathered into whole tensors
    shaped as ``like``; the wire carries the shards' dtype (cast them to
    the storage dtype first)."""
    group = group_of(axis)

    def ag(s, p):
        full = all_gather(s.reshape(-1), group, 0)
        return full[:p.numel()].view(p.shape)

    return tree_map(ag, shards, like)


# ------------------------------------------------- distributed optimizers

def distributed_fused_adam(*args: Any, **kwargs: Any):
    """:func:`~apex_tpu_torch.optim.fused_adam` for ZeRO-sharded state:
    the update is elementwise, so the shard-local update is the whole
    update restricted to the shard.  fp8 moments lay their blocks over
    whole parameters and are refused by a zero-mode train state."""
    return fused_adam(*args, **kwargs)


def distributed_fused_lamb(*args: Any, shard_axis: Optional[str],
                           **kwargs: Any):
    """:func:`~apex_tpu_torch.optim.fused_lamb` for ZeRO-sharded state:
    ``shard_axis`` (keyword-required, the :class:`ZeroConfig` axis)
    all-reduces the clip norm's and the trust ratios' sums of squares
    over the shards, one collective a buffer, so the sharded update is
    the whole one.  ``shard_axis=None`` is the plain optimizer."""
    return fused_lamb(*args, shard_axis=shard_axis, **kwargs)
