"""Pipeline parallelism over the ``pipe`` group — 1F1B composed with ZeRO
and tensor parallelism.

Counterpart of ``apex_tpu/parallel/pipeline.py``.  The schedule engine is
:mod:`apex_tpu_torch.transformer.pipeline_parallel.schedules`; this
module turns it into a train step on a data × pipe (× tensor) mesh:

- :func:`run_1f1b` — the 1F1B schedule and its reductions over the pipe
  ranks (the mean loss, the closure's gradients summed, the input
  cotangents broadcast);
- :func:`sync_grad_overflow` — one rank's non-finite gradient poisons
  every pipe rank's, so the loss-scale skip is pipe-global;
- :func:`stage_local_zero` — the ZeRO-1/2 state partitioned over the
  data group *of this rank's stage*;
- :func:`wrap_pipeline_step` — a body that runs those three and
  ``state.apply_gradients`` as one callable on this rank's data shard.

The JAX module places global arrays by ``PartitionSpec``
(``stage_specs``, ``stage_shardings``, ``pipeline_state_specs``,
``pipeline_state_shardings``); here each process holds only its own
stage and its own shard, and :func:`local_stage` /
:func:`pipeline_state_layout` say which.  The bubble arithmetic is the
JAX module's, number for number.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.loss_scale import all_finite
from apex_tpu_torch.core.mesh import AXIS_ORDER, DATA_AXIS, PIPE_AXIS
from apex_tpu_torch.core.precision import tree_leaves, tree_map
from apex_tpu_torch.transformer.pipeline_parallel import schedules

__all__ = [
    "bubble_fraction",
    "schedule_ticks",
    "live_microbatches",
    "stage_split",
    "stage_unsplit",
    "local_stage",
    "stage_local_zero",
    "pipeline_state_layout",
    "sync_grad_overflow",
    "run_1f1b",
    "wrap_pipeline_step",
]


# ------------------------------------------------------------ bubble math

def _check(p: int, m: Optional[int] = None):
    if p < 1 or (m is not None and m < 1):
        raise ValueError(f"need num_stages >= 1 and num_microbatches "
                         f">= 1, got p={p}, m={m}")


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Megatron's 1F1B bubble ``(p - 1) / m``: each stage sits out
    ``p - 1`` microbatch slots for the ``m`` it computes."""
    p, m = int(num_stages), int(num_microbatches)
    _check(p, m)
    return (p - 1) / m


def schedule_ticks(num_stages: int, num_microbatches: int) -> int:
    """The JAX engine's tick count ``m + 2p - 1`` (one fused forward and
    backward unit a tick)."""
    p, m = int(num_stages), int(num_microbatches)
    _check(p, m)
    return m + 2 * p - 1


def live_microbatches(num_stages: int) -> int:
    """Peak live microbatch activations per stage under 1F1B: ``p``,
    flat in ``m``."""
    p = int(num_stages)
    if p < 1:
        raise ValueError(f"need num_stages >= 1, got {p}")
    return p


# ------------------------------------------------------- stage partitioning

_LAYER_KEY = re.compile(r"^(\d+)\.(.*)$")


def _layer_indexed(tree) -> bool:
    return (isinstance(tree, dict) and bool(tree)
            and all(_LAYER_KEY.match(str(k)) for k in tree))


def stage_split(params: Any, num_stages: int) -> Any:
    """Cut a layer stack into ``num_stages`` equal stages.

    Tensors (alone or in dicts, lists, tuples) lead with the stacked
    layer axis ``(L, ...)`` and become ``(num_stages, L / num_stages,
    ...)``; 0-d tensors pass through.  A state dict of a layer list
    (keys ``"<layer>.<name>"``, as ``nn.ModuleList.state_dict()`` gives)
    becomes a list of ``num_stages`` such dicts, layers renumbered from
    0 in each: stage ``s``'s loads into the chunk ``build_model`` makes
    on pipe rank ``s``.  ``L % num_stages != 0`` raises."""
    p = int(num_stages)
    if p < 1:
        raise ValueError(f"need num_stages >= 1, got {p}")
    if _layer_indexed(params):
        n = 1 + max(int(_LAYER_KEY.match(k).group(1)) for k in params)
        per = _per(n, p, f"{n} layers")
        out: List[Dict[str, Any]] = [{} for _ in range(p)]
        for k, t in params.items():
            i, rest = _LAYER_KEY.match(k).groups()
            s, j = divmod(int(i), per)
            out[s][f"{j}.{rest}"] = t
        return out

    def split(leaf):
        if not leaf.dim():
            return leaf
        per = _per(leaf.shape[0], p, f"leaf shape {tuple(leaf.shape)}")
        return leaf.reshape(p, per, *leaf.shape[1:])

    return tree_map(split, params)


def _per(n, p, what):
    if n % p:
        raise ValueError(
            f"cannot split {n} stacked layers into {p} equal stages "
            f"({what}) — the stage-balance gate requires num_layers % "
            f"num_stages == 0")
    return n // p


def stage_unsplit(staged: Any) -> Any:
    """The inverse of :func:`stage_split`: ``(p, L/p, ...)`` tensors back
    to ``(L, ...)``, a list of per-stage layer state dicts back to one."""
    if isinstance(staged, list) and staged and all(
            _layer_indexed(s) for s in staged):
        out, base = {}, 0
        for s in staged:
            n = 1 + max(int(_LAYER_KEY.match(k).group(1)) for k in s)
            for k, t in s.items():
                j, rest = _LAYER_KEY.match(k).groups()
                out[f"{base + int(j)}.{rest}"] = t
            base += n
        return out
    return tree_map(lambda t: t if t.dim() < 2 else t.reshape(
        t.shape[0] * t.shape[1], *t.shape[2:]), staged)


def local_stage(staged: Any, *, mesh=None, axis: str = PIPE_AXIS) -> Any:
    """This rank's stage of a :func:`stage_split` result: row ``r`` of
    every stage-stacked tensor (0-d tensors whole), or the ``r``-th
    per-stage state dict, ``r`` the rank's pipe coordinate — what the
    JAX ``stage_shardings`` placement puts on this rank's device."""
    mesh = mesh or mesh_lib.get_mesh()
    r = mesh.axis_rank(axis)
    if isinstance(staged, list) and staged and all(
            _layer_indexed(s) for s in staged):
        return staged[r]
    return tree_map(lambda t: t[r] if t.dim() else t, staged)


# -------------------------------------------------- stage-local ZeRO state

def stage_local_zero(state: Any, *, num_stages: int,
                     staged: Optional[Sequence[str]] = None) -> Any:
    """The ZeRO-1/2 state for a data × pipe mesh: each stage's masters
    and moments sharded over the data replicas *of that stage*.

    In the JAX package the masters are first partitioned over the data
    axis as whole leaves and this re-partitions the stage-stacked ones
    per stage.  Here a process builds only its stage's parameters, and a
    zero-mode :class:`~apex_tpu_torch.core.train_state.
    MixedPrecisionTrainState` shards them over its ZeRO group, the
    ranks of this rank's line along the data axis — which share its
    pipe coordinate.  So the state is already stage-local: this checks
    its arguments (a zero-mode state; ``num_stages`` the mesh's pipe
    size; the ``staged`` top-level module names, default ``("stages",)``
    when the model has one, present) and returns it;
    :func:`wrap_pipeline_step` checks that the ZeRO group lies within
    this rank's stage.  The replicated closure parameters (embedding,
    head) are sharded over the same group, as the JAX function leaves
    them."""
    z = getattr(state, "zero", None)
    if z is None:
        raise ValueError("stage_local_zero expects a zero-mode "
                         "MixedPrecisionTrainState (created with "
                         "zero=ZeroConfig(...))")
    p = int(num_stages)
    if p < 1:
        raise ValueError(f"need num_stages >= 1, got {p}")
    mesh = mesh_lib.get_mesh()
    if mesh.shape[PIPE_AXIS] != p:
        raise ValueError(f"num_stages={p} but the mesh has "
                         f"{mesh.shape[PIPE_AXIS]} pipe ranks")
    tops = {n.split(".", 1)[0] for n in state.names}
    keys = tuple(staged) if staged is not None else tuple(
        k for k in tops if k == "stages")
    missing = [k for k in keys if k not in tops]
    if missing or not keys:
        raise ValueError(
            f"staged modules {missing or list(keys)} not found in the "
            f"model (top-level modules: {sorted(tops)}) — pass "
            f"staged=(...) naming the stage modules")
    return state


def _check_stage_local(state, mesh, axis):
    """Raise unless the ZeRO group of ``state`` lies within this rank's
    stage (every member shares its coordinate along ``axis``)."""
    stage = np.take(mesh.ranks, mesh.coords[axis],
                    axis=AXIS_ORDER.index(axis))
    members = set(int(r) for r in stage.reshape(-1))
    if not set(dist.get_process_group_ranks(state.zero_group)) <= members:
        raise ValueError(
            f"the ZeRO group over {state.zero.axis!r} spans pipe stages — "
            f"shard over the data axis so each stage's state stays its "
            f"own")


def pipeline_state_layout(state: Any, *, axis: str = PIPE_AXIS) -> dict:
    """Where this rank's part of a pipelined train state lies: its stage
    and the stage count, and for a zero-mode state its shard of the data
    group and the shard count (the facts the JAX ``pipeline_state_specs``
    spell as ``P(pipe, data)``)."""
    mesh = mesh_lib.get_mesh()
    out = dict(stage=mesh.axis_rank(axis), num_stages=mesh.axis_size(axis),
               params=sum(p.numel() for p in state.module_params))
    if getattr(state, "zero", None) is not None:
        out.update(shard=dist.get_rank(state.zero_group),
                   num_shards=dist.get_world_size(state.zero_group),
                   master_elements=sum(m.numel()
                                       for m in state.opt_state.master))
    return out


# --------------------------------------------------------- the train step

def _grad_tensors(grads) -> List[torch.Tensor]:
    if isinstance(grads, torch.nn.Module):
        return [p.grad for p in grads.parameters() if p.grad is not None]
    return [g for g in tree_leaves(grads) if torch.is_tensor(g)]


def sync_grad_overflow(grads: Any, axis: str = PIPE_AXIS) -> Any:
    """Make the loss-scale step-or-skip decision pipe-global.

    ZeRO's ``apply_gradients`` agrees on overflow over its data group,
    but a non-finite gradient born in one stage's backward is invisible
    to the other stages.  This takes one finite flag over every pipe
    rank (a MIN all-reduce) and, when any rank saw a non-finite value,
    adds NaN to every floating gradient in place, so each stage's
    ``apply_gradients`` skips the step.  ``grads``: tensors in dicts,
    lists or tuples, or a module (its parameters' ``.grad``); returned
    as given.  A rank with no floating gradient still takes part, its
    flag on the mesh's device.  A group of one changes nothing."""
    if schedules.pipe_rank_and_size(axis)[1] == 1:
        return grads
    gs = [g for g in _grad_tensors(grads) if torch.is_floating_point(g)]
    mesh = mesh_lib.get_mesh()
    dev = gs[0].device if gs else mesh.device
    ok = (all_finite(gs).to(device=dev, dtype=torch.int32).reshape(1)
          if gs else torch.ones(1, dtype=torch.int32, device=dev))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group(axis))
    poison = torch.where(ok[0] > 0, torch.zeros((), device=dev),
                         torch.full((), float("nan"), device=dev))
    for g in gs:
        g.add_(poison.to(g.dtype))
    return grads


def run_1f1b(stage_fn: Callable, loss_fn: Callable, stage: Any,
             microbatches: torch.Tensor, *, axis: str = PIPE_AXIS,
             loss_params: Any = None, return_input_cotangents: bool = False):
    """The 1F1B schedule and its reductions over the pipe ranks, on this
    rank's ``stage`` and the ``(M, mb, ...)`` ``microbatches``: returns
    ``(loss, grads)`` — the mean over the microbatches on every rank,
    ``{name: .grad}`` of the stage — plus ``aux`` with ``loss_params`` /
    ``return_input_cotangents`` (``loss_params_grads`` summed over the
    ranks, ``input_cotangents`` ``(M, mb, ...)`` on every rank).  The
    inner half of the JAX ``forward_backward_pipelining_without_
    interleaving``, for use inside a :func:`wrap_pipeline_step` body."""
    out = schedules.spmd_pipeline_1f1b(
        stage_fn, loss_fn, stage, microbatches, axis=axis,
        loss_params=loss_params,
        return_input_cotangents=return_input_cotangents)
    return schedules._collect(out, microbatches.shape[0], loss_params,
                              return_input_cotangents, axis)


def wrap_pipeline_step(body: Callable, *, state: Any, mesh=None,
                       batch_specs: Optional[Sequence[Optional[str]]] = None,
                       axis: str = PIPE_AXIS, data_axis: str = DATA_AXIS
                       ) -> Callable:
    """A pipeline train step on a data × pipe (× tensor) mesh.

    ``body(state, *batch) -> extras`` runs on this rank with its data
    shard of the batch: inside it, call :func:`run_1f1b` for the
    schedule, :func:`sync_grad_overflow` on the gradients, then
    ``state.apply_gradients`` (whose ZeRO reduce-scatter and all-gather
    run over the data group of this stage).  The returned
    ``step(*batch)`` cuts each global batch tensor along its leading dim
    over ``data_axis`` (``batch_specs``: per argument, the axis its
    leading dim splits over, or None for a replicated argument; default
    all split over ``data_axis``) and returns what ``body`` returns; the
    state is updated in place.  A zero-mode ``state`` must be
    stage-local (its ZeRO group within this rank's stage, checked
    here); a plain one leaves the data
    gradient mean to ``body``, as in the JAX function.  The JAX
    function's jit, donation and ``shard_map`` specs have no counterpart:
    every process runs its own part."""
    mesh = mesh or mesh_lib.get_mesh()
    if getattr(state, "zero", None) is not None:
        _check_stage_local(state, mesh, axis)

    def shard(x, spec):
        if spec is None or not torch.is_tensor(x):
            return x
        n, r = mesh.axis_size(spec), mesh.axis_rank(spec)
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not split into "
                             f"{n} along {spec!r}")
        k = x.shape[0] // n
        return x[r * k:(r + 1) * k]

    def step(*batch):
        specs = (batch_specs if batch_specs is not None
                 else (data_axis,) * len(batch))
        if len(specs) != len(batch):
            raise ValueError(f"{len(batch)} batch arguments, "
                             f"{len(specs)} batch_specs")
        return body(state, *(shard(x, s) for x, s in zip(batch, specs)))

    return step
