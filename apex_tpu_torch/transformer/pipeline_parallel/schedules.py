"""Pipeline-parallel schedules — the microbatch engine.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/schedules.py``
(reference ``apex/transformer/pipeline_parallel/schedules/``):
``forward_backward_no_pipelining``, the one-forward-one-backward
schedule with and without interleaving, dispatched by
``get_forward_backward_func()``, and the autograd forward pipelines
``spmd_pipeline`` / ``spmd_pipeline_interleaved``.

Where the JAX engine is one ``lax.scan`` over a tick table that stashes
stage *inputs* and recomputes each stage inside its backward unit, this
one is Megatron's: every rank runs its units in the reference's order
(warm-up forwards, then one forward and one backward, then cool-down
backwards; interleaved, the virtual-stage order of
``fwd_bwd_pipelining_with_interleaving``) and keeps the autograd graph
of each microbatch from its forward to its backward.  The graphs alive
on a rank are at most ``pp - rank`` without interleaving (with it, the
reference's warm-up count plus one), flat in M; :data:`last_run` records
the peak of the last run.

The order of the units is turned into slots before anything runs
(:func:`_timeline`): in each slot every rank runs at most one unit, as
soon as the activation or gradient it needs arrived in an earlier slot,
and after the slot every rank posts the sends and receives of that slot
as one batch (:func:`~apex_tpu_torch.transformer.pipeline_parallel.p2p.
exchange`).  Every rank derives the same slots, so each send meets its
receive in the same batch and no rank waits on a neighbour that waits
on it.  What the JAX engine computes for its dead warm-up and cool-down
ticks (``lax.cond``, masking) has no counterpart: a rank with nothing
to run in a slot runs nothing.

The contract of the JAX schedule functions is kept: ``stage_fn(stage, x)`` maps a
microbatch ``(mb, ...)`` to one of the same shape and dtype, ``loss_fn(y,
microbatch_index)`` (or ``loss_fn(loss_params, y, i)``) scores the last
stage's output, the loss is the mean over the M microbatches on every
rank (each microbatch's backward seeded with ``1/M``), and the
gradients accumulate into the stage parameters' ``.grad`` (in their
dtype, as the JAX engine's accumulator takes the parameters' dtype).
``loss_params`` (leaf tensors every pipe rank holds; every leaf the loss
reads must be one of them) get their gradients summed over the pipe
ranks, in ``aux["loss_params_grads"]`` and in their ``.grad``;
``return_input_cotangents`` gives ``aux["input_cotangents"]``, ``(M, mb,
...)``, dL/dh of each input microbatch, on every rank.  Only pipe rank 0
reads the microbatches; every rank passes a batch of their shape and
dtype.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import PIPE_AXIS
from apex_tpu_torch.core.precision import tree_map
from apex_tpu_torch.transformer.microbatches import get_num_microbatches
from apex_tpu_torch.transformer.pipeline_parallel.p2p import (
    BACKWARD_TAG,
    FORWARD_TAG,
    connect,
    exchange,
    pipe_rank_and_size,
    send_forward_recv_forward,
)

__all__ = [
    "spmd_pipeline",
    "spmd_pipeline_1f1b",
    "spmd_pipeline_1f1b_interleaved",
    "spmd_pipeline_interleaved",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "get_forward_backward_func",
    "last_run",
]

#: the last one-forward-one-backward run of this process: ``peak_live``
#: (most microbatch graphs held at once) and ``slots``
last_run: Dict[str, int] = {}


def _pipe(axis):
    m = mesh_lib.get_mesh()
    return m.group(axis), m.line(axis)


def _all_reduce(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over the pipe ranks, in place (nothing at one)."""
    if pipe_rank_and_size(axis)[1] > 1:
        dist.all_reduce(t, group=_pipe(axis)[0])
    return t


def _broadcast(t: torch.Tensor, src: int, axis) -> torch.Tensor:
    """Pipe rank ``src``'s ``t`` on every pipe rank, in place."""
    if pipe_rank_and_size(axis)[1] > 1:
        group, line = _pipe(axis)
        dist.broadcast(t, src=line[src], group=group)
    return t


class _FromLast(torch.autograd.Function):
    """The last pipe rank's tensor on every pipe rank; every rank's loss
    on it is the same loss, so its gradient enters at the last rank
    only (the transpose of the JAX masked ``psum``)."""

    @staticmethod
    def forward(ctx, x, axis):
        rank, pp = pipe_rank_and_size(axis)
        ctx.last = rank == pp - 1
        return _broadcast(x.clone(), pp - 1, axis)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _body(stage_fn, remat):
    if not remat:
        return stage_fn
    return lambda stage, x: checkpoint(stage_fn, stage, x,
                                       use_reentrant=False)


# --------------------------------------------------------------------- #
# the forward pipelines autograd differentiates
# --------------------------------------------------------------------- #
def spmd_pipeline(stage_fn: Callable, stage: Any,
                  microbatches: torch.Tensor, *, axis: str = PIPE_AXIS,
                  remat: bool = True) -> torch.Tensor:
    """Run ``microbatches`` ``(M, mb, ...)`` through a ``pp``-stage
    pipeline of this rank's ``stage``: ``M + pp - 1`` ticks, each a
    stage call and a ring exchange (:func:`~apex_tpu_torch.transformer.
    pipeline_parallel.p2p.send_forward_recv_forward`, whose backward is
    the reverse exchange).  Returns the last stage's ``(M, mb, ...)``
    outputs on every rank; ``.backward()`` of a loss on them runs the
    reverse pipeline.  Like the JAX function, every rank computes every
    tick (the warm-up and drain ticks on what the ring holds, their
    outputs dropped), so each rank's backward runs every exchange.
    ``remat``: each stage call is recomputed in the backward."""
    rank, pp = pipe_rank_and_size(axis)
    m = microbatches.shape[0]
    body = _body(stage_fn, remat)
    first = torch.tensor(rank == 0, device=microbatches.device)
    recv = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(m + pp - 1):
        y = body(stage, torch.where(first, microbatches[min(t, m - 1)],
                                    recv))
        ys.append(y)
        if t < m + pp - 2:
            recv = send_forward_recv_forward(y, axis=axis)
    return _FromLast.apply(torch.stack(ys[pp - 1:]), axis)


def spmd_pipeline_interleaved(stage_fn: Callable, chunks: Sequence[Any],
                              microbatches: torch.Tensor, *,
                              axis: str = PIPE_AXIS,
                              remat: bool = True) -> torch.Tensor:
    """The virtual-pipeline forward: this rank holds the ``V`` model
    ``chunks``, chunk ``c`` being global stage ``c·pp + rank``.  Item
    ``i = t - rank`` of tick ``t`` is ``(group g, lap c, slot j)`` with
    ``i = g·V·pp + c·pp + j`` and microbatch ``g·pp + j``, so the ring's
    wrap from the last rank to rank 0 is the hand-off from lap ``c`` to
    ``c + 1``.  Requires ``M % pp == 0``.  Returns the last lap's
    ``(M, mb, ...)`` outputs on every rank, as :func:`spmd_pipeline`."""
    rank, pp = pipe_rank_and_size(axis)
    m, v = microbatches.shape[0], len(chunks)
    _check_interleaved(m, pp)
    body = _body(stage_fn, remat)
    n_items = m * v
    recv = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(n_items + pp - 1):
        iv = min(max(t - rank, 0), n_items - 1)
        g, rem = divmod(iv, v * pp)
        c, j = divmod(rem, pp)
        fresh = torch.tensor(rank == 0 and c == 0,
                             device=microbatches.device)
        y = body(chunks[c], torch.where(fresh, microbatches[g * pp + j],
                                        recv))
        ys.append(y)
        if t < n_items + pp - 2:
            recv = send_forward_recv_forward(y, axis=axis)
    out_ticks = [(k // pp) * v * pp + (v - 1) * pp + k % pp + pp - 1
                 for k in range(m)]
    return _FromLast.apply(torch.stack([ys[t] for t in out_ticks]), axis)


def _check_interleaved(m, pp):
    if m % pp:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({m}) % "
            f"pipeline size ({pp}) == 0 (reference constraint)")


# --------------------------------------------------------------------- #
# one forward, one backward
# --------------------------------------------------------------------- #
def _unit(k: int, pp: int, v: int, forward: bool) -> Tuple[int, int]:
    """``(chunk, microbatch)`` of the ``k``-th forward (backward) unit
    of a rank: groups of ``pp`` microbatches lap the chunks in order
    (reversed in the backward)."""
    c = (k % (pp * v)) // pp
    return (c if forward else v - 1 - c), (k // (pp * v)) * pp + k % pp


def _order(rank: int, pp: int, m: int, v: int) -> List[Tuple]:
    """Rank ``rank``'s units in the reference's order: warm-up forwards,
    then one forward and one backward, then cool-down backwards."""
    total = m * v
    if v == 1:
        warm = min(pp - rank - 1, total)
    elif m == pp:
        warm = total
    else:
        warm = min((pp - rank - 1) * 2 + (v - 1) * pp, total)
    units = [("F",) + _unit(k, pp, v, True) for k in range(warm)]
    for i in range(total - warm):
        units += [("F",) + _unit(warm + i, pp, v, True),
                  ("B",) + _unit(i, pp, v, False)]
    units += [("B",) + _unit(k, pp, v, False)
              for k in range(total - warm, total)]
    return units


def _needs(kind, rank, c, mb, pp, v):
    """The unit whose result ``(kind, rank, c, mb)`` consumes, as
    ``(kind, rank, c, mb)``, or None (a fresh microbatch)."""
    if kind == "F":
        if rank > 0:
            return ("F", rank - 1, c, mb)
        return ("F", pp - 1, c - 1, mb) if c > 0 else None
    if rank < pp - 1:
        return ("B", rank + 1, c, mb)
    if c < v - 1:
        return ("B", 0, c + 1, mb)
    return ("F", rank, c, mb)                 # its own loss


def _consumer(kind, rank, c, mb, pp, v):
    """Where the result of ``(kind, rank, c, mb)`` goes: ``(rank, key)``
    with ``key`` the consuming unit's ``(kind, c, mb)``, or None."""
    if kind == "F":
        if rank < pp - 1:
            return rank + 1, ("F", c, mb)
        return (0, ("F", c + 1, mb)) if c < v - 1 else None
    if rank > 0:
        return rank - 1, ("B", c, mb)
    return (pp - 1, ("B", c - 1, mb)) if c > 0 else None


@functools.lru_cache(maxsize=64)
def _timeline(pp: int, m: int, v: int) -> Tuple[Tuple, ...]:
    """The slots: per slot, each rank's unit ``(kind, c, mb)`` or None.
    A rank runs its next unit (in :func:`_order`) in the first slot
    after the one that produced what the unit needs."""
    orders = [_order(r, pp, m, v) for r in range(pp)]
    pos, done, slots = [0] * pp, {}, []
    while any(pos[r] < len(orders[r]) for r in range(pp)):
        s = len(slots)
        row = []
        for r in range(pp):
            unit = orders[r][pos[r]] if pos[r] < len(orders[r]) else None
            dep = None if unit is None else _needs(unit[0], r, *unit[1:],
                                                    pp, v)
            ready = unit is not None and (dep is None
                                          or done.get(dep, s) < s)
            row.append(unit if ready else None)
        if not any(row):
            raise RuntimeError(f"pipeline schedule stalls (pp={pp}, "
                               f"M={m}, V={v})")
        for r, unit in enumerate(row):
            if unit is not None:
                done[(unit[0], r) + unit[1:]] = s
                pos[r] += 1
        slots.append(tuple(row))
    return tuple(slots)


def _loss_leaves(loss_params):
    leaves = list(loss_params)
    if not all(torch.is_tensor(p) and p.is_leaf and p.requires_grad
               for p in leaves):
        raise ValueError("loss_params must be leaf tensors that require "
                         "grad (the closure's parameters)")
    return leaves


def _run_1f1b(stage_fn, loss_fn, chunks, microbatches, axis, loss_params,
              return_input_cotangents):
    rank, pp = pipe_rank_and_size(axis)
    m, v = microbatches.shape[0], len(chunks)
    if v > 1:
        _check_interleaved(m, pp)
    last = rank == pp - 1
    shape, dtype = microbatches.shape[1:], microbatches.dtype
    dev = microbatches.device
    lp = None if loss_params is None else _loss_leaves(loss_params)
    inv_m = torch.tensor(1.0, dtype=torch.float32) / m
    inbox: Dict[Tuple, torch.Tensor] = {}
    stash: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
    loss_local = torch.zeros((), dtype=torch.float32, device=dev)
    cts = (torch.zeros((m,) + tuple(shape), dtype=dtype, device=dev)
           if return_input_cotangents else None)
    peak = 0
    slots = _timeline(pp, m, v)
    connect(dev, axis=axis)
    for row in slots:
        sends, recvs = [], []
        unit = row[rank]
        if unit is not None:
            kind, c, mb = unit
            if kind == "F":
                if rank == 0 and c == 0:
                    x = microbatches[mb].detach()
                    x.requires_grad_(return_input_cotangents)
                else:
                    x = inbox.pop(("F", c, mb)).requires_grad_(True)
                out = y = stage_fn(chunks[c], x)
                if last and c == v - 1:
                    out = (loss_fn(y, mb) if lp is None
                           else loss_fn(loss_params, y, mb))
                    loss_local += out.detach().float()
                stash[(c, mb)] = (x, out)
                peak = max(peak, len(stash))
                result = y.detach()
            else:
                x, out = stash.pop((c, mb))
                grad = (inv_m.to(out.dtype).to(dev).expand_as(out)
                        if last and c == v - 1 else inbox.pop(("B", c, mb)))
                torch.autograd.backward(out, grad)
                result = (x.grad if x.grad is not None
                          else torch.zeros_like(x)) if x.requires_grad \
                    else None
                if rank == 0 and c == 0 and cts is not None:
                    cts[mb] = result
            dest = _consumer(kind, rank, c, mb, pp, v)
            if dest is not None and dest[0] == rank:
                inbox[dest[1]] = result
            elif dest is not None:
                sends.append((result, dest[0],
                              FORWARD_TAG if kind == "F" else BACKWARD_TAG))
        for q, other in enumerate(row):
            if other is None or q == rank:
                continue
            dest = _consumer(other[0], q, *other[1:], pp, v)
            if dest is not None and dest[0] == rank:
                buf = torch.empty(shape, dtype=dtype, device=dev)
                inbox[dest[1]] = buf
                recvs.append((buf, q, FORWARD_TAG if other[0] == "F"
                              else BACKWARD_TAG))
        if sends or recvs:
            exchange(sends, recvs, axis=axis)
    last_run.update(peak_live=peak, slots=len(slots))
    named = chunks[0] if v == 1 else torch.nn.ModuleList(chunks)
    grads = {n: p.grad for n, p in named.named_parameters()}
    if lp is None and not return_input_cotangents:
        return loss_local, grads
    extras = {}
    if lp is not None:
        for p in lp:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        extras["loss_params_grads"] = tuple(p.grad for p in lp)
    if return_input_cotangents:
        extras["input_cotangents"] = cts
    return loss_local, grads, extras


def spmd_pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stage: Any,
                       microbatches: torch.Tensor, *,
                       axis: str = PIPE_AXIS, loss_params: Any = None,
                       return_input_cotangents: bool = False):
    """One-forward-one-backward through this rank's ``stage`` (module
    docstring), rank-local results as the JAX function's:
    ``(loss_local, grads_local)`` — the sum of the microbatch losses on
    the last rank, 0 elsewhere, and ``{name: .grad}`` of ``stage`` —
    plus ``extras`` (``"loss_params_grads"`` of this rank,
    ``"input_cotangents"`` filled on rank 0) when ``loss_params`` or
    ``return_input_cotangents`` is given.  :func:`forward_backward_
    pipelining_without_interleaving` and ``parallel.pipeline.run_1f1b``
    add the reductions over the ranks."""
    return _run_1f1b(stage_fn, loss_fn, [stage], microbatches, axis,
                     loss_params, return_input_cotangents)


def spmd_pipeline_1f1b_interleaved(stage_fn: Callable, loss_fn: Callable,
                                   chunks: Sequence[Any],
                                   microbatches: torch.Tensor, *,
                                   axis: str = PIPE_AXIS,
                                   loss_params: Any = None,
                                   return_input_cotangents: bool = False):
    """The interleaved form of :func:`spmd_pipeline_1f1b`: this rank's
    ``V`` ``chunks`` (chunk ``c`` is global stage ``c·pp + rank``), each
    microbatch lapping the ring ``V`` times; ``grads_local`` is keyed
    ``"<chunk>.<name>"``.  Requires ``M % pp == 0``."""
    return _run_1f1b(stage_fn, loss_fn, list(chunks), microbatches, axis,
                     loss_params, return_input_cotangents)


def _collect(out, m, loss_params, return_input_cotangents, axis):
    """The reductions over the pipe ranks: the mean loss on every rank,
    the loss-parameter gradients summed, the input cotangents of rank 0
    on every rank."""
    loss = _all_reduce(out[0].clone(), axis) / m
    if loss_params is None and not return_input_cotangents:
        return loss, out[1]
    extras, aux = out[2], {}
    if loss_params is not None:
        aux["loss_params_grads"] = tuple(
            _all_reduce(g, axis) for g in extras["loss_params_grads"])
    if return_input_cotangents:
        aux["input_cotangents"] = _broadcast(extras["input_cotangents"], 0,
                                             axis)
    return loss, out[1], aux


def _split(batch, m):
    return batch.reshape(m, batch.shape[0] // m, *batch.shape[1:])


# --------------------------------------------------------------------- #
# reference-named schedule functions
# --------------------------------------------------------------------- #
def forward_backward_no_pipelining(forward_step_func: Callable, batch: Any,
                                   model: torch.nn.Module, *,
                                   num_microbatches: Optional[int] = None):
    """Gradient accumulation over microbatches, no pipeline (reference
    ``fwd_bwd_no_pipelining.py``).  ``forward_step_func(model,
    microbatch) -> scalar loss`` (its mean over the microbatch);
    ``batch`` a tensor, or a tuple / list / dict of tensors, whose
    leading ``(M·mb)`` dim is cut into M microbatches.  Each
    microbatch's backward is seeded with ``1/M`` and accumulates into
    ``.grad``, as the pipelined schedules do.  Returns ``(mean_loss,
    {name: .grad})``."""
    m = num_microbatches or get_num_microbatches()
    mbs = tree_map(lambda x: _split(x, m), batch)
    inv_m = torch.tensor(1.0, dtype=torch.float32) / m
    total = None
    for i in range(m):
        loss = forward_step_func(model, tree_map(lambda x: x[i], mbs))
        torch.autograd.backward(loss, inv_m.to(loss.dtype).to(loss.device))
        total = loss.detach().float() if total is None \
            else total + loss.detach().float()
    return total / m, {n: p.grad for n, p in model.named_parameters()}


def forward_backward_pipelining_without_interleaving(
    stage_fn: Callable, loss_fn: Callable, stage: Any, batch: torch.Tensor,
    *, num_microbatches: Optional[int] = None, axis: str = PIPE_AXIS,
    loss_params: Any = None, return_input_cotangents: bool = False,
):
    """Pipelined forward and backward, 1F1B (reference
    ``fwd_bwd_pipelining_without_interleaving.py``): ``batch`` ``(M·mb,
    ...)`` cut into M microbatches through this rank's ``stage``.
    Returns ``(loss, grads)``, or ``(loss, grads, aux)`` with
    ``loss_params`` / ``return_input_cotangents`` (module docstring)."""
    m = num_microbatches or get_num_microbatches()
    out = spmd_pipeline_1f1b(stage_fn, loss_fn, stage, _split(batch, m),
                             axis=axis, loss_params=loss_params,
                             return_input_cotangents=return_input_cotangents)
    return _collect(out, m, loss_params, return_input_cotangents, axis)


def forward_backward_pipelining_with_interleaving(
    stage_fn: Callable, loss_fn: Callable, chunks: Sequence[Any],
    batch: torch.Tensor, *, num_microbatches: Optional[int] = None,
    axis: str = PIPE_AXIS, loss_params: Any = None,
    return_input_cotangents: bool = False,
):
    """Interleaved pipelined forward and backward (reference
    ``fwd_bwd_pipelining_with_interleaving.py``): as
    :func:`forward_backward_pipelining_without_interleaving` over this
    rank's ``V`` ``chunks``.  Requires ``num_microbatches % pp == 0``."""
    m = num_microbatches or get_num_microbatches()
    out = spmd_pipeline_1f1b_interleaved(
        stage_fn, loss_fn, chunks, _split(batch, m), axis=axis,
        loss_params=loss_params,
        return_input_cotangents=return_input_cotangents)
    return _collect(out, m, loss_params, return_input_cotangents, axis)


def get_forward_backward_func(
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
):
    """Reference dispatch (``schedules/common.py``): pick the schedule
    from the pipeline topology."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None \
                and virtual_pipeline_model_parallel_size > 1:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
