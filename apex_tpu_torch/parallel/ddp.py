"""Data parallelism over the mesh's data group.

Counterpart of ``apex_tpu/parallel/ddp.py`` (reference
``apex/parallel/distributed.py``).  The JAX package lets GSPMD insert
the gradient all-reduce; here it is an explicit call on the gradients a
backward left, as apex's ``DistributedDataParallel`` makes it:

- :func:`replicate` — every data-parallel replica starts from rank 0's
  parameters and buffers (the constructor's broadcast);
- :func:`shard_batch` — this rank's slice of the batch;
- :func:`all_reduce_mean_grads` — the gradient all-reduce with
  ``gradient_average`` and the wire lever ``allreduce_dtype``: None
  (the gradients' dtype, one bucket a dtype), a half dtype, or
  ``"int8"``, the EQuARX-style quantized all-reduce of the JAX package
  (per leaf: a MAX all-reduce of the amax, int8 ``all_to_all_single``,
  an int32 local sum, requantization, an int8 all-gather);
- :class:`DistributedDataParallel` — the three as one object.

Every call runs its collectives at any group size, one included.

MoE experts sharded over a data-parallel axis (``MoEConfig.expert_axis
= "data"``; such a parameter carries ``expert_axis``) are not replicas
over it: each rank holds other experts, and the layer's token
all-to-all already brought each expert's gradient home, summed over
every rank's tokens.  :func:`replicate` leaves them alone, and
:func:`all_reduce_mean_grads`, given ``params``, leaves their gradients
out of the collective and divides them by the axis size under
``average`` — the unsharded layer's mean-over-data gradient.  Without
``params`` it cannot tell them apart, so once such a layer is built on
the mesh (``Mesh.expert_sharded``) a reduction over its axis whose
gradients' parameters are not all known raises.
:class:`DistributedDataParallel` keeps the parameters it replicated and
finds each gradient's parameter by identity (``p.grad``), so its
``mean_grads([p.grad for p in ...])`` needs no ``params``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import DATA_AXIS, FSDP_AXIS, group_of
from apex_tpu_torch.core.precision import tree_leaves, tree_map
from apex_tpu_torch.transformer.mappings import all_gather

__all__ = [
    "replicate",
    "shard_batch",
    "all_reduce_mean_grads",
    "DistributedDataParallel",
]

_F32_MAX = float(torch.finfo(torch.float32).max)


def _dp_axes(mesh, axes=(DATA_AXIS, FSDP_AXIS)):
    """The data-parallel axes with more than one rank (``data`` if none)."""
    return tuple(a for a in axes if mesh.shape[a] > 1) or (axes[0],)


def _sharded_over(param, axes) -> bool:
    """Whether ``param`` holds MoE experts sharded over one of ``axes``
    (not a replica there)."""
    return getattr(param, "expert_axis", None) in axes


def replicate(tree: Any, mesh=None) -> Any:
    """Broadcast every tensor of ``tree`` (or every parameter and buffer
    of a module) in place from the first rank of this rank's
    data-parallel group (``data`` × ``fsdp``), so all replicas start
    identical; returns ``tree``.  Experts sharded over a data-parallel
    axis are not broadcast (each rank holds its own)."""
    mesh = mesh or mesh_lib.get_mesh()
    axes = _dp_axes(mesh)
    group = mesh.group(axes)
    src = mesh.line(axes)[0]
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
    tensors = [t for t in tensors
               if not _sharded_over(t, (DATA_AXIS, FSDP_AXIS))]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return tree


def shard_batch(batch: Any, mesh=None, *,
                axes: Sequence[str] = (DATA_AXIS, FSDP_AXIS)) -> Any:
    """This rank's slice of the leading (batch) dim of every tensor of
    ``batch``, over the data-parallel axes that have more than one
    rank."""
    mesh = mesh or mesh_lib.get_mesh()
    axes = _dp_axes(mesh, tuple(axes))
    n, r = mesh.axis_size(axes), mesh.axis_rank(axes)

    def take(x):
        if not torch.is_tensor(x):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not split into "
                             f"{n} replicas")
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return tree_map(take, batch)


def _normalize_allreduce_dtype(allreduce_dtype: Any):
    """None | ``"int8"`` | a floating dtype; anything else raises (an int
    dtype reaching ``.to`` would silently zero gradients)."""
    if allreduce_dtype is None:
        return None
    if allreduce_dtype == "int8" or allreduce_dtype == torch.int8:
        return "int8"
    if isinstance(allreduce_dtype, torch.dtype) \
            and allreduce_dtype.is_floating_point:
        return allreduce_dtype
    raise ValueError(
        f"allreduce_dtype must be None, a floating dtype, or 'int8'; "
        f"got {allreduce_dtype!r}")


def _q8_inv_scale_for(amax):
    """``(scale, 1/scale)`` of the int8 amax discipline; a scale of 0
    means an all-zero payload, which dequantizes to exact 0.  An amax
    below ``127 / fp32 max`` (subnormal ones included) would overflow
    ``127 / amax`` to inf and turn 0 · inf into NaN: it counts as zero.
    Divisions are tensor by tensor (CUDA torch turns a division by a
    Python float into a multiply by its reciprocal)."""
    tiny = torch.full_like(amax, 127.0 / _F32_MAX)
    ok = amax > tiny
    safe = torch.maximum(amax, tiny)
    q = torch.full_like(amax, 127.0)
    zero = torch.zeros_like(amax)
    return torch.where(ok, q / safe, zero), torch.where(ok, safe / q, zero)


def _pad_rows(flat, n: int):
    """``(n, ceil(size / n))`` rows, zero-padded: row ``i`` is shard
    ``i``'s slice — the layout shared by the reduce-scatter legs here and
    the ZeRO master shards (:mod:`.distributed_optim`)."""
    m = -(-max(1, flat.numel()) // n)
    out = flat.new_zeros(n * m)
    out[:flat.numel()] = flat
    return out.view(n, m)


def _amax(x, group):
    """The MAX all-reduce of ``|x|``'s max, fp32 (0 for an empty x)."""
    a = (x.abs().amax().float() if x.numel()
         else torch.zeros((), dtype=torch.float32, device=x.device))
    a = a.reshape(1).clone()
    dist.all_reduce(a, op=dist.ReduceOp.MAX, group=group)
    return a[0]


def _q8_reduce_scatter(g, group, n: int):
    """The reduce-scatter leg of the EQuARX int8 collective: quantize
    ``g`` against the group's amax, exchange int8 chunks with
    ``all_to_all_single`` (1 byte an element on the wire), sum them
    locally in int32.  Returns ``(s, inv_scale, amax)``, ``s`` this
    rank's int32 chunk ``(ceil(g.numel() / n),)``."""
    amax = _amax(g, group)
    scale, inv_scale = _q8_inv_scale_for(amax)
    q = torch.clamp(torch.round(g.float() * scale), -127, 127).to(torch.int8)
    rows = _pad_rows(q.reshape(-1), n)
    mine = torch.empty_like(rows)
    dist.all_to_all_single(mine, rows, group=group)
    return mine.to(torch.int32).sum(0, dtype=torch.int32), inv_scale, amax


def _q8_all_reduce(g, group, n: int, average: bool):
    s, inv_scale, amax = _q8_reduce_scatter(g, group, n)
    # the all-gather leg: requantize the int32 partial sums (|s| <= 127 n)
    # against their global amax, so the gather is int8 too
    rscale, inv_rscale = _q8_inv_scale_for(_amax(s, group))
    r = torch.clamp(torch.round(s.float() * rscale), -127,
                    127).to(torch.int8)
    full = all_gather(r, group, 0)
    deq = full.float() * (inv_rscale * inv_scale)
    deq = deq[:g.numel()].reshape(g.shape)
    if average:
        deq = deq / n
    # inf / nan gradients must not vanish: the loss scaler's overflow
    # check reads them
    deq = torch.where(torch.isfinite(amax), deq,
                      torch.full_like(deq, float("nan")))
    return deq.to(g.dtype)


def all_reduce_mean_grads(grads: Any, axis=DATA_AXIS, *,
                          allreduce_dtype: Any = None,
                          average: bool = True, params: Any = None) -> Any:
    """The gradients of ``grads`` (a tensor or a list / tuple / dict of
    them; None passes through) reduced over the ``axis`` group: the mean
    (``average=True``, ``gradient_average``) or the sum.

    ``allreduce_dtype``: None reduces in each gradient's dtype, the
    tensors of one dtype flattened into one bucket (one all-reduce a
    dtype); a half dtype casts before and back after (apex DDP's
    ``allreduce_different_dtype``); ``"int8"`` is the quantized
    all-reduce of the module docstring, per tensor, with non-finite
    gradients coming back NaN.  ``params``: the parameters of the
    gradients, in the same structure; the gradient of one whose experts
    are sharded over ``axis`` (the module docstring) stays out of the
    collective and is divided by the group size under ``average``.
    Without ``params``, or with a None among them, a reduction over an
    axis where an MoE layer of the current mesh holds sharded experts
    raises ``ValueError``.  Returns new tensors."""
    dtype = _normalize_allreduce_dtype(allreduce_dtype)
    group = group_of(axis)
    n = dist.get_world_size(group)
    names = ((axis,) if isinstance(axis, str)
             else axis if isinstance(axis, tuple) else ())
    own, unknown = set(), []

    def sort(g, p):
        if p is None:
            unknown.append(g)
        elif _sharded_over(p, names):
            own.add(id(g))
    if params is None:
        unknown = [g for g in tree_leaves(grads) if torch.is_tensor(g)]
    else:
        tree_map(sort, grads, params)
    experts = sorted(set(names) & (mesh_lib.get_mesh().expert_sharded
                                   if mesh_lib.mesh_is_initialized()
                                   else set()))
    if unknown and experts:
        raise ValueError(
            f"an MoE layer on this mesh holds its experts sharded over "
            f"{experts}: their gradients are not replicas there — pass "
            f"params= (the gradients' parameters, in the same structure) "
            f"so they stay out of the all-reduce")

    def local(g):
        return g / n if average else g.clone()

    if dtype == "int8":
        return tree_map(lambda g: g if g is None else local(g)
                        if id(g) in own else _q8_all_reduce(
                            g, group, n, average), grads)
    leaves = [g for g in tree_leaves(grads)
              if torch.is_tensor(g) and id(g) not in own]
    wire = {}
    for g in leaves:
        wire.setdefault(g.dtype if dtype is None else dtype, []).append(g)
    out = {id(g): local(g) for g in tree_leaves(grads) if id(g) in own}
    for wdt, gs in wire.items():
        flat = torch.cat([g.reshape(-1).to(wdt) for g in gs])
        dist.all_reduce(flat, group=group)
        if average:
            flat = flat / n
        for g, part in zip(gs, torch.split(flat, [g.numel() for g in gs])):
            out[id(g)] = part.view(g.shape).to(g.dtype)
    return tree_map(lambda g: out[id(g)] if torch.is_tensor(g) else g,
                    grads)


class DistributedDataParallel:
    """apex's ``DistributedDataParallel`` as three calls: replicate the
    parameters, shard the batch, reduce the gradients.

    Usage::

        ddp = DistributedDataParallel()
        ddp.replicate(model)
        batch = ddp.shard(batch)
        loss = state.scale_loss(loss_fn(model(batch)))
        loss.backward()
        grads = ddp.mean_grads([p.grad for p in state.module_params])
        state.apply_gradients(grads)

    ``mean_grads`` finds each gradient's parameter among the ones
    :meth:`replicate` saw (by ``p.grad`` identity), so the experts of an
    MoE layer sharded over the data axis stay out of the all-reduce (the
    module docstring).
    """

    def __init__(self, mesh=None, *, gradient_average: bool = True,
                 allreduce_dtype: Any = None):
        self.mesh = mesh or mesh_lib.get_mesh()
        self.gradient_average = gradient_average
        self.allreduce_dtype = allreduce_dtype
        _normalize_allreduce_dtype(allreduce_dtype)
        self.params: list = []

    def replicate(self, params: Any) -> Any:
        self.params = (list(params.parameters())
                       if isinstance(params, torch.nn.Module)
                       else [t for t in tree_leaves(params)
                             if torch.is_tensor(t)])
        return replicate(params, self.mesh)

    def shard(self, batch: Any) -> Any:
        return shard_batch(batch, self.mesh)

    def mean_grads(self, grads: Any, axis: Any = DATA_AXIS,
                   params: Any = None) -> Any:
        """``grads`` reduced over the ``axis`` group; ``params`` (see
        :func:`all_reduce_mean_grads`) defaults to the replicated
        parameters whose ``.grad`` each gradient is."""
        if params is None and self.params:
            by_grad = {id(p.grad): p for p in self.params
                       if p.grad is not None}
            params = tree_map(lambda g: by_grad.get(id(g)), grads)
        return all_reduce_mean_grads(
            grads, axis, allreduce_dtype=self.allreduce_dtype,
            average=self.gradient_average, params=params)
