"""Mixed-precision train state — policy, loss scaler and optimizer.

Counterpart of ``apex_tpu/core/train_state.py`` in torch idiom.  It
holds

- the module the forward runs, its parameters cast by the policy (bf16
  with fp32 norm parameters under O2);
- the stored parameters the optimizer updates: fp32 masters under O2
  (apex's master weights), else the module's own parameters;
- the optimizer state and the loss-scale state, on the device.

Under O1 (``policy.per_op_casting``) the module keeps fp32 parameters,
which are views of the flat fp32 buffer, with no masters; the forward
runs on a compute copy (:class:`ComputeCopy`): each module's parameters
cast to the half dtype by a differentiable cast as the module is called,
norm parameters kept fp32 — the JAX package's ``compute_params()`` (the
policy's ``cast_to_compute``), whose gradients arrive in the half dtype
and are upcast by the cast's backward.

The stored parameters live in one flat buffer per dtype (the module's
parameters are views into it when there are no masters), so unscaling,
the overflow check and the optimizer update each run once over every
parameter, as apex's multi-tensor kernels do.  An optimizer whose state
is laid out per parameter (FusedAdam with fp8 moments, ``per_leaf``)
is also given each buffer's parameters in order — their sizes, and the
shape of each linear layer's weight, whose JAX kernel is its
transpose (:meth:`MixedPrecisionTrainState.leaves`).

:meth:`apply_gradients` follows the JAX order: upcast the grads to the
stored dtype, unscale, check finiteness, update, keep the old values on
a non-finite step, adjust the scale, copy the masters back into the
module.  Nothing in it reads the device from the host: the returned
``finite`` flag is a device tensor.

ZeRO mode (``zero=ZeroConfig(...)`` at :meth:`MixedPrecisionTrainState.
create`, :mod:`apex_tpu_torch.parallel.distributed_optim`): the module's
parameters are grouped by their dtype after the policy's cast, and each
group's fp32 masters are kept as this rank's row of the ZeRO layout, the
optimizer state beside them.  :meth:`apply_gradients` then takes each
rank's own (un-synced) gradients: it reduce-scatters them into fp32
shards (the gradient sync), unscales, takes one finiteness flag for the
whole group (a MIN all-reduce), updates the shards, and all-gathers them
in the parameters' dtype into the module — as the JAX package's
``_apply_gradients_zero`` does inside ``shard_map``.  MoE experts
sharded over the ZeRO axis (``expert_axis``, not replicas there) stay
out of the shards: each rank keeps their whole fp32 masters and state,
and their gradient — the sum over the axis that the layer's all-to-all
brought home — divided by the axis size is the mean the shards get.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from apex_tpu_torch.core.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    all_finite,
)
from apex_tpu_torch.core.mesh import group_of
from apex_tpu_torch.core.precision import PrecisionPolicy
from apex_tpu_torch.optim.fused_adam import Leaf, adam_state_from_jax

__all__ = ["MixedPrecisionTrainState", "ComputeCopy", "parameter_leaves"]


def parameter_leaves(model: nn.Module) -> List[Tuple[str, Leaf]]:
    """The floating parameters of ``model`` in ``named_parameters()``
    order as ``(name, Leaf)``: the size, and for the 2-D weight of a
    linear layer — ``(out, in)`` here, the transpose of the JAX
    package's ``(in, out)`` kernel — its shape."""
    from apex_tpu_torch.transformer.layers import (
        ColumnParallelLinear, RowParallelLinear)
    linear = (nn.Linear, ColumnParallelLinear, RowParallelLinear)
    weights = {f"{m}.weight" if m else "weight"
               for m, mod in model.named_modules() if isinstance(mod, linear)}
    return [(n, Leaf(p.numel(), tuple(p.shape)
                     if n in weights and p.ndim == 2 else None))
            for n, p in model.named_parameters() if torch.is_floating_point(p)]


class _Group:
    """Parameters that share a stored dtype: their flat buffer and a
    view of it per parameter."""

    def __init__(self, dtype, indices: List[int], params):
        self.dtype = dtype
        self.indices = indices
        self.flat = torch.cat([params[i].detach().reshape(-1).to(dtype)
                               for i in indices])
        self.views = []
        off = 0
        for i in indices:
            n = params[i].numel()
            self.views.append(self.flat[off:off + n].view(params[i].shape))
            off += n


class ComputeCopy:
    """O1's compute copy of ``model``'s parameters (see the module
    docstring), made by module hooks that this object owns.

    Each parameter the policy casts (``policy.dtype_for(name,
    compute_dtype)`` differs from its dtype) is shadowed by ``param.
    to(dtype)`` in its module's ``__dict__`` under its name, so
    ``module.weight`` reads the cast while ``named_parameters()`` and
    ``state_dict()`` keep the parameter.  The model's forward puts every
    cast in place as it starts and takes them away as it returns, as the
    JAX package's forward takes ``compute_params()`` whole; a submodule
    called on its own — or recomputed in the backward by ``torch.utils.
    checkpoint``, outside the model's forward — casts its own parameters
    for its call.  :meth:`remove` takes the hooks away."""

    def __init__(self, model: nn.Module, policy: PrecisionPolicy):
        self._depth = 0
        self._casts = []
        self._handles = [
            model.register_forward_pre_hook(self._enter),
            model.register_forward_hook(self._leave, always_call=True)]
        for prefix, mod in model.named_modules():
            own = []
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{prefix}.{pname}" if prefix else pname
                dt = policy.dtype_for(name, policy.compute_dtype)
                if torch.is_floating_point(p) and dt != p.dtype:
                    own.append((pname, dt))
            if own:
                self._casts.append((mod, own))
                self._handles += [
                    mod.register_forward_pre_hook(functools.partial(
                        self._own_call, own)),
                    mod.register_forward_hook(functools.partial(
                        self._own_return, own), always_call=True)]

    @staticmethod
    def _install(mod, own):
        for pname, dt in own:
            mod.__dict__[pname] = mod._parameters[pname].to(dt)

    @staticmethod
    def _drop(mod, own):
        for pname, _ in own:
            mod.__dict__.pop(pname, None)

    def _own_call(self, own, mod, args):
        if not self._depth:
            self._install(mod, own)

    def _own_return(self, own, mod, args, out):
        if not self._depth:
            self._drop(mod, own)

    def _enter(self, mod, args):
        self._depth += 1
        if self._depth == 1:
            for m, own in self._casts:
                self._install(m, own)

    def _leave(self, mod, args, out):
        self._depth -= 1
        if not self._depth:
            for m, own in self._casts:
                self._drop(m, own)

    def remove(self) -> None:
        """Take the hooks away (the module's forward then reads its fp32
        parameters)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        for m, own in self._casts:
            self._drop(m, own)


class MixedPrecisionTrainState:
    """Train state over ``model`` (see the module docstring); build it
    with :meth:`create` or ``amp.initialize``."""

    def __init__(self, model: nn.Module, optimizer, policy: PrecisionPolicy,
                 loss_scaler: DynamicLossScale, zero=None):
        self.model = model
        self.tx = optimizer
        self.policy = policy
        self.loss_scaler = loss_scaler
        named = [(n, p) for n, p in model.named_parameters()
                 if torch.is_floating_point(p)]
        self.names = [n for n, _ in named]
        self.module_params = [p for _, p in named]
        device = self.module_params[0].device
        self.zero = None
        self.loss_scale_state: LossScaleState = loss_scaler.init(device)
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        if zero is not None:
            self._init_zero(zero)
            return
        # stored copy: fp32 masters (O2) or the params in their storage
        # dtype (norm params fp32 under keep_batchnorm_fp32)
        if policy.master_weights:
            stored = [torch.float32] * len(named)
        else:
            stored = [policy.dtype_for(n, policy.param_dtype)
                      for n in self.names]
        self.groups: List[_Group] = []
        for dt in dict.fromkeys(stored):
            idx = [i for i, s in enumerate(stored) if s == dt]
            self.groups.append(_Group(dt, idx, self.module_params))
        # O1 casts on the way into each module, O2 / O3 once, here
        self.compute_copy = (ComputeCopy(model, policy)
                             if policy.per_op_casting else None)
        if not policy.per_op_casting:
            policy.cast_to_compute(model)
        if not policy.master_weights:
            # the module trains its stored params directly: make them
            # views of the flat buffers
            for g in self.groups:
                for i, view in zip(g.indices, g.views):
                    self.module_params[i].data = view
        self._leaves = parameter_leaves(model)
        flats = [g.flat for g in self.groups]
        if getattr(optimizer, "per_leaf", False):
            self.opt_state = optimizer.init(
                flats, [[lf for _, lf in b] for b in self.leaves()])
        else:
            self.opt_state = optimizer.init(flats)

    def _init_zero(self, zero):
        """The ZeRO layout (module docstring): groups by the parameters'
        dtype after the cast, fp32 master rows taken before it."""
        from apex_tpu_torch.parallel import distributed_optim as zero_lib
        from apex_tpu_torch.parallel.ddp import _pad_rows

        policy, opt = self.policy, self.tx
        if getattr(opt, "moment_format", "dense") != "dense":
            raise ValueError(
                "fp8 moments lay their blocks over whole parameters, not "
                "ZeRO shards: use a dense moment_dtype with zero=")
        self.zero = zero.resolved()
        # MoE experts sharded over the ZeRO axis are not replicas there:
        # they stay out of the shards, each rank keeping whole masters
        local = {i for i, p in enumerate(self.module_params)
                 if getattr(p, "expert_axis", None) == self.zero.axis}
        if local and getattr(opt, "shard_axis", None) is not None:
            raise ValueError(
                "an optimizer that reduces its norms over the ZeRO shards "
                "(LAMB's shard_axis) would mix other ranks' experts into "
                "the experts sharded over that axis: use "
                "distributed_fused_adam")
        self.zero_group = group_of(self.zero.axis)
        n = dist.get_world_size(self.zero_group)
        if n != self.zero.axis_size:
            raise ValueError(f"ZeroConfig.axis_size {self.zero.axis_size} "
                             f"!= the {self.zero.axis!r} group's {n} ranks")
        rank = dist.get_rank(self.zero_group)
        after = [p.dtype if policy.per_op_casting
                 else policy.dtype_for(name, policy.compute_dtype)
                 for name, p in zip(self.names, self.module_params)]
        def by_dtype(keep):
            return [(dt, idx) for dt in dict.fromkeys(after) for idx in (
                [i for i, a in enumerate(after) if a == dt and keep(i)],)
                if idx]
        self.zero_groups = by_dtype(lambda i: i not in local)
        self.local_groups = by_dtype(lambda i: i in local)
        masters = []
        for _, idx in self.zero_groups:
            flat = torch.cat([self.module_params[i].detach().reshape(-1)
                              .float() for i in idx])
            masters.append(_pad_rows(flat, n)[rank].clone())
            del flat
        local_masters = [torch.cat([self.module_params[i].detach().reshape(
            -1).float() for i in idx]) for _, idx in self.local_groups]
        self.compute_copy = (ComputeCopy(self.model, policy)
                             if policy.per_op_casting else None)
        if not policy.per_op_casting:
            policy.cast_to_compute(self.model)
        self._leaves = parameter_leaves(self.model)
        sizes = [[self.module_params[i].numel() for i in idx]
                 for _, idx in self.zero_groups]
        per_leaf = getattr(opt, "per_leaf", False)
        if per_leaf:
            inner = opt.init(masters, [
                [Leaf(k) for k in zero_lib.shard_segments(sz, rank, n)]
                for sz in sizes])
        else:
            inner = opt.init(masters)
        local_inner = None
        if local_masters:
            local_inner = (opt.init(local_masters, [
                [self._leaves[i][1] for i in idx]
                for _, idx in self.local_groups])
                if per_leaf else opt.init(local_masters))
        self.opt_state = zero_lib.ZeroOptState(
            master=masters, inner=inner, local_master=local_masters,
            local_inner=local_inner)

    @classmethod
    def create(cls, *, model: nn.Module, optimizer,
               policy: Optional[PrecisionPolicy] = None,
               loss_scaler: Optional[DynamicLossScale] = None,
               zero=None) -> "MixedPrecisionTrainState":
        """The train state; ``zero``: a
        :class:`~apex_tpu_torch.parallel.distributed_optim.ZeroConfig`
        for ZeRO-sharded masters and optimizer state (needs a mesh)."""
        policy = policy or PrecisionPolicy.O0()
        return cls(model, optimizer, policy,
                   loss_scaler or policy.make_loss_scale(), zero)

    # ------------------------------------------------------------------ #
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The stored params by name (fp32 masters under O2; in ZeRO
        mode the module's parameters, the masters being sharded)."""
        if self.zero is not None:
            return dict(zip(self.names, self.module_params))
        out = {}
        for g in self.groups:
            for i, view in zip(g.indices, g.views):
                out[self.names[i]] = view
        return out

    def compute_params(self) -> Dict[str, torch.Tensor]:
        """The stored params cast for the forward pass (the "model copy"
        of apex O2: half, norm params fp32 under the filter)."""
        return self.policy.cast_to_compute(self.params)

    def leaves(self) -> List[List[Tuple[str, Leaf]]]:
        """Per flat buffer, its parameters in order as ``(name, Leaf)``
        (see :func:`parameter_leaves`)."""
        if self.zero is not None:
            return [[self._leaves[i] for i in idx]
                    for _, idx in self.zero_groups + self.local_groups]
        return [[self._leaves[i] for i in g.indices] for g in self.groups]

    def master_params(self) -> Dict[str, torch.Tensor]:
        """The stored params by name, whole (ZeRO mode: the fp32 master
        shards all-gathered, a collective; else :attr:`params`)."""
        if self.zero is None:
            return self.params
        from apex_tpu_torch.transformer.mappings import all_gather
        out = {}
        zs = self.opt_state
        for (_, idx), m in zip(self.zero_groups, zs.master):
            self._unflatten(idx, all_gather(m, self.zero_group, 0),
                            lambda i, v: out.__setitem__(self.names[i], v))
        for (_, idx), m in zip(self.local_groups, zs.local_master):
            self._unflatten(idx, m,
                            lambda i, v: out.__setitem__(self.names[i], v))
        return {n: out[n] for n in self.names}

    def _unflatten(self, idx, flat, put):
        """``put(i, view)`` for each parameter ``i`` of ``idx`` laid end
        to end in ``flat``."""
        off = 0
        for i in idx:
            p = self.module_params[i]
            put(i, flat[off:off + p.numel()].view(p.shape))
            off += p.numel()

    def load_jax_opt_state(self, count, exp_avg, exp_avg_sq
                           ) -> "MixedPrecisionTrainState":
        """Resume the optimizer from a JAX ``FusedAdamState`` (numpy
        leaves keyed by the port's parameter names; see
        :func:`apex_tpu_torch.optim.fused_adam.adam_state_from_jax`)."""
        self.opt_state = adam_state_from_jax(
            self.tx, count, exp_avg, exp_avg_sq, self.leaves(),
            [g.flat for g in self.groups])
        return self

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``with amp.scale_loss(loss, opt)``: the loss to differentiate."""
        return self.loss_scaler.scale(self.loss_scale_state, loss)

    @torch.no_grad()
    def apply_gradients(self, grads: Optional[List] = None) -> torch.Tensor:
        """Unscale → check → step-or-skip → adjust → copy back.

        ``grads``: gradients of the scaled loss for the module's
        parameters in ``model.named_parameters()`` order (default: their
        ``.grad``, which this call then clears).  A parameter with no
        gradient counts as a zero gradient.  Returns the device bool
        ``finite``; a non-finite step changes no parameter and no
        optimizer state and backs the scale off.
        """
        own = grads is None
        if own:
            grads = [p.grad for p in self.module_params]
        if self.zero is not None:
            finite = self._apply_gradients_zero(grads)
        else:
            finite = self._apply_gradients(grads)
        self.step += 1
        if own:
            for p in self.module_params:
                p.grad = None
        return finite

    def _apply_gradients(self, grads) -> torch.Tensor:
        flat_grads = []
        for g in self.groups:
            parts = [torch.zeros(self.module_params[i].numel(),
                                 dtype=g.dtype, device=g.flat.device)
                     if grads[i] is None else grads[i].reshape(-1)
                     for i in g.indices]
            # 1. upcast to the stored dtype (before unscaling, so small
            # fp16 grads are not flushed; inf/nan survive the cast)
            flat_grads.append(torch.cat(parts).to(g.dtype))
        ls, ls_state = self.loss_scaler, self.loss_scale_state
        ls.unscale_(ls_state, flat_grads)                   # 2
        finite = all_finite(flat_grads)
        self.tx.step(flat_grads, self.opt_state,            # 3-5
                     [g.flat for g in self.groups], finite)
        self.loss_scale_state = ls.adjust(ls_state, finite)  # 6
        if self.policy.master_weights:                      # 7
            for g in self.groups:
                for i, view in zip(g.indices, g.views):
                    self.module_params[i].copy_(view)
        return finite

    def _apply_gradients_zero(self, grads) -> torch.Tensor:
        """Reduce-scatter → unscale → one flag → shard update →
        all-gather into the module (the module docstring)."""
        from apex_tpu_torch.parallel import distributed_optim as zero_lib
        from apex_tpu_torch.transformer.mappings import all_gather

        z, zs = self.zero, self.opt_state
        flat = []
        for dt, idx in self.zero_groups:
            flat.append(torch.cat([
                torch.zeros(self.module_params[i].numel(), dtype=dt,
                            device=zs.master[0].device)
                if grads[i] is None else grads[i].reshape(-1)
                for i in idx]))
        # scaled gradients on the wire, fp32 shards out
        shards = [s.reshape(-1) for s in zero_lib.reduce_scatter_mean_grads(
            flat, self.zero_group, reduce_dtype=z.reduce_dtype,
            stage=z.stage)]
        del flat
        # the experts sharded over the axis: the owner's gradient is
        # the sum over the axis already; the mean divides it
        n = dist.get_world_size(self.zero_group)
        local = [torch.cat([
            torch.zeros(self.module_params[i].numel(),
                        device=zs.local_master[0].device)
            if grads[i] is None else grads[i].reshape(-1).float()
            for i in idx]) / n for _, idx in self.local_groups]
        ls, ls_state = self.loss_scaler, self.loss_scale_state
        ls.unscale_(ls_state, shards + local)
        # one decision for every shard: a non-finite value lands only in
        # the shard that owns it
        ok = all_finite(shards + local).to(torch.int32).reshape(1)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self.zero_group)
        finite = ok[0].bool()
        self.tx.step(shards, zs.inner, zs.master, finite)
        if local:
            self.tx.step(local, zs.local_inner, zs.local_master, finite)
        self.loss_scale_state = ls.adjust(ls_state, finite)
        params = self.module_params
        for (dt, idx), m in zip(self.zero_groups, zs.master):
            self._unflatten(idx, all_gather(m.to(dt), self.zero_group, 0),
                            lambda i, v: params[i].copy_(v))
        for (_, idx), m in zip(self.local_groups, zs.local_master):
            self._unflatten(idx, m, lambda i, v: params[i].copy_(v))
        return finite

    # ------------------------------------------------------------------ #
    def amp_state_dict(self) -> dict:
        return self.loss_scale_state.state_dict()

    def load_amp_state_dict(self, d: dict) -> "MixedPrecisionTrainState":
        self.loss_scale_state = LossScaleState.from_state_dict(
            d, device=self.step.device)
        return self
