"""Mixed-precision train state — policy, loss scaler and optimizer.

Counterpart of ``apex_tpu/core/train_state.py`` in torch idiom.  It
holds

- the module the forward runs, its parameters cast by the policy (bf16
  with fp32 norm parameters under O2);
- the stored parameters the optimizer updates: fp32 masters under O2
  (apex's master weights), else the module's own parameters;
- the optimizer state and the loss-scale state, on the device.

The stored parameters live in one flat buffer per dtype (the module's
parameters are views into it when there are no masters), so unscaling,
the overflow check and the optimizer update each run once over every
parameter, as apex's multi-tensor kernels do.

:meth:`apply_gradients` follows the JAX order: upcast the grads to the
stored dtype, unscale, check finiteness, update, keep the old values on
a non-finite step, adjust the scale, copy the masters back into the
module.  Nothing in it reads the device from the host: the returned
``finite`` flag is a device tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from apex_tpu_torch.core.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    all_finite,
)
from apex_tpu_torch.core.precision import PrecisionPolicy

__all__ = ["MixedPrecisionTrainState"]


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


class MixedPrecisionTrainState:
    """Train state over ``model`` (see the module docstring); build it
    with :meth:`create` or ``amp.initialize``."""

    def __init__(self, model: nn.Module, optimizer, policy: PrecisionPolicy,
                 loss_scaler: DynamicLossScale):
        self.model = model
        self.tx = optimizer
        self.policy = policy
        self.loss_scaler = loss_scaler
        named = [(n, p) for n, p in model.named_parameters()
                 if torch.is_floating_point(p)]
        self.names = [n for n, _ in named]
        self.module_params = [p for _, p in named]
        device = self.module_params[0].device
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
        policy.cast_to_compute(model)
        if not policy.master_weights:
            # the module trains its stored params directly: make them
            # views of the flat buffers
            for g in self.groups:
                for i, view in zip(g.indices, g.views):
                    self.module_params[i].data = view
        self.opt_state = optimizer.init([g.flat for g in self.groups])
        self.loss_scale_state: LossScaleState = loss_scaler.init(device)
        self.step = torch.zeros((), dtype=torch.int32, device=device)

    @classmethod
    def create(cls, *, model: nn.Module, optimizer,
               policy: Optional[PrecisionPolicy] = None,
               loss_scaler: Optional[DynamicLossScale] = None,
               zero=None) -> "MixedPrecisionTrainState":
        if zero is not None:
            raise NotImplementedError(
                "ZeRO-sharded optimizer state comes with ROADMAP.md A-5")
        policy = policy or PrecisionPolicy.O0()
        if policy.per_op_casting:
            raise NotImplementedError(
                "O1 per-op casting comes with ROADMAP.md A-6")
        return cls(model, optimizer, policy,
                   loss_scaler or policy.make_loss_scale())

    # ------------------------------------------------------------------ #
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The stored params by name (fp32 masters under O2)."""
        out = {}
        for g in self.groups:
            for i, view in zip(g.indices, g.views):
                out[self.names[i]] = view
        return out

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
        self.step += 1
        if own:
            for p in self.module_params:
                p.grad = None
        return finite

    # ------------------------------------------------------------------ #
    def amp_state_dict(self) -> dict:
        return self.loss_scale_state.state_dict()

    def load_amp_state_dict(self, d: dict) -> "MixedPrecisionTrainState":
        self.loss_scale_state = LossScaleState.from_state_dict(
            d, device=self.step.device)
        return self
