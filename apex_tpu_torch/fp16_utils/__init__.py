"""apex_tpu_torch.fp16_utils — the legacy manual-fp16 API.

Counterpart of ``apex_tpu/fp16_utils`` (reference ``apex/fp16_utils/
{fp16_optimizer,fp16util,loss_scaler}.py``): the pre-amp workflow — cast
the network to half by hand, keep fp32 master weights inside
:class:`FP16_Optimizer`, scale the loss, copy the model's gradients to
the masters, step on the masters, copy back.  The casts take trees of
tensors (dicts, lists and tuples, as the JAX package's pytrees; a
``state_dict`` is one) and return new trees; :func:`network_to_half` and
:func:`BN_convert_float` also take an ``nn.Module``, cast in place.
:class:`FP16_Optimizer` wraps a port optimizer and updates the masters,
its state and the model's parameters in place, with the JAX class's
``init`` / ``step`` / ``state_dict`` / ``load_state_dict``.  Norm
parameters are told by name, as amp's ``keep_batchnorm_fp32`` tells them
(:func:`~apex_tpu_torch.core.precision.norm_param_filter`).  All of it
is subsumed by :mod:`apex_tpu_torch.amp`; kept for code written against
``fp16_utils``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from apex_tpu_torch.core.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    NoOpLossScale,
    StaticLossScale,
    all_finite,
)
from apex_tpu_torch.core.precision import (
    norm_param_filter,
    tree_cast,
    tree_leaves,
    tree_map,
)

__all__ = [
    "network_to_half", "BN_convert_float",
    "master_params_to_model_params", "model_grads_to_master_grads",
    "prep_param_lists", "FP16_Optimizer", "FP16OptimizerState",
    "LossScaler", "DynamicLossScaler",
]


def _is_norm(path: tuple, leaf: Any = None) -> bool:
    """Whether a leaf at ``path`` (keys from the root) is a norm
    parameter: the JAX package's ``_default_bn_filter`` on each key."""
    return norm_param_filter(".".join(str(k) for k in path))


def _cast_module(model: nn.Module, dtype, keep_norms: bool) -> nn.Module:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not torch.is_floating_point(p):
                continue
            norm = norm_param_filter(name)
            if keep_norms and norm:
                p.data = p.data.float()
            elif dtype is not None and not norm:
                p.data = p.data.to(dtype)
    return model


def network_to_half(params: Any, *, half_dtype=torch.float16) -> Any:
    """Floating leaves cast to half, norm-layer leaves kept fp32
    (``fp16util.network_to_half``, whose BN wrapper keeps BatchNorm in
    fp32).  A module is cast in place and returned."""
    if isinstance(params, nn.Module):
        return _cast_module(params, half_dtype, True)
    return tree_cast(params, half_dtype, keep_fp32_filter=_is_norm)


def BN_convert_float(params: Any) -> Any:
    """Norm-layer leaves cast back to fp32 (``fp16util.
    BN_convert_float``); a module in place."""
    if isinstance(params, nn.Module):
        return _cast_module(params, None, True)

    def cast(path, tree):
        if isinstance(tree, dict):
            return {k: cast(path + (k,), v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [cast(path + (i,), v) for i, v in enumerate(tree)]
            return out if isinstance(tree, list) else tuple(out)
        if (isinstance(tree, torch.Tensor) and torch.is_floating_point(tree)
                and _is_norm(path)):
            return tree.float()
        return tree

    return cast((), params)


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if torch.is_floating_point(t) else t


def prep_param_lists(params: Any) -> Tuple[Any, Any]:
    """``(model_params, fp32 master copies)`` (``fp16util.
    prep_param_lists``): the masters are new tensors."""
    return params, tree_map(lambda t: _fp32(t.detach()).clone(), params)


def master_params_to_model_params(model_params: Any,
                                  master_params: Any) -> Any:
    """The fp32 masters rounded into the model parameters' dtypes."""
    return tree_map(lambda p, m: m.to(p.dtype), model_params, master_params)


def model_grads_to_master_grads(model_grads: Any) -> Any:
    """Half model gradients upcast to fp32 master gradients."""
    return tree_map(_fp32, model_grads)


# --------------------------------------------------------------------- #
# legacy loss scalers (the fp16_utils constructors' arguments)
# --------------------------------------------------------------------- #
def LossScaler(scale: float = 1.0) -> StaticLossScale:
    """Static scaler (``fp16_utils.LossScaler``)."""
    return StaticLossScale(scale=scale)


def DynamicLossScaler(init_scale: float = 2.0 ** 32,
                      scale_factor: float = 2.0,
                      scale_window: int = 1000) -> DynamicLossScale:
    """Dynamic scaler with the legacy module's defaults and names."""
    return DynamicLossScale(init_scale=init_scale,
                            growth_factor=scale_factor,
                            backoff_factor=1.0 / scale_factor,
                            growth_interval=scale_window)


@dataclasses.dataclass
class FP16OptimizerState:
    master_params: Any           # fp32 masters, in the params' tree
    opt_state: Any               # the wrapped optimizer's, over them
    loss_scale_state: LossScaleState


class FP16_Optimizer:
    """Master-weight wrapper (``fp16_utils.FP16_Optimizer``) around a
    port optimizer.

    ``state = opt.init(model_params)``; ``state, model_params, finite =
    opt.step(state, model_params, model_grads)``.  The step upcasts the
    gradients to fp32, unscales them, checks finiteness, steps the
    optimizer on the masters (a non-finite step changes nothing and backs
    the scale off), rounds the masters into the model parameters and
    adjusts the scale — in place, with no host sync; it returns the same
    objects, so code written against the JAX class's ``new_state,
    new_model, finite = opt.step(...)`` runs unchanged.
    """

    def __init__(self, optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None):
        self.optimizer = optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(
                **(dynamic_loss_args or {}))
        elif static_loss_scale == 1.0:
            self.loss_scaler = NoOpLossScale()
        else:
            self.loss_scaler = LossScaler(static_loss_scale)

    def init(self, model_params: Any) -> FP16OptimizerState:
        _, masters = prep_param_lists(model_params)
        flat = tree_leaves(masters)
        return FP16OptimizerState(
            master_params=masters,
            opt_state=self.optimizer.init(flat),
            loss_scale_state=self.loss_scaler.init(
                flat[0].device if flat else None))

    def scale_loss(self, state: FP16OptimizerState, loss):
        """``optimizer.backward(loss)``'s scaling half: the loss to
        differentiate."""
        return self.loss_scaler.scale(state.loss_scale_state, loss)

    @torch.no_grad()
    def step(self, state: FP16OptimizerState, model_params: Any,
             model_grads: Any):
        ls, ls_state = self.loss_scaler, state.loss_scale_state
        grads = [g.float().clone() for g in tree_leaves(model_grads)]
        ls.unscale_(ls_state, grads)
        finite = all_finite(grads)
        masters = tree_leaves(state.master_params)
        self.optimizer.step(grads, state.opt_state, masters, finite)
        for p, m in zip(tree_leaves(model_params), masters):
            p.copy_(m.to(p.dtype))
        state.loss_scale_state = ls.adjust(ls_state, finite)
        return state, model_params, finite

    # persistence parity (fp16_optimizer's state_dict keeps the scaler's)
    def state_dict(self, state: FP16OptimizerState) -> dict:
        return {
            "loss_scaler": state.loss_scale_state.state_dict(),
            "master_params": state.master_params,
            "opt_state": state.opt_state,
        }

    def load_state_dict(self, d: dict) -> FP16OptimizerState:
        masters = d["master_params"]
        flat = tree_leaves(masters)
        return FP16OptimizerState(
            master_params=masters,
            opt_state=d["opt_state"],
            loss_scale_state=LossScaleState.from_state_dict(
                d["loss_scaler"], device=flat[0].device if flat else None))
