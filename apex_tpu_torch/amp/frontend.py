"""``amp.initialize`` / ``amp.scale_loss`` parity layer.

Counterpart of ``apex_tpu/amp/frontend.py`` (``frontend.py:25-114``):
the opt level and its override knobs resolve to a
:class:`~apex_tpu_torch.core.precision.PrecisionPolicy`, and everything
lives in the returned :class:`~apex_tpu_torch.core.train_state.
MixedPrecisionTrainState` — no global amp state.
"""

from __future__ import annotations

from typing import Any, List

import torch.nn as nn

from apex_tpu_torch.core.precision import PrecisionPolicy
from apex_tpu_torch.core.train_state import MixedPrecisionTrainState

__all__ = ["initialize", "scale_loss", "master_params", "state_dict",
           "load_state_dict"]

_UNSET = "__unset__"


def initialize(model, optimizer, opt_level: str = "O1", *,
               half_dtype: Any = None, loss_scale: Any = _UNSET,
               keep_batchnorm_fp32: Any = _UNSET,
               master_weights: Any = _UNSET, zero: Any = None,
               **policy_overrides: Any):
    """Build a mixed-precision train state from an opt level.

    ``model``: the ``nn.Module`` to train (O2 / O3 cast its parameters
    in place; O1, the default, keeps them fp32 and casts a compute copy
    as each module is called — run the forward under
    :func:`~apex_tpu_torch.amp.o1.o1_intercept` for per-op casting of a
    model built with ``dtype=None``); ``optimizer``: an optimizer of
    :mod:`apex_tpu_torch.optim` (``init`` / ``step``).  The list form
    ``initialize([m1, m2], [o1, o2])`` returns one independently scaled
    state per pair.  ``zero``: a
    :class:`~apex_tpu_torch.parallel.distributed_optim.ZeroConfig` for
    ZeRO-1/2 (the fp32 masters and the optimizer state sharded over its
    mesh axis's group; needs a mesh), handed to
    :meth:`~apex_tpu_torch.core.train_state.MixedPrecisionTrainState.
    create`.
    """
    if type(optimizer) in (list, tuple):
        models = model if type(model) in (list, tuple) else None
        if models is None or len(models) != len(optimizer):
            raise ValueError(
                f"list-form initialize needs a model list of matching "
                f"length, got {type(model).__name__} and "
                f"{len(optimizer)} optimizers")
        return [initialize(m, o, opt_level, half_dtype=half_dtype,
                           loss_scale=loss_scale,
                           keep_batchnorm_fp32=keep_batchnorm_fp32,
                           master_weights=master_weights, zero=zero,
                           **policy_overrides)
                for m, o in zip(models, optimizer)]
    if not isinstance(model, nn.Module):
        raise TypeError(f"model must be an nn.Module, got "
                        f"{type(model).__name__}")
    overrides = dict(policy_overrides)
    if loss_scale != _UNSET:
        overrides["loss_scale"] = loss_scale
    if keep_batchnorm_fp32 != _UNSET:
        overrides["keep_batchnorm_fp32"] = keep_batchnorm_fp32
    if master_weights != _UNSET:
        overrides["master_weights"] = master_weights
    kw = {"half_dtype": half_dtype} if half_dtype is not None else {}
    policy = PrecisionPolicy.from_opt_level(opt_level, **kw, **overrides)
    return MixedPrecisionTrainState.create(
        model=model, optimizer=optimizer, policy=policy, zero=zero)


def scale_loss(loss, state: MixedPrecisionTrainState):
    """The loss to differentiate (``with amp.scale_loss(loss, opt)``);
    :meth:`~MixedPrecisionTrainState.apply_gradients` unscales."""
    return state.scale_loss(loss)


def master_params(state: MixedPrecisionTrainState) -> List:
    """The fp32 master parameters (``amp.master_params(optimizer)``)."""
    return [t for t in state.policy.master_params(state.params).values()]


def state_dict(state: MixedPrecisionTrainState) -> dict:
    """Loss-scaler persistence (``amp.state_dict()``)."""
    return state.amp_state_dict()


def load_state_dict(state: MixedPrecisionTrainState,
                    d: dict) -> MixedPrecisionTrainState:
    """``amp.load_state_dict()``; returns the updated state."""
    return state.load_amp_state_dict(d)
