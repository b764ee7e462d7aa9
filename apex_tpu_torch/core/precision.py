"""Mixed-precision policies (apex ``amp`` opt levels O0–O3).

Counterpart of ``apex_tpu/core/precision.py``: the knobs of apex's
``Properties`` on an immutable :class:`PrecisionPolicy` that is applied
to a ``state_dict`` (a mapping of dotted names to tensors) or to a
module's parameters.  ``bfloat16`` needs no loss scaling; ``float16``
gets dynamic loss scaling, as upstream.

======  ==================  ===================  ==============  =========
level   params kept as      compute dtype        master weights  loss scale
======  ==================  ===================  ==============  =========
O0      fp32                fp32                 n/a             1.0
O1      fp32                per-op (half lists)  n/a             dynamic
O2      half (norms fp32)   half                 fp32 masters    dynamic
O3      half                half                 none            1.0
======  ==================  ===================  ==============  =========
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import torch
import torch.nn as nn

__all__ = ["PrecisionPolicy", "norm_param_filter", "cast_floating"]

LossScaleSpec = Union[str, float, None]
_OPT_LEVELS = ("O0", "O1", "O2", "O3")


def norm_param_filter(name: str) -> bool:
    """Whether the parameter ``name`` (dotted) belongs to a
    batch/group/layer-norm layer — ``_default_bn_filter`` of the JAX
    package, applied to each dotted component: such leaves keep fp32
    under ``keep_batchnorm_fp32``."""
    for part in name.split("."):
        low = part.lower()
        if ("batchnorm" in low or "groupnorm" in low or "layernorm" in low
                or low.startswith("bn") or low == "norm" or "_norm" in low
                or "norm_" in low):
            return True
    return False


def cast_floating(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype`` if it is floating point, else ``t``."""
    if dtype is None or not torch.is_floating_point(t):
        return t
    return t.to(dtype)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Immutable mixed-precision configuration (apex ``Properties``)."""

    opt_level: str = "O0"
    #: dtype model params are stored in ("cast_model_type" upstream)
    param_dtype: Any = torch.float32
    #: dtype the products run in
    compute_dtype: Any = torch.float32
    #: dtype activations leave a policy-applied module in
    output_dtype: Any = torch.float32
    #: keep norm-layer params in fp32 even when params are half
    keep_batchnorm_fp32: bool = False
    #: hold an fp32 master copy of the params (O2)
    master_weights: bool = False
    #: "dynamic", a constant float, or None
    loss_scale: LossScaleSpec = None
    #: O1-style per-op casting
    per_op_casting: bool = False

    @classmethod
    def from_opt_level(cls, opt_level: str, *,
                       half_dtype: Any = torch.bfloat16,
                       **overrides: Any) -> "PrecisionPolicy":
        """Resolve an apex opt level; any field may be overridden by
        keyword, as ``amp.initialize(..., loss_scale=128.0)``."""
        if opt_level not in _OPT_LEVELS:
            raise ValueError(
                f"Unexpected optimization level {opt_level!r}. "
                f"Options are 'O0', 'O1', 'O2', 'O3'.")
        half = half_dtype
        dynamic = "dynamic" if half == torch.float16 else None
        f32 = torch.float32
        base = {
            "O0": dict(param_dtype=f32, compute_dtype=f32, output_dtype=f32,
                       keep_batchnorm_fp32=False, master_weights=False,
                       loss_scale=None, per_op_casting=False),
            "O1": dict(param_dtype=f32, compute_dtype=half,
                       output_dtype=f32, keep_batchnorm_fp32=True,
                       master_weights=False, loss_scale=dynamic,
                       per_op_casting=True),
            "O2": dict(param_dtype=half, compute_dtype=half,
                       output_dtype=half, keep_batchnorm_fp32=True,
                       master_weights=True, loss_scale=dynamic,
                       per_op_casting=False),
            "O3": dict(param_dtype=half, compute_dtype=half,
                       output_dtype=half, keep_batchnorm_fp32=False,
                       master_weights=False, loss_scale=None,
                       per_op_casting=False),
        }[opt_level]
        base.update(overrides)
        return cls(opt_level=opt_level, **base)

    @classmethod
    def O0(cls, **kw: Any) -> "PrecisionPolicy":
        return cls.from_opt_level("O0", **kw)

    @classmethod
    def O1(cls, **kw: Any) -> "PrecisionPolicy":
        return cls.from_opt_level("O1", **kw)

    @classmethod
    def O2(cls, **kw: Any) -> "PrecisionPolicy":
        return cls.from_opt_level("O2", **kw)

    @classmethod
    def O3(cls, **kw: Any) -> "PrecisionPolicy":
        return cls.from_opt_level("O3", **kw)

    # ------------------------------------------------------------------ #
    def dtype_for(self, name: str, dtype) -> Any:
        """The dtype parameter ``name`` is cast to from ``dtype``: fp32
        for a norm parameter under ``keep_batchnorm_fp32``."""
        if self.keep_batchnorm_fp32 and norm_param_filter(name):
            return torch.float32
        return dtype

    def _cast(self, target, dtype):
        if isinstance(target, nn.Module):
            with torch.no_grad():
                for name, p in target.named_parameters():
                    if torch.is_floating_point(p):
                        p.data = p.data.to(self.dtype_for(name, dtype))
            return target
        return {name: cast_floating(t, self.dtype_for(name, dtype))
                for name, t in _items(target)}

    def cast_to_param(self, target):
        """A ``state_dict`` (new dict) or a module (in place, returned)
        cast to the storage dtype, norm params fp32 per the filter."""
        return self._cast(target, self.param_dtype)

    def cast_to_compute(self, target):
        """The same cast to the compute dtype (the forward's copy)."""
        return self._cast(target, self.compute_dtype)

    def master_params(self, target):
        """fp32 copy of a ``state_dict`` or of a module's parameters
        (``amp.master_params`` upstream), as a new dict."""
        return {name: cast_floating(t.detach(), torch.float32).clone()
                for name, t in _items(target)}

    @property
    def needs_loss_scaling(self) -> bool:
        if self.loss_scale is None:
            return False
        if self.loss_scale == "dynamic":
            return True
        return float(self.loss_scale) != 1.0

    def make_loss_scale(self):
        """The matching loss-scale manager (``core.loss_scale``)."""
        from apex_tpu_torch.core import loss_scale as ls

        if self.loss_scale is None:
            return ls.NoOpLossScale()
        if self.loss_scale == "dynamic":
            return ls.DynamicLossScale()
        return ls.StaticLossScale(scale=float(self.loss_scale))


def _items(target):
    if isinstance(target, nn.Module):
        return list(target.named_parameters())
    if isinstance(target, Mapping):
        return list(target.items())
    raise TypeError(f"expected a state_dict or a module, got "
                    f"{type(target).__name__}")
