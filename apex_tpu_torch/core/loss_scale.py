"""Static and dynamic loss scaling (apex ``amp/scaler.py``).

Counterpart of ``apex_tpu/core/loss_scale.py``.  The scale, the
growth tracker and the overflow decision stay on the device as tensors
chosen with ``torch.where``: a step never waits for the host.  Where
the JAX package counts growth and backoff events through a host
callback, the port keeps device-side tallies in the state
(:attr:`LossScaleState.events`), which :mod:`apex_tpu_torch.utils.
metrics` reads when asked.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Mapping, Optional

import torch

__all__ = ["LossScaleState", "DynamicLossScale", "StaticLossScale",
           "NoOpLossScale", "all_finite"]


@dataclasses.dataclass
class LossScaleState:
    """Device-resident scaler state.

    ``loss_scale``: fp32 scalar; ``growth_tracker``: int32 scalar,
    consecutive overflow-free steps (apex's ``unskipped``); ``events``:
    int64 ``(2,)`` tallies of scale growths and backoffs (skipped
    steps) since the state was made.
    """

    loss_scale: torch.Tensor
    growth_tracker: torch.Tensor
    events: torch.Tensor

    def state_dict(self) -> dict:
        """Serializable form (``amp.state_dict()``); reads the device."""
        return {"loss_scale": float(self.loss_scale.item()),
                "unskipped": int(self.growth_tracker.item())}

    @classmethod
    def from_state_dict(cls, d: dict, device=None) -> "LossScaleState":
        return cls(
            loss_scale=torch.tensor(float(d["loss_scale"]),
                                    dtype=torch.float32, device=device),
            growth_tracker=torch.tensor(int(d["unskipped"]),
                                        dtype=torch.int32, device=device),
            events=torch.zeros(2, dtype=torch.int64, device=device))


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Device-side bool: every floating tensor is free of inf and NaN
    (apex's fused overflow check); no host sync."""
    flags = [torch.isfinite(t).all() for t in tensors
             if torch.is_floating_point(t)]
    if not flags:
        return torch.tensor(True)
    if len(flags) == 1:
        return flags[0]
    return torch.stack(flags).all()


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """Dynamic loss scaling (apex defaults: 2**16, x2 / x0.5, 2000)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    max_scale: float = 2.0 ** 24
    min_scale: float = 1.0

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            loss_scale=torch.tensor(self.init_scale, dtype=torch.float32,
                                    device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32,
                                        device=device),
            events=torch.zeros(2, dtype=torch.int64, device=device))

    def scale(self, state: LossScaleState, loss: torch.Tensor):
        """The loss upcast to fp32, times the scale."""
        return loss.float() * state.loss_scale

    def unscale_(self, state: LossScaleState,
                 grads: List[torch.Tensor]) -> None:
        """Multiply ``grads`` by ``1 / scale`` in place."""
        inv = 1.0 / state.loss_scale
        for g in grads:
            g.mul_(inv)

    def adjust(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        """Backoff on overflow, growth after ``growth_interval`` clean
        steps (apex's state machine), all on the device."""
        tracker = torch.where(grads_finite, state.growth_tracker + 1,
                              torch.zeros_like(state.growth_tracker))
        grow = tracker >= self.growth_interval
        grown = torch.clamp(state.loss_scale * self.growth_factor,
                            max=self.max_scale)
        backed = torch.clamp(state.loss_scale * self.backoff_factor,
                             min=self.min_scale)
        new_scale = torch.where(
            grads_finite, torch.where(grow, grown, state.loss_scale), backed)
        # tallies: growth only when the scale moved (a max_scale pin is
        # no event); backoff on every skipped step, as in the JAX package
        grew = grads_finite & grow & (new_scale != state.loss_scale)
        events = state.events + torch.stack(
            [grew, ~grads_finite]).to(torch.int64)
        tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
        return LossScaleState(loss_scale=new_scale.float(),
                              growth_tracker=tracker.to(torch.int32),
                              events=events)


    def select_step(self, grads_finite: torch.Tensor, new_tree, old_tree):
        """``where(finite, new, old)`` over matching nested containers of
        tensors: apex's "skip optimizer.step() on overflow" without a
        host sync."""
        if isinstance(new_tree, Mapping):
            return {k: self.select_step(grads_finite, v, old_tree[k])
                    for k, v in new_tree.items()}
        if isinstance(new_tree, (list, tuple)):
            out = [self.select_step(grads_finite, n, o)
                   for n, o in zip(new_tree, old_tree)]
            return out if isinstance(new_tree, list) else tuple(out)
        return torch.where(grads_finite, new_tree, old_tree)

    def backoff_exhausted(self, state: LossScaleState) -> torch.Tensor:
        """Device-side flag: the scale is pinned at ``min_scale``, so
        further non-finite steps are the model's or the data's, not a
        loss-scaling artifact."""
        return state.loss_scale <= torch.tensor(
            self.min_scale, dtype=torch.float32,
            device=state.loss_scale.device)


class StaticLossScale(DynamicLossScale):
    """Constant loss scale (``amp.initialize(..., loss_scale=128.0)``)."""

    def __init__(self, scale: float = 1.0, **fields):
        defaults = dict(
            init_scale=float(scale), growth_factor=1.0,
            backoff_factor=1.0, growth_interval=2 ** 31 - 1,
            max_scale=float(scale), min_scale=float(scale))
        defaults.update(fields)
        super().__init__(**defaults)

    def adjust(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        return state


class NoOpLossScale(StaticLossScale):
    """Identity loss scale for O0/O3 and bf16 policies."""

    def __init__(self, scale: Optional[float] = 1.0, **fields):
        del scale
        for pinned in ("init_scale", "max_scale", "min_scale"):
            fields.pop(pinned, None)
        super().__init__(scale=1.0, **fields)

    def scale(self, state: LossScaleState, loss: torch.Tensor):
        return loss

    def unscale_(self, state: LossScaleState,
                 grads: List[torch.Tensor]) -> None:
        return None
