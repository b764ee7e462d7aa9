"""FusedAdagrad — ``h += g²; p -= lr · g / (√h + eps)``, with L2 weight
decay folded into the gradient.

Counterpart of ``apex_tpu/optim/fused_adagrad.py`` (reference
``apex/optimizers/fused_adagrad.py`` + ``multi_tensor_adagrad_kernel``)
in the interface of :mod:`apex_tpu_torch.optim.fused_adam`.  The JAX
package computes it in XLA; here it is plain PyTorch over the train
state's flat buffers, each line one launch over every parameter.  With a
device-side ``finite`` flag a non-finite step changes nothing, without a
host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch

from apex_tpu_torch.optim._multi_tensor import commit_

__all__ = ["fused_adagrad", "FusedAdagrad", "FusedAdagradState"]


@dataclasses.dataclass
class FusedAdagradState:
    count: torch.Tensor          # step count, int32 scalar
    sum_sq: List[torch.Tensor]   # fp32, beside each buffer


@dataclasses.dataclass(frozen=True)
class FusedAdagrad:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-2
    eps: float = 1e-10
    weight_decay: float = 0.0
    initial_accumulator_value: float = 0.0

    def init(self, params: List[torch.Tensor]) -> FusedAdagradState:
        """fp32 accumulators at ``initial_accumulator_value``."""
        device = params[0].device if params else None
        return FusedAdagradState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            sum_sq=[torch.full_like(p, self.initial_accumulator_value,
                                    dtype=torch.float32) for p in params])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedAdagradState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One Adagrad step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step changes nothing."""
        count = state.count + 1
        lr = self.learning_rate
        if callable(lr):
            lr = lr(count)
        for g, p, h in zip(grads, params, state.sum_sq):
            gf = g.float()
            if self.weight_decay != 0.0:
                gf = gf + self.weight_decay * p.float()
            h_new = h + gf.square()
            upd = -lr * gf / (h_new.sqrt() + self.eps)
            commit_(((p, p + upd.to(p.dtype)), (h, h_new)), finite)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_adagrad(learning_rate: Union[float, Callable] = 1e-2,
                  eps: float = 1e-10, weight_decay: float = 0.0,
                  initial_accumulator_value: float = 0.0) -> FusedAdagrad:
    """Build the FusedAdagrad optimizer (the JAX package's signature)."""
    return FusedAdagrad(learning_rate, eps, weight_decay,
                        initial_accumulator_value)
