"""FusedSGD — momentum SGD over lists of tensors, updated in place.

Counterpart of ``apex_tpu/optim/fused_sgd.py`` (``:27-80``) in the
interface of :mod:`apex_tpu_torch.optim.fused_adam`: ``init(params)``
and ``step(grads, state, params, finite)``.  Torch/apex SGD semantics:
weight decay is folded into the gradient first, ``buf = momentum · buf +
(1 - dampening) · g`` with the first step setting ``buf = g``, optional
Nesterov.  The JAX package computes this in XLA; here it is plain
PyTorch over whatever tensors it is given — the train state hands it one
flat buffer of fp32 masters, so each line is one launch over every
parameter (apex's multi-tensor apply).  With a device-side ``finite``
flag a non-finite step leaves params, buffers and count as they were,
without a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch

from apex_tpu_torch.optim._multi_tensor import commit_

__all__ = ["fused_sgd", "FusedSGD", "FusedSgdState"]


@dataclasses.dataclass
class FusedSgdState:
    count: torch.Tensor          # step count, int32 scalar
    momentum_buf: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params: List[torch.Tensor]) -> FusedSgdState:
        """Zero momentum buffers beside ``params`` and a zero count."""
        device = params[0].device if params else None
        return FusedSgdState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            momentum_buf=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedSgdState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One SGD step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step changes nothing."""
        count = state.count + 1
        lr = self.learning_rate
        if callable(lr):
            lr = lr(count)
        first = state.count == 0
        mom, wd = self.momentum, self.weight_decay
        for g, p, buf in zip(grads, params, state.momentum_buf):
            gf = g.float()
            if wd != 0.0:
                gf = gf + wd * p.float()
            if mom != 0.0:
                # torch semantics: the first step sets buf = g (undamped)
                buf_new = torch.where(first, gf, mom * buf.float()
                                      + (1.0 - self.dampening) * gf)
                d = gf + mom * buf_new if self.nesterov else buf_new
            else:
                buf_new = buf
                d = gf
            commit_(((p, p + (-lr * d).to(p.dtype)), (buf, buf_new)),
                    finite)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_sgd(learning_rate: Union[float, Callable] = 1e-3,
              momentum: float = 0.0, dampening: float = 0.0,
              weight_decay: float = 0.0, nesterov: bool = False) -> FusedSGD:
    """Build the FusedSGD optimizer (the JAX package's signature)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening")
    return FusedSGD(learning_rate, momentum, dampening, weight_decay,
                    nesterov)
