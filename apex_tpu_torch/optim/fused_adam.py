"""FusedAdam — Adam / AdamW over lists of tensors, updated in place.

Counterpart of ``apex_tpu/optim/fused_adam.py`` with dense moments
(``fused_adam.py:216-321``).  The JAX package computes this update in
XLA; here it is plain PyTorch over whatever tensors it is given — the
train state hands it one flat buffer of fp32 masters, so each line below
is one launch over every parameter at once (apex's multi-tensor apply).

- ``adam_w_mode=True`` (default): decoupled weight decay (AdamW);
  ``False``: L2 regularisation added to the gradient.
- ``bias_correction`` on by default; one shared step count.
- ``moment_dtype`` stores the moments in another dtype (default: the
  params').
- :meth:`FusedAdam.step` updates params and moments in place; with a
  device-side ``finite`` flag it keeps the old values on a non-finite
  step (step-or-skip) without a host sync.

``moment_format="fp8_block_scaled"`` (the Pallas ``_fp8_adam_kernel``)
comes with ROADMAP.md A-6.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch

__all__ = ["fused_adam", "FusedAdam", "FusedAdamState"]


@dataclasses.dataclass
class FusedAdamState:
    count: torch.Tensor          # shared step count, int32 scalar
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    moment_dtype: Optional[Any] = None

    def init(self, params: List[torch.Tensor]) -> FusedAdamState:
        """Zero moments beside ``params`` and a zero step count."""
        def zeros(p):
            return torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
        device = params[0].device if params else None
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg=[zeros(p) for p in params],
            exp_avg_sq=[zeros(p) for p in params])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedAdamState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One Adam step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step leaves every
        tensor as it was (the select of the JAX train state)."""
        count = state.count + 1
        lr = self.learning_rate
        if callable(lr):
            lr = lr(count)
        c = count.float()
        if self.bias_correction:
            bc1 = 1.0 - torch.pow(self.b1, c)
            bc2 = 1.0 - torch.pow(self.b2, c)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=c.device)
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        for g, p, m, v in zip(grads, params, state.exp_avg,
                              state.exp_avg_sq):
            gf = g.to(m.dtype)
            pf = p.to(m.dtype)
            if not self.adam_w_mode and wd != 0.0:
                gf = gf + wd * pf
            m_new = b1 * m + (1.0 - b1) * gf
            v_new = b2 * v + (1.0 - b2) * gf.square()
            upd = m_new / (bc1 * ((v_new / bc2).sqrt() + self.eps))
            if self.adam_w_mode and wd != 0.0:
                upd = upd + wd * pf
            p_new = p + (-lr * upd).to(p.dtype)
            for old, new in ((p, p_new), (m, m_new), (v, v_new)):
                if finite is None:
                    old.copy_(new)
                else:
                    torch.where(finite, new.to(old.dtype), old, out=old)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_adam(learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True,
               moment_dtype: Optional[Any] = None,
               moment_format: str = "dense") -> FusedAdam:
    """Build the FusedAdam optimizer (the JAX package's signature)."""
    if moment_format == "fp8_block_scaled":
        raise NotImplementedError(
            "moment_format='fp8_block_scaled' (the fp8 Adam kernel) comes "
            "with ROADMAP.md A-6")
    if moment_format != "dense":
        raise ValueError(
            f"moment_format={moment_format!r} not in "
            "('dense', 'fp8_block_scaled')")
    return FusedAdam(learning_rate, b1, b2, eps, weight_decay, adam_w_mode,
                     bias_correction, moment_dtype)
