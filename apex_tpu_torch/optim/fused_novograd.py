"""FusedNovoGrad — NovoGrad with one second moment per parameter tensor.

Counterpart of ``apex_tpu/optim/fused_novograd.py`` (reference
``apex/optimizers/fused_novograd.py`` + ``multi_tensor_novograd_kernel``)
in the interface of :mod:`apex_tpu_torch.optim.fused_adam`::

    v_t = b2 · v_{t-1} + (1 - b2) · ||g_t||²      (a scalar a tensor)
    m_t = b1 · m_{t-1} + c · (g_t / (√(v_t / bc2) + eps) + wd · p)
    p  -= lr · m_t / bc1

with ``v = ||g||²`` on the first step, ``c = 1 - b1`` under
``grad_averaging`` (else 1) and the bias corrections ``bc`` ones unless
``bias_correction``.  The JAX package computes it in XLA; here it is
plain PyTorch over the train state's flat buffers: the per-tensor norms
come from one multi-tensor norm over views of the buffer, so the
optimizer is ``per_leaf`` (the train state hands :meth:`FusedNovoGrad.
init` each buffer's parameters).  With a device-side ``finite`` flag a
non-finite step changes nothing, without a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch

from apex_tpu_torch.optim._multi_tensor import (
    Segments,
    commit_,
    segments_of,
    step_scalars,
)

__all__ = ["fused_novograd", "FusedNovoGrad", "FusedNovoGradState"]


@dataclasses.dataclass
class FusedNovoGradState:
    count: torch.Tensor          # step count, int32 scalar
    exp_avg: List[torch.Tensor]  # per element, beside each buffer
    exp_avg_sq: List[torch.Tensor]   # fp32, one a parameter tensor
    segments: List[Segments]


@dataclasses.dataclass(frozen=True)
class FusedNovoGrad:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    b1: float = 0.95
    b2: float = 0.98
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_averaging: bool = False
    bias_correction: bool = False

    per_leaf = True

    def init(self, params: List[torch.Tensor],
             leaves: Optional[List] = None) -> FusedNovoGradState:
        """Zero moments: the first beside ``params`` in their dtype, the
        second one fp32 scalar a parameter (``leaves[i]``: buffer ``i``'s
        parameters; default one a buffer)."""
        device = params[0].device if params else None
        segs = segments_of(params, leaves)
        return FusedNovoGradState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg=[torch.zeros_like(p) for p in params],
            exp_avg_sq=[torch.zeros(len(s.sizes), dtype=torch.float32,
                                    device=p.device)
                        for p, s in zip(params, segs)],
            segments=segs)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedNovoGradState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One NovoGrad step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step changes nothing."""
        count = state.count + 1
        lr, bc1, bc2 = step_scalars(self.learning_rate, count, self.b1,
                                    self.b2, self.bias_correction)
        first = state.count == 0
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        coef = (1.0 - b1) if self.grad_averaging else 1.0
        for g, p, m, v, seg in zip(grads, params, state.exp_avg,
                                   state.exp_avg_sq, state.segments):
            gf, pf = g.float(), p.float()
            gnorm_sq = seg.norms(gf).square()
            v_new = torch.where(first, gnorm_sq,
                                b2 * v + (1.0 - b2) * gnorm_sq)
            denom = (v_new / bc2).sqrt() + self.eps
            term = coef * (gf / seg.expand(denom))
            if wd != 0.0:
                term = term + coef * wd * pf
            m_new = b1 * m.float() + term
            upd = -lr * m_new / bc1
            commit_(((p, p + upd.to(p.dtype)), (m, m_new), (v, v_new)),
                    finite)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_novograd(learning_rate: Union[float, Callable] = 1e-3,
                   b1: float = 0.95, b2: float = 0.98, eps: float = 1e-8,
                   weight_decay: float = 0.0, grad_averaging: bool = False,
                   bias_correction: bool = False) -> FusedNovoGrad:
    """Build the FusedNovoGrad optimizer (the JAX package's signature)."""
    return FusedNovoGrad(learning_rate, b1, b2, eps, weight_decay,
                         grad_averaging, bias_correction)
