"""LAMB with fp32 master state for half-precision model parameters.

Counterpart of ``apex_tpu/optim/fused_mixed_precision_lamb.py``
(reference ``apex/optimizers/fused_mixed_precision_lamb.py``): the
moments and a master copy of the parameters live in fp32 while the model
runs bf16 / fp16; each step updates the masters by
:class:`~apex_tpu_torch.optim.fused_lamb.FusedLAMB` and writes them back
rounded into the model parameters.  As the JAX package does, the model
parameter becomes ``p + (master - p)``, added in fp32 and rounded once to
its dtype.  Interface of :mod:`apex_tpu_torch.optim.fused_adam`; with a
device-side ``finite`` flag a non-finite step changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from apex_tpu_torch.optim._multi_tensor import commit_
from apex_tpu_torch.optim.fused_lamb import FusedLAMB, FusedLambState

__all__ = ["fused_mixed_precision_lamb", "FusedMixedPrecisionLamb",
           "FusedMixedPrecisionLambState"]


@dataclasses.dataclass
class FusedMixedPrecisionLambState:
    master_params: List[torch.Tensor]    # fp32 copies of the params
    inner: FusedLambState                # LAMB's state over the masters


@dataclasses.dataclass(frozen=True)
class FusedMixedPrecisionLamb:
    inner: FusedLAMB

    per_leaf = True

    def init(self, params: List[torch.Tensor],
             leaves: Optional[List] = None) -> FusedMixedPrecisionLambState:
        """fp32 masters of ``params`` and LAMB's state over them."""
        masters = [p.detach().float().clone() for p in params]
        return FusedMixedPrecisionLambState(masters,
                                            self.inner.init(masters, leaves))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             state: FusedMixedPrecisionLambState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One step: LAMB on the masters (gradients upcast to fp32), then
        the masters rounded into ``params``, in place."""
        self.inner.step([g.float() for g in grads], state.inner,
                        state.master_params, finite)
        commit_([(p, (p.float() + (m - p.float())).to(p.dtype))
                 for p, m in zip(params, state.master_params)], finite)


def fused_mixed_precision_lamb(learning_rate: Any = 1e-3, b1: float = 0.9,
                               b2: float = 0.999, eps: float = 1e-6,
                               weight_decay: float = 0.01,
                               max_grad_norm: Optional[float] = 1.0,
                               **lamb_kwargs: Any
                               ) -> FusedMixedPrecisionLamb:
    """LAMB over fp32 masters for half model parameters (the JAX
    package's signature; ``lamb_kwargs`` go to :func:`~apex_tpu_torch.
    optim.fused_lamb.fused_lamb`)."""
    from apex_tpu_torch.optim.fused_lamb import fused_lamb
    return FusedMixedPrecisionLamb(fused_lamb(
        learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm, **lamb_kwargs))
