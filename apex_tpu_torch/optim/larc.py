"""LARC — layer-wise adaptive rate clipping (or scaling) around an
optimizer.

Counterpart of ``apex_tpu/optim/larc.py`` (reference
``apex/parallel/LARC.py``).  Per parameter tensor the "local lr"

    local_lr = trust_coefficient · ||p|| / (||g|| + wd · ||p|| + eps)

rescales the gradient before the wrapped optimizer's step: by
``min(local_lr / lr, 1)`` under ``clip=True`` (LARC: the effective lr is
``min(local_lr, lr)``), by ``local_lr`` under ``clip=False`` (LARS); by 1
where ``||p||`` or ``||g||`` is zero.  Where the JAX package chains its
transform before a base optax transform, the port wraps a port optimizer
(``larc(fused_sgd(...))``) and reads ``lr`` and ``wd`` from it: the
wrapped optimizer applies the weight decay, LARC only reads it for the
formula, as the JAX transform does.  The norms are per parameter, so
LARC is ``per_leaf`` (the train state hands :meth:`Larc.init` each
buffer's parameters); each line is one launch over a flat buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from apex_tpu_torch.optim._multi_tensor import Segments, segments_of

__all__ = ["larc", "Larc", "LarcState"]


@dataclasses.dataclass
class LarcState:
    inner: Any                   # the wrapped optimizer's state
    segments: List[Segments]


@dataclasses.dataclass(frozen=True)
class Larc:
    optimizer: Any
    trust_coefficient: float = 0.02
    clip: bool = True
    eps: float = 1e-8

    per_leaf = True

    @property
    def learning_rate(self) -> float:
        lr = getattr(self.optimizer, "learning_rate", None)
        if not isinstance(lr, (int, float)):
            raise ValueError(
                "larc needs a float learning_rate on the wrapped optimizer "
                f"(got {lr!r}), as the JAX transform needs a concrete one")
        return float(lr)

    def init(self, params: List[torch.Tensor],
             leaves: Optional[List] = None) -> LarcState:
        if getattr(self.optimizer, "per_leaf", False):
            inner = self.optimizer.init(params, leaves)
        else:
            inner = self.optimizer.init(params)
        return LarcState(inner, segments_of(params, leaves))

    def scale(self, grads: List[torch.Tensor], state: LarcState,
              params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients rescaled by each tensor's local lr, in their
        dtypes."""
        lr = self.learning_rate
        wd = float(getattr(self.optimizer, "weight_decay", 0.0))
        out = []
        for g, p, seg in zip(grads, params, state.segments):
            gf = g.float()
            p_norm, g_norm = seg.norms(p), seg.norms(gf)
            local = self.trust_coefficient * p_norm / (
                g_norm + wd * p_norm + self.eps)
            ok = (p_norm > 0) & (g_norm > 0)
            one = torch.ones_like(local)
            s = (torch.where(ok, torch.clamp(local / lr, max=1.0), one)
                 if self.clip else torch.where(ok, local, one))
            out.append((gf * seg.expand(s)).to(g.dtype))
        return out

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: LarcState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """The wrapped optimizer's step on the rescaled gradients; with
        ``finite`` (a device bool) a non-finite step changes nothing."""
        self.optimizer.step(self.scale(grads, state, params), state.inner,
                            params, finite)


def larc(optimizer: Any, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8) -> Larc:
    """Wrap ``optimizer`` (a port optimizer with a float
    ``learning_rate``) in LARC (``clip=True``) or LARS (``clip=False``)."""
    return Larc(optimizer, trust_coefficient, clip, eps)
