"""FusedLAMB — layer-wise adaptive LAMB for large-batch training.

Counterpart of ``apex_tpu/optim/fused_lamb.py`` (reference
``apex/optimizers/fused_lamb.py`` + ``multi_tensor_lamb_kernel.cu``) in
the interface of :mod:`apex_tpu_torch.optim.fused_adam`: ``init(params,
leaves)`` and ``step(grads, state, params, finite)``, in place.  A step:

1. the global gradient norm over every buffer, and a clip by
   ``max_grad_norm``;
2. Adam moments with bias correction → an update per element (plus the
   decoupled weight-decay term);
3. per parameter tensor the trust ratio ``||p|| / ||update||`` (1 where
   either norm is zero; clamped at 1 under ``trust_clip``), applied only
   when ``weight_decay != 0`` or ``always_adapt``;
4. ``p -= lr * ratio * update``.

The JAX package computes this in XLA; here it is plain PyTorch over the
train state's flat buffers, each line one launch over every parameter.
``shard_axis`` (a mesh axis or process group): the buffers are ZeRO
shards (:mod:`apex_tpu_torch.parallel.distributed_optim`), so the clip
norm's and each buffer's per-tensor sums of squares are all-reduced over
the shards (one collective a buffer) and the update is the whole one.
The trust ratio is per parameter, so the optimizer is ``per_leaf``: the
train state hands :meth:`FusedLAMB.init` each buffer's parameters, whose
norms come from one multi-tensor norm over views of the buffer
(:func:`~apex_tpu_torch.optim._multi_tensor.segment_norms`).  With a
device-side ``finite`` flag a non-finite step changes nothing, without a
host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Union

import torch
import torch.distributed as dist

from apex_tpu_torch.core.mesh import group_of
from apex_tpu_torch.optim._multi_tensor import (
    Segments,
    commit_,
    global_grad_clip_coef,
    segments_of,
    step_scalars,
)

__all__ = ["fused_lamb", "FusedLAMB", "FusedLambState"]


@dataclasses.dataclass
class FusedLambState:
    count: torch.Tensor          # step count, int32 scalar
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]
    segments: List[Segments]     # per buffer, its parameters' sizes


@dataclasses.dataclass(frozen=True)
class FusedLAMB:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    bias_correction: bool = True
    adam_w_mode: bool = True
    max_grad_norm: Optional[float] = 1.0
    trust_clip: bool = False
    always_adapt: bool = False
    shard_axis: Any = None

    #: :meth:`init` takes each buffer's parameters (the trust ratio is per
    #: parameter)
    per_leaf = True

    def init(self, params: List[torch.Tensor],
             leaves: Optional[List] = None) -> FusedLambState:
        """Zero moments beside ``params``, in their dtype (the moments
        are updated in fp32); ``leaves[i]``: the parameters of buffer
        ``i`` in order (default: one a buffer)."""
        device = params[0].device if params else None
        return FusedLambState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg=[torch.zeros_like(p) for p in params],
            exp_avg_sq=[torch.zeros_like(p) for p in params],
            segments=segments_of(params, leaves))

    def updates(self, grads: List[torch.Tensor], state: FusedLambState,
                params: List[torch.Tensor]):
        """The step without committing it: ``(count, [(update, m_new,
        v_new)] per buffer)``, ``update`` the fp32 change of the
        parameters."""
        count = state.count + 1
        lr, bc1, bc2 = step_scalars(self.learning_rate, count, self.b1,
                                    self.b2, self.bias_correction)
        coef, _ = global_grad_clip_coef(grads, self.max_grad_norm,
                                        axis=self.shard_axis)
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        use_trust = self.always_adapt or wd != 0.0
        out = []
        for g, p, m, v, seg in zip(grads, params, state.exp_avg,
                                   state.exp_avg_sq, state.segments):
            gf = g.float() * coef
            pf = p.float()
            if not self.adam_w_mode and wd != 0.0:
                gf = gf + wd * pf
            m_new = b1 * m.float() + (1.0 - b1) * gf
            v_new = b2 * v.float() + (1.0 - b2) * gf.square()
            upd = (m_new / bc1) / ((v_new / bc2).sqrt() + self.eps)
            if self.adam_w_mode and wd != 0.0:
                upd = upd + wd * pf
            if use_trust:
                if self.shard_axis is None:
                    w_norm, u_norm = seg.norms(pf), seg.norms(upd)
                else:
                    sq = torch.cat([seg.sumsq(pf), seg.sumsq(upd)])
                    dist.all_reduce(sq, group=group_of(self.shard_axis))
                    w_norm, u_norm = torch.sqrt(sq).chunk(2)
                ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                    w_norm / u_norm,
                                    torch.ones_like(w_norm))
                if self.trust_clip:
                    ratio = torch.clamp(ratio, max=1.0)
                step = seg.expand(-lr * ratio) * upd
            else:
                step = -lr * upd
            out.append((step, m_new, v_new))
        return count, out

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedLambState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """One LAMB step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step changes nothing."""
        count, out = self.updates(grads, state, params)
        for p, m, v, (step, m_new, v_new) in zip(
                params, state.exp_avg, state.exp_avg_sq, out):
            commit_(((p, p + step.to(p.dtype)), (m, m_new), (v, v_new)),
                    finite)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_lamb(learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
               weight_decay: float = 0.01, bias_correction: bool = True,
               adam_w_mode: bool = True,
               max_grad_norm: Optional[float] = 1.0,
               trust_clip: bool = False,
               always_adapt: bool = False,
               shard_axis: Any = None) -> FusedLAMB:
    """Build the FusedLAMB optimizer (the JAX package's signature)."""
    return FusedLAMB(learning_rate, b1, b2, eps, weight_decay,
                     bias_correction, adam_w_mode, max_grad_norm,
                     trust_clip, always_adapt, shard_axis)
