"""Mixture-of-Experts FFN: top-k token-choice routing with capacity.

Counterpart of ``apex_tpu/transformer/moe.py`` (GShard-style dense
dispatch): a gate, token-choice top-k routing with a load-balancing
auxiliary loss, capacity-bounded dispatch and combine as products with
one-hot masks, and stacked expert weights ``(E, ...)``.

Routing is per group (a batch row): each expert takes at most
``ceil(capacity_factor * S * k / E)`` tokens of a group, assigned in
token order; later tokens are dropped.  Ties between experts go to the
lowest index (``torch.argmax`` keeps the first maximum, as
``jnp.argmax`` does).

The expert products are ``torch.einsum`` over the stacked weights, as
the JAX package leaves them to XLA; no hand-written kernel is involved.
They run in the compute ``dtype`` and round there once, before the fp32
bias and activation (the JAX einsums keep the fp32 accumulator:
one rounding fewer on a half dtype, the same on fp32).  ``expert_axis``
names the mesh axis the experts would shard over; on one card it has no
effect.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.mlp import resolve_activation

__all__ = ["MoEConfig", "top_k_gating", "MoEMLP"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # per-group expert capacity = capacity_factor * S*k/E (group = batch
    # row)
    capacity_factor: float = 1.25
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None
    activation: str = "gelu"
    # gated experts (SwiGLU when activation="silu"), the Mixtral shape:
    # act(x·w1) * (x·wg) -> w2
    gated: bool = False
    use_bias: bool = True
    expert_axis: Optional[str] = "tensor"
    aux_loss_weight: float = 1e-2
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    def capacity(self, seq_len: int) -> int:
        """Per-group slots of each expert: at least ``cf·S·k/E``."""
        return max(1, math.ceil(
            self.capacity_factor * seq_len * self.top_k / self.num_experts))


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with capacity.

    ``logits``: ``(..., T, E)`` (leading dims are groups, routed
    independently).  Returns ``(dispatch, combine, aux)``: ``dispatch``
    ``(..., T, E, C)`` the one-hot routing mask, ``combine`` the same
    times the gate probability (renormalised over the k choices when
    k > 1), ``aux`` ``(...)`` the load-balancing term ``E · Σ_e
    mean_prob_e · assign_frac_e / k``.  A token's slot in its expert's
    buffer is its rank among the tokens routed there, over the k rounds
    in order; past ``capacity`` it is dropped.
    """
    t, e = logits.shape[-2:]
    if k > e:
        raise ValueError(
            f"top_k ({k}) cannot exceed num_experts ({e}) — later "
            f"routing rounds would silently double-route to expert 0")
    probs = torch.softmax(logits.float(), dim=-1)
    lead = probs.shape[:-2]
    dispatch = probs.new_zeros(*lead, t, e, capacity)
    combine = probs.new_zeros(*lead, t, e, capacity)
    fill = probs.new_zeros(*lead, 1, e)
    masked = probs
    assign_frac = probs.new_zeros(*lead, e)
    for _ in range(k):
        onehot = F.one_hot(torch.argmax(masked, dim=-1), e).float()
        assign_frac = assign_frac + onehot.mean(dim=-2)
        pos = torch.cumsum(onehot, dim=-2) - 1.0 + fill
        pos_tok = (pos * onehot).sum(dim=-1).long()
        keep = (pos_tok < capacity).float()
        poh = F.one_hot(pos_tok.clamp(max=capacity - 1), capacity).float()
        d = (onehot * keep[..., None])[..., None] * poh[..., None, :]
        gate = (probs * onehot).sum(dim=-1)
        dispatch = dispatch + d
        combine = combine + d * gate[..., None, None]
        fill = fill + (onehot * keep[..., None]).sum(dim=-2, keepdim=True)
        masked = masked * (1.0 - onehot)
    aux = e * (probs.mean(dim=-2) * assign_frac / k).sum(dim=-1)
    if k > 1:
        denom = combine.sum(dim=(-2, -1), keepdim=True)
        combine = combine / torch.clamp(denom, min=1e-9)
    return dispatch, combine, aux


class MoEMLP(nn.Module):
    """MoE FFN block: gate → dispatch → stacked expert MLPs → combine.

    Drop-in for a dense ``ParallelMLP``; ``forward`` returns ``(y,
    aux)``, ``aux`` the group-mean load-balancing term times
    ``aux_loss_weight``.  Parameters in the JAX module's layout: ``gate``
    ``(h, E)``, ``w1`` / ``wg`` ``(E, h, f)``, ``w2`` ``(E, f, h)``,
    ``b1`` ``(E, f)``, ``b2`` ``(E, h)``."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
        kw = dict(dtype=cfg.param_dtype, device=dev)
        self.gate = nn.Parameter(torch.empty(h, e, **kw))
        self.w1 = nn.Parameter(torch.empty(e, h, f, **kw))
        self.w2 = nn.Parameter(torch.empty(e, f, h, **kw))
        self.wg = (nn.Parameter(torch.empty(e, h, f, **kw))
                   if cfg.gated else None)
        if cfg.use_bias:
            self.b1 = nn.Parameter(torch.zeros(e, f, **kw))
            self.b2 = nn.Parameter(torch.zeros(e, h, **kw))
        else:
            self.register_parameter("b1", None)
            self.register_parameter("b2", None)
        self.act = resolve_activation(cfg.activation, gelu_approximate=True)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Gate normal (std 0.02); experts normal at their fan-in scale;
        zero biases."""
        self.gate.normal_(0.0, 0.02, generator=generator)
        for w in (self.w1, self.wg, self.w2):
            if w is not None:
                w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        for b in (self.b1, self.b2):
            if b is not None:
                b.zero_()

    def forward(self, x):
        cfg = self.cfg
        b, s, h = x.shape
        dt = cfg.dtype
        logits = torch.einsum("gsh,he->gse", x.float(), self.gate.float())
        dispatch, combine, aux = top_k_gating(logits, cfg.top_k,
                                              cfg.capacity(s))
        xin = torch.einsum("gsec,gsh->gech", dispatch.to(dt), x.to(dt))
        pre = torch.einsum("gech,ehf->gecf", xin, self.w1.to(dt)).float()
        if self.b1 is not None:
            pre = pre + self.b1[None, :, None].float()
        hmid = self.act(pre)
        if self.wg is not None:
            hmid = hmid * torch.einsum("gech,ehf->gecf", xin,
                                       self.wg.to(dt)).float()
        yout = torch.einsum("gecf,efh->gech", hmid.to(dt),
                            self.w2.to(dt)).float()
        if self.b2 is not None:
            yout = yout + self.b2[None, :, None].float()
        y = torch.einsum("gsec,gech->gsh", combine, yout)
        return y.to(x.dtype), cfg.aux_loss_weight * aux.mean()
