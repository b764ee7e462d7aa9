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
one rounding fewer on a half dtype, the same on fp32).

Expert parallelism.  Built while a mesh is initialized, with
``expert_axis`` naming an axis of ``n`` ranks, rank ``r`` of that axis
holds experts ``[r·E/n, (r+1)·E/n)`` of ``w1``, ``w2``, ``wg``, ``b1``
and ``b2`` (``E % n`` raises); the gate stays whole.  The routing runs
on every rank alike.  Two cases, by the axis:

- ``"tensor"`` (the default): the tokens are the same on every rank of
  the axis.  Each rank dispatches to its own experts and combines their
  part; the parts are summed over the group (an all-reduce, or under
  sequence parallelism a reduce-scatter to the rank's chunk:
  ``seq_scatter_dim``).  ``x`` and the combine weights enter the
  experts' part through ``copy_to_tensor_parallel_region``, whose
  backward sums the ranks' parts of their gradients, so the gate's
  gradient and the input's are the unsharded layer's on every rank.
- any other axis (``"data"``): the tokens differ across ranks.  Each
  rank forms its ``(g, E, C, h)`` dispatch; an ``all_to_all_single``
  sends each expert's slots to the expert's owner, which runs its
  experts on every rank's slots, and a second sends the outputs back
  for the combine.  The backward of each exchange is the other.

Expert-sharded parameters carry ``expert_axis`` as an attribute.  Over
a data-parallel axis they are not replicas: the owner's gradient is
already the sum over the axis of every rank's tokens (the exchange's
backward brought it home), so the data all-reduce must leave them out,
and the mean over data is that sum divided by the axis size.
:func:`apex_tpu_torch.parallel.ddp.all_reduce_mean_grads` (given the
parameters; without them it raises once such a layer is on the mesh,
``Mesh.expert_sharded``), :class:`~apex_tpu_torch.parallel.ddp.
DistributedDataParallel` (which finds each gradient's parameter among
the ones it replicated), :func:`~apex_tpu_torch.parallel.ddp.replicate`
and a ZeRO train state over that axis (which keeps them out of its
shards) do so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import TENSOR_AXIS, group_of
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.mlp import resolve_activation
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer.layers import tensor_parallel

__all__ = ["MoEConfig", "top_k_gating", "MoEMLP", "expert_parallel_axis"]


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


def expert_parallel_axis(param) -> Optional[str]:
    """The mesh axis ``param``'s experts are sharded over (set by
    :class:`MoEMLP` on a mesh), else None."""
    return getattr(param, "expert_axis", None)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0; its own
    transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: the
    experts' output gradient then has one layout whether it comes from
    the combine or through an all-to-all, so the bias gradient's sum runs
    in one order (the sharded layer over a group of one is the unsharded
    one bitwise)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class MoEMLP(nn.Module):
    """MoE FFN block: gate → dispatch → stacked expert MLPs → combine.

    Drop-in for a dense ``ParallelMLP``; ``forward`` returns ``(y,
    aux)``, ``aux`` the group-mean load-balancing term times
    ``aux_loss_weight``.  Parameters in the JAX module's layout: ``gate``
    ``(h, E)``, ``w1`` / ``wg`` ``(E, h, f)``, ``w2`` ``(E, f, h)``,
    ``b1`` ``(E, f)``, ``b2`` ``(E, h)`` — the expert dim is this rank's
    ``E / n`` experts on a mesh whose ``expert_axis`` has ``n`` ranks
    (the module docstring)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
        #: (active, n, rank) of the expert axis: active on a mesh
        self.ep_active, self.ep_size, self.ep_rank = tensor_parallel(
            cfg.expert_axis)
        if e % self.ep_size:
            raise ValueError(
                f"num_experts ({e}) must split over the expert axis "
                f"{cfg.expert_axis!r} ({self.ep_size} ranks)")
        kw = dict(dtype=cfg.param_dtype, device=dev)
        self.gate = nn.Parameter(torch.empty(h, e, **kw))
        e //= self.ep_size                  # this rank's experts
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
        if self.ep_active:
            mesh_lib.get_mesh().expert_sharded.add(cfg.expert_axis)
            for p in (self.w1, self.w2, self.wg, self.b1, self.b2):
                if p is not None:
                    p.expert_axis = cfg.expert_axis

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

    def _experts(self, xin):
        """The local experts on their slots ``(g, E_local, C, h)``:
        fp32 ``(g, E_local, C, h)`` outputs."""
        dt = self.cfg.dtype
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
        return _ContiguousGrad.apply(yout)

    def forward(self, x, *, seq_scatter_dim: Optional[int] = None):
        """``(y, aux)`` of ``x`` ``(b, s, h)``.  ``seq_scatter_dim``
        (experts sharded over the tensor axis): the ranks' parts are
        reduce-scattered along that dim instead of all-reduced, so each
        rank gets its chunk of ``y``."""
        cfg = self.cfg
        b, s, h = x.shape
        dt = cfg.dtype
        logits = torch.einsum("gsh,he->gse", x.float(), self.gate.float())
        dispatch, combine, aux = top_k_gating(logits, cfg.top_k,
                                              cfg.capacity(s))
        aux = cfg.aux_loss_weight * aux.mean()
        if not self.ep_active:
            xin = torch.einsum("gsec,gsh->gech", dispatch.to(dt), x.to(dt))
            y = torch.einsum("gsec,gech->gsh", combine, self._experts(xin))
            return y.to(x.dtype), aux
        group = group_of(cfg.expert_axis)
        if cfg.expert_axis == TENSOR_AXIS:
            return self._forward_replicated(x, dispatch, combine, group,
                                            seq_scatter_dim), aux
        n = self.ep_size
        xin = torch.einsum("gsec,gsh->gech", dispatch.to(dt), x.to(dt))
        # (g, E, C, h) -> (n, g, E/n, C, h): block j to expert owner j
        el = xin.shape[1] // n
        send = xin.unflatten(1, (n, el)).transpose(0, 1)
        mine = _AllToAll.apply(send, group)        # every rank's slots
        yout = self._experts(mine.flatten(0, 1))   # (n·g, E/n, C, h)
        back = _AllToAll.apply(yout.unflatten(0, (n, b)), group)
        yout = back.transpose(0, 1).flatten(1, 2)  # (g, E, C, h)
        y = torch.einsum("gsec,gech->gsh", combine, yout)
        return y.to(x.dtype), aux

    def _forward_replicated(self, x, dispatch, combine, group,
                            seq_scatter_dim):
        """Experts over the tensor axis, the tokens the same on every
        rank: this rank's experts' part of ``y``, summed over the
        group."""
        dt = self.cfg.dtype
        n, el = self.ep_size, self.w1.shape[0]
        xe = mappings.copy_to_tensor_parallel_region(x, group)
        ce = mappings.copy_to_tensor_parallel_region(combine, group)
        if n > 1:
            lo = self.ep_rank * el
            dispatch = dispatch[:, :, lo:lo + el]
            ce = ce[:, :, lo:lo + el]
        xin = torch.einsum("gsec,gsh->gech", dispatch.to(dt), xe.to(dt))
        y = torch.einsum("gsec,gech->gsh", ce, self._experts(xin))
        if seq_scatter_dim is None:
            y = mappings.reduce_from_tensor_parallel_region(y, group)
        else:
            y = mappings.reduce_scatter_to_sequence_parallel_region(
                y, group, seq_scatter_dim)
        return y.to(x.dtype)
