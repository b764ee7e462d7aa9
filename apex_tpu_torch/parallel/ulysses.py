"""Ulysses sequence parallelism — all-to-all context parallelism.

Counterpart of ``apex_tpu/parallel/ulysses.py`` (the DeepSpeed-Ulysses
pattern), the second context-parallel strategy beside
:mod:`~apex_tpu_torch.parallel.ring_attention`:

- the input arrives sequence-sharded ``(b, s/cp, h, d)`` over the
  ``context`` group;
- one ``all_to_all_single`` re-shards sequence → heads: every rank then
  holds the whole sequence for ``h/cp`` of the heads;
- attention runs locally through
  :func:`~apex_tpu_torch.ops.attention.fused_attention` (the flash
  kernels on the card: windows, dropout and GQA unchanged);
- a second ``all_to_all_single`` re-shards heads → sequence.

The exchanges are autograd functions: the backward of one is the other.
GQA: kv heads split when ``hk % cp == 0``; when ``cp % hk == 0`` they are
repeated ``cp // hk`` times first (each rank then receives one kv head,
aligned with its block of query heads).  Dropout folds the integer seed
with the rank, ``int32(uint32(seed) ^ ((rank + 1) · 0x9E3779B9 mod
2^32))``, and drops on the local lanes, so the masks are the JAX
function's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import CONTEXT_AXIS
from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.parallel.ring_attention import self_attention_over_mesh

__all__ = ["ulysses_attention", "ulysses_self_attention", "fold_seed"]

_U32 = 0xFFFFFFFF


def fold_seed(seed: int, rank: int) -> int:
    """The dropout seed of context rank ``rank``: ``uint32(seed)`` xor
    ``(rank + 1) · 0x9E3779B9`` (mod 2^32), as an int32."""
    mixed = (int(seed) & _U32) ^ (((int(rank) + 1) * 0x9E3779B9) & _U32)
    return mixed - (1 << 32) if mixed >= (1 << 31) else mixed


def _seq_to_heads(x, group, cp):
    """``(b, s/cp, hx, d)`` → ``(b, s, hx/cp, d)``: block ``j`` of the
    heads goes to rank ``j``, the sequence chunks arrive in rank order."""
    b, sl, hx, d = x.shape
    send = x.reshape(b, sl, cp, hx // cp, d).permute(2, 0, 1, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, cp * sl, hx // cp, d)


def _heads_to_seq(x, group, cp):
    """``(b, s, h/cp, d)`` → ``(b, s/cp, h, d)``: the inverse exchange."""
    b, s, hl, d = x.shape
    send = x.reshape(b, cp, s // cp, hl, d).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // cp, cp * hl, d)


class _Exchange(torch.autograd.Function):
    """Sequence → heads (``to_heads``) or heads → sequence; the backward
    is the other exchange."""

    @staticmethod
    def forward(ctx, x, group, cp, to_heads):
        ctx.args = (group, cp, to_heads)
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, group, cp)

    @staticmethod
    def backward(ctx, g):
        group, cp, to_heads = ctx.args
        back = _heads_to_seq if to_heads else _seq_to_heads
        return back(g.contiguous(), group, cp), None, None, None


def ulysses_attention(q, k, v, axis: str = CONTEXT_AXIS, *,
                      causal: bool = False, scale: Optional[float] = None,
                      window: Optional[int] = None,
                      dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None,
                      implementation: Optional[str] = None, mesh=None):
    """Exact attention over a sequence sharded on the ``axis`` group of
    ``mesh`` (default: the current mesh): ``q`` / ``k`` / ``v`` are
    this rank's chunks ``(b, s_local, h|hk, d)``; returns the local
    output chunk ``(b, s_local, h, d)``.  Semantics (GQA, ``window``)
    are :func:`~apex_tpu_torch.ops.attention.fused_attention`'s on the
    gathered sequence; dropout folds ``dropout_seed`` with the rank (the
    module docstring).  Needs ``h % cp == 0`` and ``hk % cp == 0`` or
    ``cp % hk == 0``."""
    mesh = mesh or mesh_lib.get_mesh()
    group = mesh.group(axis)
    cp, rank = mesh.axis_size(axis), mesh.axis_rank(axis)
    if dropout_rate > 0.0 and dropout_seed is not None:
        dropout_seed = fold_seed(dropout_seed, rank)
    h, hk = q.shape[2], k.shape[2]
    if h % cp:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the context "
            f"axis size ({cp}) — use ring_attention otherwise")
    if hk % cp and cp % hk:
        raise ValueError(
            f"ulysses GQA needs kv heads ({hk}) divisible by cp ({cp}) "
            f"or cp divisible by kv heads — got neither")
    if hk % cp:
        k = k.repeat_interleave(cp // hk, dim=2)
        v = v.repeat_interleave(cp // hk, dim=2)
    q, k, v = (_Exchange.apply(t, group, cp, True) for t in (q, k, v))
    o = fused_attention(q, k, v, causal=causal, scale=scale, window=window,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                        implementation=implementation)
    return _Exchange.apply(o, group, cp, False)


def ulysses_self_attention(q, k, v, *, mesh, axis: str = CONTEXT_AXIS,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           batch_spec: Optional[Sequence[str]] = None,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           implementation: Optional[str] = None):
    """Whole ``(b, S, h, d)`` tensors in, the same on every rank: each
    rank cuts its sequence chunk over ``axis`` (and its batch rows over
    the ``batch_spec`` axis), runs :func:`ulysses_attention`, and the
    output is all-gathered back to the whole layout."""
    return self_attention_over_mesh(
        lambda a, b, c: ulysses_attention(
            a, b, c, axis, causal=causal, scale=scale, window=window,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            implementation=implementation, mesh=mesh),
        q, k, v, mesh, axis, batch_spec)
