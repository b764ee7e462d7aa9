"""Ring attention — context parallelism over the mesh's ``context`` axis.

Counterpart of ``apex_tpu/parallel/ring_attention.py`` (Liu et al., Ring
Attention).  The sequence is cut into ``cp`` chunks over the ranks of
the ``context`` group; each rank keeps its query chunk and the key/value
chunks rotate around the ring, so attention over the whole sequence is
exact with O(S / cp) memory a rank.  Layout ``(batch, seq_local,
heads, head_dim)``, GQA through fewer kv heads.

- **A tick** is one function of ``(q_local, k_chunk, v_chunk, rank,
  src, cp, state)`` (:func:`_fwd_tick`, :func:`_bwd_tick`): the local
  query chunk of ``rank`` against the key/value chunk that started on
  ``src``.  The loops over ticks call it for each rank this process
  plays, and a ring object rotates the chunks between ticks: the real
  ring (:class:`_MeshRing`, one batched ``isend``/``irecv`` a tick over
  the context group, the p2p style of ``transformer/pipeline_parallel/
  p2p.py``; nothing at ``cp == 1``) or a virtual one
  (:class:`_VirtualRing`: ``cp`` ranks in one process, a rotation is a
  shift of a list).  :func:`virtual_ring_attention` drives the virtual
  ring through the same code.
- **Forward.**  Each live chunk is one call of the flash forward
  (``torch.ops.apex_tpu_torch.flash_fwd``: the B-6 kernel on the card,
  its plain version on the CPU), which returns ``(o, lse)`` with the
  logsumexp in the log2 domain.  The chunks merge in fp32; a row with no
  visible key has ``lse = -1e30`` and gets weight 0 and output 0.
- **Masks** come from global positions, as ``_chunk_scores`` forms them
  (query ``rank·sq + i`` sees key ``src·sk + j`` iff ``src·sk + j <=
  rank·sq + i + cp·(sk - sq)``): a chunk every query sees whole runs
  unmasked; the diagonal chunk of equal lengths takes the kernel's own
  causal mask; a chunk no query sees (``_chunk_fully_dead``) launches
  nothing, though the rotation still runs; any other chunk (uneven
  lengths) takes the kernel's additive fp32 bias, -1e30 where masked.
- **Backward.**  The merged ``lse`` and ``delta = rowsum(dO·O)`` go to
  the dq and dk/dv kernels (B-7, B-8) for each live chunk, so each
  chunk's ``p = exp2(s - lse)`` is the global softmax.  ``dq``
  accumulates at home; ``dk`` / ``dv`` accumulate in fp32 buffers that
  rotate with their chunk and arrive home after ``cp`` rotations, as
  ``_ring_bwd`` does.
- ``remat=True`` saves only ``(q, k, v)`` and reruns the forward ring
  in the backward.

At ``cp == 1`` the one tick is ``fused_attention``'s own calls, so the
output and the gradients are bitwise those of ``fused_attention``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import CONTEXT_AXIS
from apex_tpu_torch.ops._dispatch import resolve_impl
from apex_tpu_torch.ops.attention import (
    MAX_HEAD_DIM,
    attention_delta,
    flash_bwd_dkv_kernel,
    flash_bwd_dkv_reference,
    flash_bwd_dq_kernel,
    flash_bwd_dq_reference,
    flash_fwd,
    flash_kernel_ok,
)
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer.pipeline_parallel import p2p

__all__ = ["ring_attention", "ring_self_attention",
           "virtual_ring_attention", "chunk_mask"]

_NEG_INF = -1e30
_HALF_NEG = 0.5 * _NEG_INF


# --------------------------------------------------------------------- #
# the rings
# --------------------------------------------------------------------- #
class _VirtualRing:
    """``cp`` ranks in one process: the inputs are the whole tensors,
    cut into ``cp`` chunks along the sequence; rank ``r`` of a rotation
    gets what rank ``r - 1`` held."""

    def __init__(self, cp: int):
        self.cp = int(cp)
        self.ranks = list(range(self.cp))

    def split(self, x):
        if x.shape[1] % self.cp:
            raise ValueError(f"sequence length {x.shape[1]} does not split "
                             f"into {self.cp} ring chunks")
        return list(x.chunk(self.cp, dim=1))

    def join(self, xs):
        return torch.cat(xs, dim=1)

    def rotate(self, items):
        return [items[(i - 1) % self.cp] for i in range(self.cp)]


class _MeshRing:
    """This process's place on the ring of ``mesh``'s ``axis`` group: it
    plays its own rank; a rotation sends its chunks to rank ``r + 1`` and
    receives rank ``r - 1``'s, all tensors of a tick in one batch."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.cp = mesh.axis_size(axis)
        self.rank = mesh.axis_rank(axis)
        self.ranks = [self.rank]

    def split(self, x):
        return [x]

    def join(self, xs):
        return xs[0]

    def rotate(self, items):
        if self.cp == 1:
            return items
        tensors = items[0]
        nxt, prv = (self.rank + 1) % self.cp, (self.rank - 1) % self.cp
        out = [torch.empty_like(t) for t in tensors]
        p2p.connect(tensors[0].device, axis=self.axis, mesh=self.mesh)
        p2p.exchange([(t, nxt, tag) for tag, t in enumerate(tensors)],
                     [(b, prv, tag) for tag, b in enumerate(out)],
                     axis=self.axis, mesh=self.mesh)
        return [tuple(out)]


# --------------------------------------------------------------------- #
# one tick
# --------------------------------------------------------------------- #
def chunk_mask(causal: bool, rank: int, src: int, sq: int, sk: int,
               cp: int, device=None):
    """How the chunk of ``rank``'s ``sq`` queries against ``src``'s
    ``sk`` keys is masked on a ring of ``cp``: ``("full", None)``,
    ``("causal", None)`` (the kernel's own bottom-aligned mask, the
    diagonal chunk of equal lengths), ``("dead", None)`` (no query sees
    a key: ``_chunk_fully_dead``) or ``("bias", b)`` with ``b`` the
    ``(sq, sk)`` fp32 additive mask, -1e30 where a key is hidden."""
    if not causal:
        return "full", None
    offset = cp * (sk - sq)                       # Sk_global - Sq_global
    q0, k0 = rank * sq, src * sk
    if k0 > q0 + (sq - 1) + offset:
        return "dead", None
    if k0 + (sk - 1) <= q0 + offset:
        return "full", None
    if src == rank and sq == sk:
        return "causal", None
    q_pos = q0 + torch.arange(sq, device=device)
    k_pos = k0 + torch.arange(sk, device=device)
    dead = k_pos[None, :] > q_pos[:, None] + offset
    bias = torch.zeros((sq, sk), dtype=torch.float32, device=device)
    return "bias", bias.masked_fill_(dead, _NEG_INF)


def _merge(o1, lse1, o2, lse2):
    """Two partial attentions over disjoint keys merged in fp32: ``o``
    ``(b, sq, h, d)``, ``lse`` ``(b*h, sq)`` log2 domain; a row with no
    visible key in either stays at -1e30 with output 0."""
    b, sq, h, _ = o1.shape
    m = torch.maximum(lse1, lse2)
    w1 = torch.where(lse1 > _HALF_NEG, torch.exp2(lse1 - m),
                     torch.zeros_like(m))
    w2 = torch.where(lse2 > _HALF_NEG, torch.exp2(lse2 - m),
                     torch.zeros_like(m))
    l = w1 + w2
    safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l > 0, m + torch.log2(safe),
                      torch.full_like(m, _NEG_INF))

    def rows(w):
        return (w / safe).view(b, h, sq).permute(0, 2, 1)[..., None]
    return o1.float() * rows(w1) + o2.float() * rows(w2), lse


def _fwd_tick(q, kc, vc, rank, src, cp, state, *, causal, scale, kernel):
    """Merge the chunk of ``rank``'s queries against ``src``'s keys into
    ``state`` (``None`` or ``(o, lse)``); a dead chunk launches nothing
    and leaves ``state`` as it was."""
    kind, bias = chunk_mask(causal, rank, src, q.shape[1], kc.shape[1], cp,
                            q.device)
    if kind == "dead":
        return state
    o, lse = flash_fwd(q, kc, vc, bias, scale, kind == "causal", None, 0.0,
                       0, q.shape[2], 0, kernel)
    if state is None:
        return o, lse
    return _merge(*state, o, lse)


def _bwd_tick(q, kc, vc, do, lse, delta, rank, src, cp, dq, dk, dv, *,
              causal, scale, kernel):
    """Add the chunk's ``dq`` to the home accumulator ``dq`` (``None``
    before the first live chunk) and its ``dk`` / ``dv`` to the fp32
    buffers ``dk`` / ``dv`` travelling with the chunk."""
    kind, bias = chunk_mask(causal, rank, src, q.shape[1], kc.shape[1], cp,
                            q.device)
    if kind == "dead":
        return dq, dk, dv
    args = (q, kc, vc, bias, do, lse, delta, scale, kind == "causal", None,
            0.0, 0)
    if kernel:
        dq_c = flash_bwd_dq_kernel(*args)
        dk_c, dv_c = flash_bwd_dkv_kernel(*args)
    else:
        dq_c = flash_bwd_dq_reference(*args)
        dk_c, dv_c = flash_bwd_dkv_reference(*args)
    dq = dq_c.float() if dq is None else dq + dq_c.float()
    return dq, dk + dk_c.float(), dv + dv_c.float()


# --------------------------------------------------------------------- #
# the loops over ticks
# --------------------------------------------------------------------- #
def _ring_forward(ring, qs, ks, vs, causal, scale, kernel):
    """``(o, lse)`` for each rank ``ring`` plays: ``o`` in the input
    dtype, ``lse`` ``(b*h, sq)``."""
    cp = ring.cp
    states: List[Optional[Tuple]] = [None] * len(ring.ranks)
    kv = list(zip(ks, vs))
    for t in range(cp):
        for i, r in enumerate(ring.ranks):
            states[i] = _fwd_tick(qs[i], *kv[i], r, (r - t) % cp, cp,
                                  states[i], causal=causal, scale=scale,
                                  kernel=kernel)
        if t < cp - 1:
            kv = ring.rotate(kv)
    out = []
    for q, st in zip(qs, states):
        if st is None:                  # every key of every chunk hidden
            b, sq, h, _ = q.shape
            st = (torch.zeros_like(q), torch.full(
                (b * h, sq), _NEG_INF, device=q.device))
        out.append((st[0].to(q.dtype), st[1]))
    return out


def _ring_backward(ring, qs, ks, vs, dos, lses, deltas, causal, scale,
                   kernel):
    """``(dq, dk, dv)`` for each rank ``ring`` plays, in the inputs'
    dtypes; ``dk`` / ``dv`` travel with their chunk for ``cp``
    rotations."""
    cp = ring.cp
    n = len(ring.ranks)
    dqs: List[Optional[torch.Tensor]] = [None] * n
    moving = [(k, v, torch.zeros(k.shape, dtype=torch.float32,
                                 device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device))
              for k, v in zip(ks, vs)]
    for t in range(cp):
        for i, r in enumerate(ring.ranks):
            kc, vc, dk, dv = moving[i]
            dqs[i], dk, dv = _bwd_tick(
                qs[i], kc, vc, dos[i], lses[i], deltas[i], r, (r - t) % cp,
                cp, dqs[i], dk, dv, causal=causal, scale=scale,
                kernel=kernel)
            moving[i] = (kc, vc, dk, dv)
        if t < cp - 1:
            moving = ring.rotate(moving)
        elif cp > 1:
            # the last rotation brings the accumulators home
            home = ring.rotate([(dk, dv) for _, _, dk, dv in moving])
            moving = [(None, None, dk, dv) for dk, dv in home]
    grads = []
    for q, k, v, dq, (_, _, dk, dv) in zip(qs, ks, vs, dqs, moving):
        dq = torch.zeros_like(q) if dq is None else dq.to(q.dtype)
        grads.append((dq, dk.to(k.dtype), dv.to(v.dtype)))
    return grads


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, remat, kernel):
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        outs = _ring_forward(ring, qs, ks, vs, causal, scale, kernel)
        o = ring.join([o for o, _ in outs])
        ctx.cfg = (ring, causal, scale, remat, kernel)
        if remat:
            ctx.save_for_backward(q, k, v)
        else:
            ctx.save_for_backward(q, k, v, o,
                                  torch.stack([lse for _, lse in outs]))
        return o

    @staticmethod
    def backward(ctx, do):
        ring, causal, scale, remat, kernel = ctx.cfg
        q, k, v = ctx.saved_tensors[:3]
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        if remat:
            outs = _ring_forward(ring, qs, ks, vs, causal, scale, kernel)
            os_, lses = [o for o, _ in outs], [lse for _, lse in outs]
        else:
            os_ = ring.split(ctx.saved_tensors[3])
            lses = list(ctx.saved_tensors[4].unbind(0))
        dos = ring.split(do.contiguous())
        deltas = [attention_delta(d, o) for d, o in zip(dos, os_)]
        grads = _ring_backward(ring, qs, ks, vs, dos, lses, deltas, causal,
                               scale, kernel)
        return (ring.join([g[0] for g in grads]),
                ring.join([g[1] for g in grads]),
                ring.join([g[2] for g in grads]),
                None, None, None, None, None)


def _attend(q, k, v, ring, causal, scale, remat, implementation):
    b, sq, h, d = q.shape
    hk = k.shape[2]
    if h % hk:
        raise ValueError(f"num_kv_heads ({hk}) must divide num_heads ({h})")
    scale = (d ** -0.5) if scale is None else float(scale)
    kernel = resolve_impl(
        implementation, q, inside=flash_kernel_ok(
            d, q.dtype == k.dtype == v.dtype),
        op="ring_attention", shape=(tuple(q.shape), str(q.dtype)),
        why=f"head_dim {d} or dtypes outside d % 8 == 0, d <= "
            f"{MAX_HEAD_DIM}, one dtype") == "kernel"
    return _RingAttention.apply(q, k, v, ring, bool(causal), scale,
                                bool(remat), kernel)


# --------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------- #
def ring_attention(q, k, v, axis: str = CONTEXT_AXIS, causal: bool = False,
                   scale: Optional[float] = None, remat: bool = False, *,
                   mesh=None, implementation: Optional[str] = None):
    """Exact attention over a sequence sharded on the ``axis`` group of
    ``mesh`` (default: the current mesh).  ``q`` / ``k`` / ``v`` are
    this rank's chunks ``(b, s_local, h|hk, d)``, chunk ``i`` on the
    axis's rank ``i``; returns the local output chunk ``(b, s_local, h,
    d)``.  Semantics (GQA, uneven ``sk != sq`` bottom-aligned on the
    whole sequence, rows with no visible key at zero) are
    :func:`~apex_tpu_torch.ops.attention.attention_reference`'s on the
    gathered sequence.  ``remat=True`` keeps only ``(q, k, v)`` for the
    backward, which reruns the forward ring.  ``implementation`` as in
    :func:`~apex_tpu_torch.ops.attention.fused_attention`."""
    mesh = mesh or mesh_lib.get_mesh()
    return _attend(q, k, v, _MeshRing(mesh, axis), causal, scale, remat,
                   implementation)


def virtual_ring_attention(q, k, v, cp: int, *, causal: bool = False,
                           scale: Optional[float] = None,
                           remat: bool = False,
                           implementation: Optional[str] = None):
    """The ring of ``cp`` ranks played in one process through the same
    ticks: ``q`` / ``k`` / ``v`` are the whole sequences ``(b, S, h|hk,
    d)``, cut into ``cp`` chunks each; returns the whole output.  A
    process with one card runs a long context's ring this way (and the
    tests hold the ring's numerics without processes)."""
    if int(cp) < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    return _attend(q, k, v, _VirtualRing(cp), causal, scale, remat,
                   implementation)


def self_attention_over_mesh(fn, q, k, v, mesh, axis, batch_spec):
    """``fn(q_local, k_local, v_local)`` on this rank's sequence chunk
    over ``axis`` (and its batch rows over ``batch_spec``) of the whole
    ``q`` / ``k`` / ``v``, the output all-gathered back to the whole
    layout.  The cut's backward all-gathers and the gather's keeps the
    own chunk, so the inputs' gradients are whole on every rank."""
    groups = [(mesh.group(axis), 1)]
    if batch_spec is not None:
        groups.insert(0, (mesh.group(batch_spec), 0))
    for g, dim in groups:
        q, k, v = (mappings.scatter_to_tensor_parallel_region(t, g, dim)
                   for t in (q, k, v))
    o = fn(q, k, v)
    for g, dim in reversed(groups):
        o = mappings.gather_from_tensor_parallel_region(o, g, dim)
    return o


def ring_self_attention(q, k, v, *, mesh, axis: str = CONTEXT_AXIS,
                        causal: bool = False, scale: Optional[float] = None,
                        remat: bool = False,
                        batch_spec: Optional[Sequence[str]] = None,
                        implementation: Optional[str] = None):
    """Whole ``(b, S, h, d)`` tensors in, the same on every rank: each
    rank cuts its sequence chunk over ``axis`` of ``mesh`` (and its
    batch rows over the ``batch_spec`` axis, e.g. ``"data"``, so DP × CP
    compose), runs :func:`ring_attention`, and the output is all-gathered
    back to the whole layout (autograd through the gather)."""
    return self_attention_over_mesh(
        lambda a, b, c: ring_attention(a, b, c, axis, causal, scale, remat,
                                       mesh=mesh,
                                       implementation=implementation),
        q, k, v, mesh, axis, batch_spec)
