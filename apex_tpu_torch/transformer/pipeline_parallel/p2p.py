"""Stage-to-stage communication over the mesh's ``pipe`` group.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/p2p.py``
(reference ``apex/transformer/pipeline_parallel/p2p_communication.py``):
point-to-point sends and receives between neighbouring pipeline ranks,
built on ``torch.distributed.P2POp`` / ``batch_isend_irecv`` over the
group of this rank's line along ``pipe``.

- The schedule knows every shape and dtype, so there is no handshake:
  a receive takes the shape and dtype of what it expects.
- The sends and the receives of one exchange are posted together, as one
  batch, and then waited on.  Two neighbours that each posted a blocking
  send first would wait on each other forever (gloo and NCCL alike).
- A pipe group of one calls nothing: NCCL refuses a send to self, and
  JAX's ``ppermute`` over one device is the identity.

:func:`send_forward_recv_forward` / :func:`send_backward_recv_backward`
keep the JAX functions' ring semantics (rank ``r`` to ``r ± 1`` mod
``pp``, the first rank receiving the last one's tensor) and are
differentiable: the backward of one is the other, as the transpose of
JAX's ``ppermute``.  The unfused names keep the reference's (Megatron's)
meaning: a send to the next (previous) stage, a no-op on the last
(first) one, and a receive of a given shape, ``None`` where there is no
neighbour.  :func:`exchange` is the primitive the schedules build on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import PIPE_AXIS
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "send_forward_recv_forward",
    "send_backward_recv_backward",
    "send_forward",
    "recv_forward",
    "send_backward",
    "recv_backward",
    "exchange",
    "connect",
    "pipe_rank_and_size",
]

#: message tags: activations travel forward, gradients backward
FORWARD_TAG, BACKWARD_TAG = 0, 1


def pipe_rank_and_size(axis: str = PIPE_AXIS,
                       mesh=None) -> Tuple[int, int]:
    """``(rank, size)`` of this process along ``axis`` of ``mesh``
    (default: the current mesh); ``(0, 1)`` when no mesh is initialized
    (one process is one stage)."""
    if mesh is None and not mesh_lib.mesh_is_initialized():
        return 0, 1
    m = mesh or mesh_lib.get_mesh()
    return m.axis_rank(axis), m.axis_size(axis)


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, int, int]], *,
             axis: str = PIPE_AXIS, mesh=None) -> None:
    """Post ``sends`` ``(tensor, peer, tag)`` and ``recvs`` ``(buffer,
    peer, tag)`` together and wait for all of them; ``peer`` is a rank
    along ``axis`` of ``mesh`` (default: the current mesh).  Messages to
    this rank itself never reach the backend: each is copied into this
    rank's receive of the same tag, in order."""
    me, _ = pipe_rank_and_size(axis, mesh)
    own = [(t, tag) for t, p, tag in sends if p == me]
    for buf, _, tag in (r for r in recvs if r[1] == me):
        i = next(i for i, (_, t) in enumerate(own) if t == tag)
        buf.copy_(own.pop(i)[0])
    if own:
        raise ValueError("exchange: a send to this rank has no receive")
    if mesh is None and mesh_lib.mesh_is_initialized():
        mesh = mesh_lib.get_mesh()
    ops: List[dist.P2POp] = []
    if mesh is not None:
        line, group = mesh.line(axis), mesh.group(axis)
        ops += [dist.P2POp(dist.isend, t.contiguous(), line[p], group, tag)
                for t, p, tag in sends if p != me]
        ops += [dist.P2POp(dist.irecv, b, line[p], group, tag)
                for b, p, tag in recvs if p != me]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def connect(device, *, axis: str = PIPE_AXIS, mesh=None) -> None:
    """Open the pipe group's communicator with one collective that every
    rank of the group calls (a 1-element all-reduce on ``device``), once
    a mesh: NCCL leaves a first point-to-point batch that not every
    rank of the group joins undefined, and a schedule's first exchange
    is such a batch.  A group of one, or one already open, calls
    nothing."""
    if pipe_rank_and_size(axis, mesh)[1] == 1:
        return
    mesh = mesh or mesh_lib.get_mesh()
    if axis not in mesh.p2p_opened:
        dist.all_reduce(torch.zeros(1, device=device),
                        group=mesh.group(axis))
        mesh.p2p_opened.add(axis)


def _shift(x: torch.Tensor, offset: int, axis: str, tag: int):
    rank, n = pipe_rank_and_size(axis)
    out = torch.empty_like(x)
    exchange([(x, (rank + offset) % n, tag)],
             [(out, (rank - offset) % n, tag)], axis=axis)
    return out


class _Ring(torch.autograd.Function):
    """The ring shift by ``offset``; its backward shifts the gradient
    back (the transpose of a permutation)."""

    @staticmethod
    def forward(ctx, x, offset, axis):
        ctx.offset, ctx.axis = offset, axis
        return _shift(x, offset, axis, FORWARD_TAG if offset > 0
                      else BACKWARD_TAG)

    @staticmethod
    def backward(ctx, g):
        off = -ctx.offset
        return (_shift(g.contiguous(), off, ctx.axis,
                       FORWARD_TAG if off > 0 else BACKWARD_TAG),
                None, None)


def send_forward_recv_forward(x: torch.Tensor, *,
                              axis: str = PIPE_AXIS) -> torch.Tensor:
    """Rotate ``x`` one stage forward (rank ``r`` → ``r + 1``, wrapping):
    the result on rank ``r`` is rank ``r - 1``'s tensor, on rank 0 the
    last rank's.  Differentiable; a group of one returns ``x``."""
    if pipe_rank_and_size(axis)[1] == 1:
        return x
    return _Ring.apply(x, 1, axis)


def send_backward_recv_backward(x: torch.Tensor, *,
                                axis: str = PIPE_AXIS) -> torch.Tensor:
    """Rotate ``x`` one stage backward (rank ``r`` → ``r - 1``,
    wrapping): the transpose of :func:`send_forward_recv_forward`."""
    if pipe_rank_and_size(axis)[1] == 1:
        return x
    return _Ring.apply(x, -1, axis)


def _neighbour(step: int, axis: str) -> Optional[int]:
    rank, n = pipe_rank_and_size(axis)
    peer = rank + step
    return peer if 0 <= peer < n else None


def _recv(peer, shape, dtype, device, tag, axis):
    if peer is None:
        return None
    buf = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    exchange([], [(buf, peer, tag)], axis=axis)
    return buf


def send_forward(x: torch.Tensor, *, axis: str = PIPE_AXIS) -> None:
    """Send ``x`` to the next stage (nothing on the last one)."""
    peer = _neighbour(1, axis)
    if peer is not None:
        exchange([(x, peer, FORWARD_TAG)], [], axis=axis)


def send_backward(dx: torch.Tensor, *, axis: str = PIPE_AXIS) -> None:
    """Send ``dx`` to the previous stage (nothing on the first one)."""
    peer = _neighbour(-1, axis)
    if peer is not None:
        exchange([(dx, peer, BACKWARD_TAG)], [], axis=axis)


def recv_forward(shape, dtype, *, device=None,
                 axis: str = PIPE_AXIS) -> Optional[torch.Tensor]:
    """The previous stage's activation (``None`` on the first stage),
    received into a new tensor on ``device`` (``"cuda"`` unless the
    caller names another, as every entry point of the port)."""
    return _recv(_neighbour(-1, axis), shape, dtype, device, FORWARD_TAG,
                 axis)


def recv_backward(shape, dtype, *, device=None,
                  axis: str = PIPE_AXIS) -> Optional[torch.Tensor]:
    """The next stage's gradient (``None`` on the last stage), on
    ``device`` as :func:`recv_forward`."""
    return _recv(_neighbour(1, axis), shape, dtype, device, BACKWARD_TAG,
                 axis)
