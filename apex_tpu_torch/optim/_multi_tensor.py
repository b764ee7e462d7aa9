"""Multi-tensor helpers of the optimizers (apex's ``multi_tensor_apply``
semantics: one computation over a whole list of tensors).

Counterpart of ``apex_tpu/optim/_multi_tensor.py`` (whose functions live
in ``apex_tpu/utils/tree.py``): the same functions over lists, tuples and
dicts of tensors (nested as the JAX package's pytrees; anything that is
not a tensor passes through), plus :func:`segment_norms`, the per-tensor
norms of parameters laid end to end in one flat buffer — the train
state's layout, which LAMB's trust ratio, NovoGrad's per-layer moment and
LARC read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.core.mesh import group_of
from apex_tpu_torch.core.precision import tree_leaves, tree_map

__all__ = ["tree_l2_norm", "per_tensor_l2_norms", "tree_scale",
           "tree_axpby", "global_grad_clip_coef", "segment_norms"]


def tree_l2_norm(tree: Any, *, dtype=torch.float32,
                 axis=None) -> torch.Tensor:
    """Global L2 norm over every floating tensor (``amp_C.
    multi_tensor_l2norm``), in ``dtype``; a zero without any.  ``axis``:
    the tensors are ZeRO shards over that mesh axis (or group), whose
    sums of squares are all-reduced first."""
    leaves = [t for t in tree_leaves(tree) if torch.is_floating_point(t)]
    if not leaves:
        return torch.zeros((), dtype=dtype)
    sq = sum(torch.sum(torch.square(t.to(dtype))) for t in leaves)
    if axis is not None:
        sq = sq.reshape(1).clone()
        dist.all_reduce(sq, group=group_of(axis))
        sq = sq[0]
    return torch.sqrt(sq)


def per_tensor_l2_norms(tree: Any, *, dtype=torch.float32) -> Any:
    """The L2 norm of each tensor (``multi_tensor_l2norm(...,
    per_tensor=True)``), in the tree's containers."""
    return tree_map(lambda t: torch.sqrt(torch.sum(torch.square(t.to(dtype)))),
                tree)


def tree_scale(tree: Any, scale) -> Any:
    """``amp_C.multi_tensor_scale``: every floating tensor times
    ``scale``, computed in fp32 and cast back to its dtype."""
    return tree_map(lambda t: (t.float() * scale).to(t.dtype)
                if torch.is_floating_point(t) else t, tree)


def tree_axpby(a, x: Any, b, y: Any) -> Any:
    """``amp_C.multi_tensor_axpby``: ``a * x + b * y`` over tensor
    pairs."""
    return tree_map(lambda xi, yi: a * xi + b * yi, x, y)


def global_grad_clip_coef(grads: Any, max_norm: Optional[float], *,
                          eps: float = 1e-6, axis=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(coef, global_norm)`` of a global-norm clip (``apex/contrib/
    clip_grad``): ``coef = min(1, max_norm / (norm + eps))``, 1 without
    ``max_norm``.  On the device, no host sync; ``axis`` as in
    :func:`tree_l2_norm`."""
    gnorm = tree_l2_norm(grads, axis=axis)
    if max_norm is None:
        return torch.ones((), dtype=torch.float32,
                          device=gnorm.device), gnorm
    # a tensor numerator: torch computes float / tensor as a reciprocal
    # and a product, not the correctly rounded quotient
    return torch.clamp(torch.full_like(gnorm, max_norm) / (gnorm + eps),
                       max=1.0), gnorm


def segment_norms(flat: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """The fp32 L2 norm of each of the tensors laid end to end in
    ``flat`` (``sizes[i]`` elements each), as one ``(len(sizes),)``
    tensor: on the card torch's multi-tensor norm over views of the
    buffer, one launch; on the CPU the root of each view's ``torch.sum``
    of squares, whose cascade stays within ~1e-7 where the CPU's norm
    kernel runs one fp32 total (1.3e-3 off over 2.3e7 elements)."""
    views = torch.split(flat.float(), list(sizes))
    if flat.is_cuda:
        return torch.stack(torch._foreach_norm(views, 2))
    return torch.stack([torch.sum(torch.square(v)) for v in views]).sqrt()


@dataclasses.dataclass
class Segments:
    """The tensors of one flat buffer: their ``sizes`` in order, and the
    same as a device int64 tensor (``counts``)."""
    sizes: List[int]
    counts: torch.Tensor

    @classmethod
    def of(cls, buf: torch.Tensor, leaves=None) -> "Segments":
        """``leaves``: the buffer's parameters (objects with ``numel``,
        such as :class:`~apex_tpu_torch.optim.fused_adam.Leaf`), or None
        for one tensor over the whole buffer."""
        sizes = ([buf.numel()] if leaves is None
                 else [int(lf.numel) for lf in leaves])
        if sum(sizes) != buf.numel():
            raise ValueError(f"leaves hold {sum(sizes)} elements, the "
                             f"buffer {buf.numel()}")
        return cls(sizes, torch.tensor(sizes, dtype=torch.int64,
                                       device=buf.device))

    def norms(self, flat: torch.Tensor) -> torch.Tensor:
        return segment_norms(flat, self.sizes)

    def sumsq(self, flat: torch.Tensor) -> torch.Tensor:
        """Each tensor's fp32 sum of squares, ``(len(sizes),)``."""
        views = torch.split(flat.float(), list(self.sizes))
        return torch.stack([torch.sum(torch.square(v)) for v in views])

    def expand(self, per: torch.Tensor) -> torch.Tensor:
        """A per-tensor ``(L,)`` value repeated over each tensor's
        elements."""
        return torch.repeat_interleave(per, self.counts,
                                       output_size=sum(self.sizes))


def segments_of(params: List[torch.Tensor], leaves=None) -> List[Segments]:
    """:class:`Segments` of each buffer (``leaves[i]``: buffer ``i``'s
    parameters; None: one tensor a buffer)."""
    if leaves is None:
        leaves = [None] * len(params)
    return [Segments.of(p, lv) for p, lv in zip(params, leaves)]


def commit_(pairs, finite: Optional[torch.Tensor]) -> None:
    """``old = new`` in place for each ``(old, new)`` pair, or, with a
    device bool ``finite``, ``old = finite ? new : old`` (step-or-skip
    without a host sync)."""
    for old, new in pairs:
        if new is old:
            continue
        if finite is None:
            old.copy_(new)
        else:
            torch.where(finite, new.to(old.dtype), old, out=old)


def step_scalars(learning_rate, count: torch.Tensor, b1: float, b2: float,
                 bias_correction: bool):
    """``(lr, bc1, bc2)`` of step ``count`` (a device int32 scalar): the
    learning rate (a float, or a schedule's value) and the bias
    corrections ``1 - b ** count`` in fp32, or ones."""
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    c = count.float()
    if bias_correction:
        return lr, 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    return lr, one, one
