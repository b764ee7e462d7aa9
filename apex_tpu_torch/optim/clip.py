"""Global-norm gradient clipping (reference ``apex/contrib/clip_grad``:
``multi_tensor_l2norm`` then ``multi_tensor_scale``).

Counterpart of ``apex_tpu/optim/clip.py`` over lists, tuples and dicts of
tensors: :func:`clip_grad_norm` returns the clipped gradients and the
norm before clipping, and :func:`clip_by_global_norm` is the same as a
gradient transform (``init`` / ``update``, the optax shape of the JAX
function), to apply before an optimizer's step.  Everything stays on
the device.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from apex_tpu_torch.optim._multi_tensor import (
    global_grad_clip_coef,
    tree_scale,
)

__all__ = ["clip_grad_norm", "clip_by_global_norm", "ClipByGlobalNorm"]


def clip_grad_norm(grads: Any, max_norm: float, *,
                   eps: float = 1e-6) -> Tuple[Any, torch.Tensor]:
    """``(clipped_grads, total_norm)``: ``grads`` scaled to a global L2
    norm of at most ``max_norm``, and their norm before clipping (the
    reference's ``clip_grad_norm_`` returns it too)."""
    coef, total_norm = global_grad_clip_coef(grads, max_norm, eps=eps)
    return tree_scale(grads, coef), total_norm


class ClipByGlobalNorm:
    """The transform of :func:`clip_by_global_norm`."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Any) -> None:
        """No state."""
        del params
        return None

    def update(self, grads: Any, state: Any = None, params: Any = None):
        """``(clipped_grads, state)``."""
        del params
        clipped, _ = clip_grad_norm(grads, self.max_norm)
        return clipped, state


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    """Global-norm clipping as a gradient transform."""
    return ClipByGlobalNorm(max_norm)
