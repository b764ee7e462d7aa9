"""Model-parallel RNG keys and activation checkpointing.

Counterpart of ``apex_tpu/transformer/random.py`` (reference:
``apex/transformer/tensor_parallel/random.py``, whose CUDA RNG tracker
keeps one stream per tensor-parallel rank).  The JAX package folds the
mesh coordinate into a functional key; here the key is the port's replay
of a jax threefry key (a ``(2,)`` int64 tensor of uint32 words,
:func:`apex_tpu_torch.ops.fused_sampling.prng_key`), and
:func:`fold_in` gives the words ``jax.random.fold_in(key, data)`` gives:
both output words of ``threefry2x32(key, (0, data))``.

:func:`checkpoint` wraps a function in non-reentrant
``torch.utils.checkpoint`` under one of the port's remat policies
(:data:`CHECKPOINT_POLICIES` maps the JAX names onto them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import DATA_AXIS, TENSOR_AXIS
from apex_tpu_torch.ops.fused_sampling import threefry2x32

__all__ = [
    "fold_in",
    "model_parallel_rng_key",
    "data_parallel_rng_key",
    "checkpoint",
    "CHECKPOINT_POLICIES",
]

_MASK = 0xFFFFFFFF


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a ``(2,)`` key tensor."""
    k0, k1 = key[..., 0], key[..., 1]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                          torch.full_like(k1, int(data) & _MASK))
    return torch.stack([x0, x1], dim=-1)


def model_parallel_rng_key(key: torch.Tensor, axis: str = TENSOR_AXIS):
    """The key of this tensor-parallel rank (the tracker's
    "model-parallel-rng" stream): ``fold_in(key, rank along axis)``."""
    return fold_in(key, mesh_lib.mesh_axis_rank(axis))


def data_parallel_rng_key(key: torch.Tensor, axis: str = DATA_AXIS):
    """The key of this data-parallel rank."""
    return fold_in(key, mesh_lib.mesh_axis_rank(axis))


#: the JAX package's policy names → the port's remat policies
#: (:data:`apex_tpu_torch.models.transformer.REMAT_POLICIES`)
CHECKPOINT_POLICIES = {
    "full": "nothing_saveable",
    "dots": "dots_with_no_batch_dims_saveable",
    "dots_no_batch": "dots_with_no_batch_dims_saveable",
    "nothing": "everything_saveable",
}


def checkpoint(fn, *, policy: Optional[str] = "full"):
    """``fn`` recomputed in the backward (``tensor_parallel.checkpoint``)
    under ``policy``: a key of :data:`CHECKPOINT_POLICIES` or one of the
    port's remat policies.  Dropout inside ``fn`` must draw from seeds
    passed in, so the recomputation draws the same masks."""
    from apex_tpu_torch.models.transformer import (
        remat_context_fn,
        remat_saves,
    )

    pol = CHECKPOINT_POLICIES.get(policy or "full", policy)
    if remat_saves(pol) == "all":
        return fn
    context_fn = remat_context_fn(pol)

    def wrapped(*args, **kwargs):
        return _checkpoint(fn, *args, use_reentrant=False,
                           context_fn=context_fn, **kwargs)
    return wrapped
