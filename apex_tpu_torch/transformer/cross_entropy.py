"""Vocab-parallel cross entropy.

Counterpart of ``apex_tpu/transformer/cross_entropy.py`` (reference:
``apex/transformer/tensor_parallel/cross_entropy.py``): with the logits
sharded by vocabulary over the tensor group, the loss needs no gathered
logits — (1) a MAX all-reduce of the row maxima, (2) the target logit
picked where this rank holds it and all-reduced, (3) the sum of exps
all-reduced.  The sums go through
:func:`~apex_tpu_torch.transformer.mappings.reduce_from_tensor_parallel_region`
(identity backward), so the backward is local: softmax minus one-hot on
this rank's slice.  Label smoothing as in :mod:`apex_tpu_torch.ops.xentropy`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.core.mesh import TENSOR_AXIS, group_of
from apex_tpu_torch.transformer.mappings import (
    all_reduce,
    reduce_from_tensor_parallel_region,
)

__all__ = ["vocab_parallel_cross_entropy"]


def vocab_parallel_cross_entropy(logits_shard, target, *,
                                 smoothing: float = 0.0, axis=TENSOR_AXIS):
    """Per-example fp32 loss of ``target.shape`` from this rank's
    ``(..., vocab / tp)`` slice of the logits; ``target`` holds global
    vocabulary ids."""
    group = group_of(axis)
    lf = logits_shard.float()
    per = lf.shape[-1]
    start = dist.get_rank(group) * per
    # (1) the global max, a constant for the backward
    global_max = all_reduce(lf.detach().amax(dim=-1), group,
                            op=dist.ReduceOp.MAX)
    lf = lf - global_max[..., None]
    # (2) the target logit where this rank holds it
    in_range = (target >= start) & (target < start + per)
    local_ids = torch.clamp(target - start, 0, per - 1).long()
    picked = torch.gather(lf, -1, local_ids[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    picked = reduce_from_tensor_parallel_region(picked, group)
    # (3) the global log-sum-exp
    sum_exp = reduce_from_tensor_parallel_region(
        torch.exp(lf).sum(dim=-1), group)
    lse = torch.log(sum_exp)
    nll = lse - picked
    if smoothing > 0.0:
        vocab = per * dist.get_world_size(group)
        mean_logit = reduce_from_tensor_parallel_region(
            lf.sum(dim=-1), group) / vocab
        return (1.0 - smoothing) * nll + smoothing * (lse - mean_logit)
    return nll
