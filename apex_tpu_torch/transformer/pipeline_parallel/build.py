"""``build_model`` — a homogeneous layer stack cut into pipeline stages.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/build.py``
(reference ``apex/transformer/pipeline_parallel/utils.py::build_model``):
the reference builds a list of model chunks, one per (virtual) pipeline
stage, so users never hand-slice their model.  The JAX function stacks
every layer's parameters along ``(pp, per_stage)`` (``(V, pp,
per_stage)`` interleaved) for ``shard_map`` to split; here each process
builds only its own layers: chunk ``c`` on pipe rank ``r`` holds the
global layers ``[(c·pp + r)·per_stage, (c·pp + r + 1)·per_stage)``
(:func:`stage_layers`), the JAX stack's ``[c, r]`` row.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["build_model", "stage_layers"]


def _per_stage(num_layers: int, pp: int, v: int) -> int:
    if num_layers % (pp * v):
        raise ValueError(
            f"num_layers={num_layers} must be divisible by "
            f"pp*V={pp}*{v}={pp * v}")
    return num_layers // (pp * v)


def stage_layers(num_layers: int, pipeline_model_parallel_size: int,
                 virtual_pipeline_model_parallel_size: Optional[int] = None,
                 *, rank: int, chunk: int = 0) -> range:
    """The global layer indices of chunk ``chunk`` on pipe rank
    ``rank``."""
    pp = pipeline_model_parallel_size
    v = virtual_pipeline_model_parallel_size or 1
    per = _per_stage(num_layers, pp, v)
    first = (chunk * pp + rank) * per
    return range(first, first + per)


def _rope_tables(layer, x):
    """The RoPE tables a ``ParallelTransformerLayer`` of a ``rope``
    config needs for ``x`` (a sequence chunk under sequence
    parallelism): positions ``0 .. s-1`` of the whole sequence, the JAX
    layer's default positions; None for other layers."""
    cfg = getattr(layer, "cfg", None)
    if getattr(cfg, "position_embedding", None) != "rope":
        return None
    from apex_tpu_torch.ops.rope import rope_cos_sin

    chunk = getattr(layer, "seq_chunk", None)
    s = x.shape[1] * (chunk[1] if chunk else 1)
    return rope_cos_sin(s, cfg.rot_dim, base=cfg.rope_base, device=x.device)


def build_model(
    layer_factory: Callable[..., nn.Module],
    num_layers: int,
    pipeline_model_parallel_size: int,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    *,
    device=None,
    layer_remat: bool = False,
) -> Tuple[Callable, nn.ModuleList]:
    """``(stage_fn, chunks)`` of this pipe rank.

    ``layer_factory(device=...)`` builds one layer (e.g.
    ``functools.partial(ParallelTransformerLayer, cfg)``), a module that
    maps ``(mb, seq, hidden)`` to the same shape; ``num_layers`` must
    divide into ``pp · V`` stages.  ``chunks`` is an ``nn.ModuleList``
    of ``V`` (1 without interleaving) ``nn.ModuleList``\\ s of
    ``num_layers // (pp·V)`` layers; pass ``chunks[0]`` to the 1F1B
    schedule, all of them to the interleaved one.  The layers keep the weights the
    factory gave them; a model's weights reach this rank's chunks by
    ``load_state_dict`` (``parallel.pipeline.local_stage`` of a
    ``stage_split`` whole state dict, or
    ``models.jax_import.stage_params_from_jax``), which give chunk ``c``
    of pipe rank ``r`` the layers :func:`stage_layers` names.

    ``stage_fn(chunk, x)`` applies a chunk's layers in order (a
    ``ParallelTransformerLayer`` of a RoPE config gets the tables of
    positions ``0 .. s-1``, as the JAX layer applied alone).
    ``layer_remat=True`` recomputes each layer in the backward
    (non-reentrant ``torch.utils.checkpoint``), so differentiating a
    stage holds one layer's activations at a time.
    """
    from apex_tpu_torch.models.transformer import remat_context_fn

    pp = pipeline_model_parallel_size
    v = virtual_pipeline_model_parallel_size or 1
    per = _per_stage(num_layers, pp, v)
    dev = resolve_device(device)
    chunks = nn.ModuleList(
        nn.ModuleList(layer_factory(device=dev) for _ in range(per))
        for _ in range(v))

    def stage_fn(chunk, x):
        kw = {"rope": _rope_tables(chunk[0], x)} if len(chunk) else {}
        for layer in chunk:
            if layer_remat and torch.is_grad_enabled():
                x = checkpoint(
                    layer, x, use_reentrant=False,
                    context_fn=remat_context_fn("nothing_saveable"), **kw)
            else:
                x = layer(x, **kw)
        return x

    return stage_fn, chunks
