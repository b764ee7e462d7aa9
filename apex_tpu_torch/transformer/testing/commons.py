"""Test-harness commons (``apex_tpu/transformer/testing/commons.py``;
reference ``apex/transformer/testing/commons.py``).

:func:`initialize_distributed` starts ``torch.distributed`` and builds
the mesh; :func:`standalone_gpt` / :func:`standalone_bert` build the tiny
models the parallel tests train, each rank holding its tensor-parallel
shard of one set of whole weights; :func:`run_on_ranks` runs a function
on N local processes joined by a gloo group (the CPU tests' stand-in for
N cards) and returns what each rank returned.  A spawned process imports
only what the function's module imports, so keep such functions in a
module that needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import socket
import traceback
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.ops.fused_sampling import prng_key

__all__ = ["set_random_seed", "initialize_distributed", "standalone_gpt",
           "standalone_bert", "random_token_batch", "run_on_ranks",
           "without_mesh"]


def set_random_seed(seed: int) -> torch.Tensor:
    """Seed numpy and torch; returns the threefry key of ``seed``
    (``jax.random.PRNGKey(seed)``'s words)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return prng_key(seed)


def initialize_distributed(tensor_model_parallel_size: int = 1,
                           pipeline_model_parallel_size: int = 1, *,
                           device=None, **kw):
    """``torch.distributed`` from the environment (or a world of one;
    :func:`~apex_tpu_torch.parallel.launch.init_distributed`), then the
    mesh."""
    from apex_tpu_torch.parallel.launch import init_distributed

    init_distributed(device=device)
    return mesh_lib.initialize_mesh(
        tensor_model_parallel_size=tensor_model_parallel_size,
        pipeline_model_parallel_size=pipeline_model_parallel_size, **kw)


@contextlib.contextmanager
def without_mesh():
    """Build models with whole weights inside, whatever mesh is current."""
    saved = mesh_lib._CURRENT_MESH
    mesh_lib._CURRENT_MESH = None
    try:
        yield
    finally:
        mesh_lib._CURRENT_MESH = saved


def _standalone(model_cls, cfg, seed, device, state_dict):
    from apex_tpu_torch.models.jax_import import shard_state_dict
    from apex_tpu_torch.transformer.layers import tensor_parallel

    if state_dict is None:
        with without_mesh():
            whole = model_cls(cfg, device=device)
            whole.init_weights(torch.Generator(
                device=whole.device).manual_seed(seed))
        state_dict = whole.state_dict()
    _, tp, rank = tensor_parallel()
    model = model_cls(cfg, device=device)
    experts = (0, 1)
    if getattr(cfg, "num_moe_experts", None):
        _, n, r = tensor_parallel(cfg.moe_expert_axis)
        experts = (r, n)
    model.load_state_dict(shard_state_dict(state_dict, rank, tp,
                                           experts=experts))
    return model


def standalone_gpt(seed: int = 0, *, device=None, state_dict=None,
                   **cfg_kw):
    """Tiny GPT (``GPTConfig.tiny(**cfg_kw)``) holding this rank's shard
    of the whole weights ``state_dict`` (default: drawn from ``seed``)."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

    return _standalone(GPTModel, GPTConfig.tiny(**cfg_kw), seed, device,
                       state_dict)


def standalone_bert(seed: int = 0, *, device=None, state_dict=None,
                    **cfg_kw):
    """Tiny BERT, as :func:`standalone_gpt`."""
    from apex_tpu_torch.models.bert import BertConfig, BertModel

    return _standalone(BertModel, BertConfig.tiny(**cfg_kw), seed, device,
                       state_dict)


def random_token_batch(seed: int, batch: int, seq: int, vocab: int,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(input_ids, labels)`` for LM tests, labels the inputs shifted
    left, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=g)
    ids = ids.to(device) if device is not None else ids
    return ids[:, :-1], ids[:, 1:]


# --------------------------------------------------------------------- #
# N processes on one host
# --------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy() if x.dtype != torch.bfloat16 \
            else x.detach().float().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _child(rank, world, port, fn, args, queue):
    from apex_tpu_torch.parallel.launch import (
        destroy_distributed,
        init_distributed,
    )

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        init_distributed(device="cpu")
        queue.put((rank, True, _to_host(fn(rank, world, *args))))
    except BaseException:           # the parent raises it
        queue.put((rank, False, traceback.format_exc()))
    finally:
        destroy_distributed()


def run_on_ranks(fn: Callable, world_size: int, *args: Any,
                 timeout: float = 300.0) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned
    processes joined by a gloo group (``torch.distributed`` initialized
    from ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` on
    localhost); returns each rank's result, tensors as numpy arrays.
    ``fn`` must be a module-level function; a rank's exception is raised
    here with its traceback.  A free port can be taken by another process
    between the probe and the rendezvous: such a start is retried on a
    new port."""
    for attempt in range(3):
        try:
            return _run_once(fn, world_size, args, timeout)
        except RuntimeError as e:
            if "address already in use" not in str(e).lower() \
                    or attempt == 2:
                raise


def _run_once(fn, world_size, args, timeout):
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, world_size, port, fn, args,
                                              queue), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: List[Optional[Any]] = [None] * world_size
    errors = []
    try:
        for _ in range(world_size):
            rank, ok, value = queue.get(timeout=timeout)
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("run_on_ranks: " + "\n".join(errors))
    return results
