"""Process-group bootstrap — the reference's launcher conventions.

Counterpart of ``apex_tpu/parallel/launch.py``: :func:`init_distributed`
reads the environment ``torch.distributed.launch`` / ``torchrun`` and
apex's ``multiproc`` set (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK``
/ ``WORLD_SIZE``), or explicit arguments, and initializes
``torch.distributed`` with NCCL for CUDA devices and gloo for
``device="cpu"``.

A single process with none of them set still gets a process group: a
world of one, rendezvoused through a file store in a fresh temporary
directory, so that the port's collectives run (and move nothing) without
a TCP port.  :func:`destroy_distributed` tears the group down.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib

__all__ = ["init_distributed", "is_distributed", "destroy_distributed"]

_INITIALIZED = False


def is_distributed() -> bool:
    """True once :func:`init_distributed` has initialized a process
    group (a world of one included) and until
    :func:`destroy_distributed`."""
    return _INITIALIZED


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """Initialize ``torch.distributed``; returns True for a world of more
    than one process, False for the single-process world of one.

    Each field comes from the explicit argument, else the environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With no
    coordinator and a world size absent or 1, the process runs a world
    of one on a file store.  A partial setting (say ``WORLD_SIZE`` and
    ``RANK`` without ``MASTER_ADDR``) raises ``ValueError`` naming what
    is missing.  The backend is NCCL, or gloo for ``device="cpu"``.
    Call once, before building a mesh.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return dist.get_world_size() > 1
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr:
            port = os.environ.get("MASTER_PORT", "29500")
            coordinator_address = f"{addr}:{port}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    backend = "gloo" if str(device or "cuda").startswith("cpu") else "nccl"

    if coordinator_address is None and num_processes in (None, 1):
        # one process: a world of one on a file store (no TCP port)
        path = os.path.join(tempfile.mkdtemp(prefix="apex_tpu_torch_pg_"),
                            "store")
        store = dist.FileStore(path, 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        _INITIALIZED = True
        return False

    missing = [n for n, v in (("MASTER_ADDR", coordinator_address),
                              ("WORLD_SIZE", num_processes),
                              ("RANK", process_id)) if v is None]
    if missing:
        raise ValueError(
            f"init_distributed: {' and '.join(missing)} unresolved — set "
            f"the named environment variable(s) or pass coordinator_"
            f"address / num_processes / process_id explicitly")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        rank=int(process_id), world_size=int(num_processes))
    _INITIALIZED = True
    return int(num_processes) > 1


def destroy_distributed() -> None:
    """Forget the current mesh and destroy the process group (and every
    group made from it)."""
    global _INITIALIZED
    mesh_lib.destroy_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False
