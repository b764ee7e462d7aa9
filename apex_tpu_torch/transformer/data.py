"""Tokenized-batch distribution within the tensor-parallel group.

Counterpart of ``apex_tpu/transformer/data.py`` (reference
``apex/transformer/tensor_parallel/data.py``): ``broadcast_data(keys,
data, datatype)`` hands every tensor rank the batch that tensor rank 0
holds.  Where the JAX package places the batch replicated over the
model axes, this is upstream Apex's collective: rank 0 of each tensor
group checks the batch (every key present, every tensor of
``datatype``), packs it into one flat buffer and ``dist.broadcast``\\ s
it over the group; the other ranks pass the same keys (their tensors
give the shapes, their values are replaced).  The buffer travels on
the mesh's device (CUDA under NCCL, as upstream's ``.cuda()``), and the
tensors come back there.  A tensor group of one moves nothing: the
checked tensors come back as they are.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import TENSOR_AXIS

__all__ = ["broadcast_data"]


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype, *, axis: str = TENSOR_AXIS
                   ) -> Dict[str, torch.Tensor]:
    """``{key: tensor}`` for ``keys``, equal on every rank of the
    ``axis`` group to what its first rank passed.

    Raises ``KeyError`` for a missing key and ``TypeError`` for a tensor
    whose dtype is not ``datatype``, as the JAX function does.  Every
    rank of the group must call it with tensors of the same shapes.
    """
    out = {}
    for k in keys:
        if k not in data:
            raise KeyError(f"broadcast_data: missing key {k!r}")
        t = torch.as_tensor(data[k])
        if t.dtype != datatype:
            raise TypeError(
                f"broadcast_data: key {k!r} has dtype {t.dtype}, "
                f"expected {datatype}")
        out[k] = t
    mesh = mesh_lib.get_mesh()
    if mesh.axis_size(axis) == 1:
        return out
    flat = torch.cat([out[k].reshape(-1) for k in keys]).to(mesh.device)
    dist.broadcast(flat, src=mesh.line(axis)[0], group=mesh.group(axis))
    off = 0
    for k in keys:
        n = out[k].numel()
        out[k] = flat[off:off + n].view(out[k].shape)
        off += n
    return out
