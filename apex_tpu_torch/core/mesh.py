"""The parallel layout of the processes — a mesh of ranks.

Counterpart of ``apex_tpu/core/mesh.py``.  The JAX package names the
axes of one device mesh and reduces over an axis name; here the world
of ``torch.distributed`` ranks is laid out as the same mesh

    ``("data", "fsdp", "pipe", "context", "tensor")``  (:data:`AXIS_ORDER`)

with ``tensor`` innermost (neighbouring ranks, one NVLink island on a
node), and every axis — or set of axes — has one process group per line
of the mesh: the ranks that differ only in their coordinates along those
axes.  :meth:`Mesh.group` hands out the group this rank belongs to, so a
collective "over the tensor axis" is a collective on that group.

Groups are made by ``torch.distributed.new_group``, which every rank
must call for every group in the same order: :func:`initialize_mesh`
makes one group per axis at once, and :meth:`Mesh.group` makes a group
over several axes at its first request, which must then be made on
every rank (the layers and optimizers of the port ask for their groups
as they are built, on every rank alike).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "MeshConfig",
    "Mesh",
    "initialize_mesh",
    "get_mesh",
    "destroy_mesh",
    "mesh_is_initialized",
    "mesh_axis_size",
    "mesh_axis_rank",
    "group_of",
    "AXIS_ORDER",
    "DATA_AXIS",
    "FSDP_AXIS",
    "PIPE_AXIS",
    "TENSOR_AXIS",
    "CONTEXT_AXIS",
]

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
TENSOR_AXIS = "tensor"
CONTEXT_AXIS = "context"

#: outermost → innermost, as in the JAX package
AXIS_ORDER: Tuple[str, ...] = (
    DATA_AXIS, FSDP_AXIS, PIPE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

_CURRENT_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of the parallel axes (1 = unused); ``data=-1`` takes what
    the world size leaves (``world // (fsdp·pipe·context·tensor)``)."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    context: int = 1
    tensor: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        fixed = self.fsdp * self.pipe * self.context * self.tensor
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"fsdp*pipe*context*tensor={fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh size {total} != device count {n_devices} "
                f"(data={data}, fsdp={self.fsdp}, pipe={self.pipe}, "
                f"context={self.context}, tensor={self.tensor})")
        return dataclasses.replace(self, data=data)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.fsdp, self.pipe, self.context, self.tensor)


Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {a!r}; axes are "
                             f"{AXIS_ORDER}")
    return names


class Mesh:
    """The world's ranks laid out as ``config.shape`` over
    :data:`AXIS_ORDER` (``ranks``: the rank at each coordinate, the
    layout ``np.asarray(devices).reshape(shape)`` gives in the JAX
    package), seen from ``rank``."""

    def __init__(self, config: MeshConfig, rank: int):
        self.config = config
        self.axis_names = AXIS_ORDER
        self.ranks = np.arange(int(np.prod(config.shape))).reshape(
            config.shape)
        self.shape: Dict[str, int] = dict(zip(AXIS_ORDER, config.shape))
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)[0]
        self.coords: Dict[str, int] = {
            a: int(c) for a, c in zip(AXIS_ORDER, where)}
        self._groups: Dict[Tuple[str, ...], object] = {}
        #: the axes whose group has had its point-to-point communicator
        #: opened (``pipeline_parallel.p2p.connect``)
        self.p2p_opened: Set[str] = set()
        #: the axes over which an MoE layer built on this mesh holds a
        #: shard of its experts (``transformer.moe.MoEMLP``): its
        #: gradients are not replicas there
        self.expert_sharded: Set[str] = set()

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (a name or several)."""
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def axis_rank(self, axes: Axes) -> int:
        """This rank's index along ``axes`` — its rank in
        :meth:`group` ``(axes)``: the coordinates taken row-major in the
        order the axes are named."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def line(self, axes: Axes, at: Optional[Dict[str, int]] = None
             ) -> Tuple[int, ...]:
        """The ranks of the line along ``axes`` through the coordinates
        ``at`` (default: this rank's), in the order of :meth:`axis_rank`."""
        names = _axes(axes)
        at = self.coords if at is None else at
        index = tuple(slice(None) if a in names else at[a]
                      for a in AXIS_ORDER)
        kept = [a for a in AXIS_ORDER if a in names]
        sub = np.transpose(self.ranks[index],
                           [kept.index(a) for a in names])
        return tuple(int(r) for r in sub.reshape(-1))

    def group(self, axes: Axes):
        """This rank's process group along ``axes`` (made at the first
        request: a collective call, see the module docstring)."""
        names = _axes(axes)
        if names not in self._groups:
            self._groups[names] = self._new_groups(names)
        return self._groups[names]

    def host_group(self, axes: Axes):
        """This rank's gloo group along ``axes``, for host objects
        (``broadcast_object_list``): :meth:`group` itself under a gloo
        world, else one made at the first request (a collective call,
        as for :meth:`group`)."""
        if dist.get_backend() == "gloo":
            return self.group(axes)
        names = ("host",) + _axes(axes)
        if names not in self._groups:
            self._groups[names] = self._new_groups(names[1:],
                                                   backend="gloo")
        return self._groups[names]

    def _new_groups(self, names, backend=None):
        others = [a for a in AXIS_ORDER if a not in names]
        mine = None
        for coord in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            members = list(self.line(names, dict(zip(others, coord))))
            g = dist.new_group(members, backend=backend)
            if self.rank in members:
                mine = g
        return mine

    @property
    def device(self) -> torch.device:
        """Where this rank's collectives take their tensors: the current
        CUDA device under NCCL, the CPU under gloo."""
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def initialize_mesh(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    *,
    fsdp_size: int = 1,
    context_parallel_size: int = 1,
    data_parallel_size: int = -1,
    set_current: bool = True,
) -> Mesh:
    """Lay the world out as a mesh (``initialize_model_parallel``) and
    make one process group per axis line; a collective call.  Needs
    ``torch.distributed`` initialized
    (:func:`apex_tpu_torch.parallel.launch.init_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized — call "
            "apex_tpu_torch.parallel.launch.init_distributed() first")
    cfg = MeshConfig(
        data=data_parallel_size,
        fsdp=fsdp_size,
        pipe=pipeline_model_parallel_size,
        context=context_parallel_size,
        tensor=tensor_model_parallel_size,
    ).resolved(dist.get_world_size())
    mesh = Mesh(cfg, dist.get_rank())
    for a in AXIS_ORDER:
        mesh.group(a)
    if set_current:
        global _CURRENT_MESH
        _CURRENT_MESH = mesh
    return mesh


def get_mesh() -> Mesh:
    """The current mesh (raises when none is initialized)."""
    if _CURRENT_MESH is None:
        raise RuntimeError(
            "mesh is not initialized — call "
            "apex_tpu_torch.core.mesh.initialize_mesh(...)")
    return _CURRENT_MESH


def mesh_is_initialized() -> bool:
    return _CURRENT_MESH is not None


def destroy_mesh() -> None:
    """Forget the current mesh (``destroy_model_parallel``); its groups
    go with ``torch.distributed.destroy_process_group``."""
    global _CURRENT_MESH
    _CURRENT_MESH = None


def mesh_axis_size(axis: Axes, mesh: Optional[Mesh] = None) -> int:
    """World size of one parallel axis (``get_*_parallel_world_size``)."""
    return (mesh or get_mesh()).axis_size(axis)


def group_of(axis):
    """The process group of ``axis``: a mesh axis name (or tuple of
    names) resolved on the current mesh, or a group passed through."""
    if isinstance(axis, (str, tuple)):
        return get_mesh().group(axis)
    return axis


def mesh_axis_rank(axis: Axes, mesh: Optional[Mesh] = None) -> int:
    """This process's coordinate along ``axis`` (``get_*_parallel_rank``);
    a host int, where the JAX package traces ``lax.axis_index``."""
    return (mesh or get_mesh()).axis_rank(axis)
