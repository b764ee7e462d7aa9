"""Megatron's ``parallel_state`` API over the port's mesh.

Counterpart of ``apex_tpu/transformer/parallel_state.py`` (reference:
``apex/transformer/parallel_state.py``).  Each "group" is the process
group of a mesh axis (:meth:`apex_tpu_torch.core.mesh.Mesh.group`), so
the accessors return its size, this process's rank in it (a host int,
where the JAX package traces ``lax.axis_index``), its axis name, or the
group itself for a collective.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    TENSOR_AXIS,
)

__all__ = [
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "destroy_model_parallel",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size",
    "get_context_parallel_world_size",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "get_context_parallel_rank",
    "get_tensor_model_parallel_axis",
    "get_pipeline_model_parallel_axis",
    "get_data_parallel_axis",
    "get_tensor_model_parallel_group",
    "get_pipeline_model_parallel_group",
    "get_data_parallel_group",
    "get_context_parallel_group",
    "get_model_parallel_group",
    "get_amax_reduction_group",
    "is_pipeline_first_stage",
    "is_pipeline_last_stage",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_amax_reduction_axes",
]

_VIRTUAL_PIPE_SIZE: Optional[int] = None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    *,
    context_parallel_size_: int = 1,
    fsdp_size_: int = 1,
    **kwargs,
):
    """Build the global mesh (the reference's signature)."""
    global _VIRTUAL_PIPE_SIZE
    _VIRTUAL_PIPE_SIZE = virtual_pipeline_model_parallel_size_
    return mesh_lib.initialize_mesh(
        tensor_model_parallel_size=tensor_model_parallel_size_,
        pipeline_model_parallel_size=pipeline_model_parallel_size_,
        context_parallel_size=context_parallel_size_,
        fsdp_size=fsdp_size_,
        **kwargs,
    )


def model_parallel_is_initialized() -> bool:
    """True iff a global mesh exists."""
    return mesh_lib.mesh_is_initialized()


def destroy_model_parallel() -> None:
    """Forget the global mesh and the virtual-pipeline size."""
    global _VIRTUAL_PIPE_SIZE
    _VIRTUAL_PIPE_SIZE = None
    mesh_lib.destroy_mesh()


# ------------------------- world sizes ------------------------------- #
def get_tensor_model_parallel_world_size() -> int:
    return mesh_lib.mesh_axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return mesh_lib.mesh_axis_size(PIPE_AXIS)


def get_data_parallel_world_size() -> int:
    """``data`` × ``fsdp``: the reference counts sharded-optimizer
    replicas in its data-parallel group."""
    return (mesh_lib.mesh_axis_size(DATA_AXIS)
            * mesh_lib.mesh_axis_size(FSDP_AXIS))


def get_context_parallel_world_size() -> int:
    return mesh_lib.mesh_axis_size(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPE_SIZE


# ------------------------- ranks -------------------------------------- #
def get_tensor_model_parallel_rank() -> int:
    return mesh_lib.mesh_axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return mesh_lib.mesh_axis_rank(PIPE_AXIS)


def get_data_parallel_rank() -> int:
    return mesh_lib.mesh_axis_rank(DATA_AXIS)


def get_context_parallel_rank() -> int:
    return mesh_lib.mesh_axis_rank(CONTEXT_AXIS)


def is_pipeline_first_stage() -> bool:
    return mesh_lib.mesh_axis_rank(PIPE_AXIS) == 0


def is_pipeline_last_stage() -> bool:
    return (mesh_lib.mesh_axis_rank(PIPE_AXIS)
            == mesh_lib.mesh_axis_size(PIPE_AXIS) - 1)


def get_amax_reduction_axes():
    """The axes an fp8 / int8 amax reduces over: every model-parallel
    axis plus data (the reference's amax-reduction group)."""
    return (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, CONTEXT_AXIS)


# ------------------------- groups ------------------------------------- #
def get_tensor_model_parallel_group():
    return mesh_lib.get_mesh().group(TENSOR_AXIS)


def get_pipeline_model_parallel_group():
    return mesh_lib.get_mesh().group(PIPE_AXIS)


def get_data_parallel_group():
    """The group over ``data`` × ``fsdp`` (see
    :func:`get_data_parallel_world_size`)."""
    return mesh_lib.get_mesh().group((DATA_AXIS, FSDP_AXIS))


def get_context_parallel_group():
    return mesh_lib.get_mesh().group(CONTEXT_AXIS)


def get_model_parallel_group():
    """The group over ``pipe`` × ``context`` × ``tensor``."""
    return mesh_lib.get_mesh().group((PIPE_AXIS, CONTEXT_AXIS, TENSOR_AXIS))


def get_amax_reduction_group():
    return mesh_lib.get_mesh().group(get_amax_reduction_axes())


# ------------------------- axis names --------------------------------- #
def get_tensor_model_parallel_axis() -> str:
    return TENSOR_AXIS


def get_pipeline_model_parallel_axis() -> str:
    return PIPE_AXIS


def get_data_parallel_axis() -> str:
    return DATA_AXIS
