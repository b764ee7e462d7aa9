"""apex_tpu_torch.transformer.pipeline_parallel — the microbatch pipeline
engine on ``torch.distributed`` (counterpart of
``apex_tpu.transformer.pipeline_parallel``; reference
``apex/transformer/pipeline_parallel/``): the schedules in
:mod:`.schedules`, point-to-point exchange in :mod:`.p2p`, stage
building in :mod:`.build`.
"""

from apex_tpu_torch.transformer.pipeline_parallel.build import build_model
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    spmd_pipeline,
    spmd_pipeline_interleaved,
    forward_backward_no_pipelining,
    forward_backward_pipelining_without_interleaving,
    forward_backward_pipelining_with_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel import p2p

__all__ = [
    "build_model",
    "spmd_pipeline",
    "spmd_pipeline_interleaved",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "get_forward_backward_func",
    "p2p",
]
