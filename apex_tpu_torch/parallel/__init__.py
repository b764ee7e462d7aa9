"""Parallel building blocks of the port: the process-group bootstrap,
data parallelism (DDP with half and int8 all-reduces), ZeRO-1/2,
SyncBatchNorm across processes, the pipeline train step and context
parallelism — ring attention and Ulysses (counterpart of
``apex_tpu.parallel``)."""

from apex_tpu_torch.parallel.ddp import (
    DistributedDataParallel,
    all_reduce_mean_grads,
    replicate,
    shard_batch,
)
from apex_tpu_torch.parallel.distributed_optim import (
    ZeroConfig,
    ZeroOptState,
    all_gather_params,
    distributed_fused_adam,
    distributed_fused_lamb,
    reduce_scatter_mean_grads,
    zero_partition,
    zero_unpartition,
)
from apex_tpu_torch.parallel.launch import (
    destroy_distributed,
    init_distributed,
    is_distributed,
)
from apex_tpu_torch.parallel.pipeline import (
    bubble_fraction,
    live_microbatches,
    local_stage,
    pipeline_state_layout,
    run_1f1b,
    schedule_ticks,
    stage_local_zero,
    stage_split,
    stage_unsplit,
    sync_grad_overflow,
    wrap_pipeline_step,
)
from apex_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
    virtual_ring_attention,
)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm_stats,
)
from apex_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_self_attention,
)

__all__ = ["DistributedDataParallel", "all_reduce_mean_grads", "replicate",
           "shard_batch", "ZeroConfig", "ZeroOptState", "all_gather_params",
           "distributed_fused_adam", "distributed_fused_lamb",
           "reduce_scatter_mean_grads", "zero_partition", "zero_unpartition",
           "init_distributed", "is_distributed", "destroy_distributed",
           "SyncBatchNorm", "convert_syncbn_model", "sync_batch_norm_stats",
           "bubble_fraction", "schedule_ticks", "live_microbatches",
           "stage_split", "stage_unsplit", "local_stage",
           "stage_local_zero", "pipeline_state_layout",
           "sync_grad_overflow", "run_1f1b", "wrap_pipeline_step",
           "ring_attention", "ring_self_attention", "virtual_ring_attention",
           "ulysses_attention", "ulysses_self_attention"]
