"""Parallel building blocks of the port: the process-group bootstrap,
data parallelism (DDP with half and int8 all-reduces), ZeRO-1/2 and
SyncBatchNorm across processes (counterpart of ``apex_tpu.parallel``;
the pipeline, ring attention and Ulysses come with ROADMAP.md item
10b)."""

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
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm_stats,
)

__all__ = ["DistributedDataParallel", "all_reduce_mean_grads", "replicate",
           "shard_batch", "ZeroConfig", "ZeroOptState", "all_gather_params",
           "distributed_fused_adam", "distributed_fused_lamb",
           "reduce_scatter_mean_grads", "zero_partition", "zero_unpartition",
           "init_distributed", "is_distributed", "destroy_distributed",
           "SyncBatchNorm", "convert_syncbn_model", "sync_batch_norm_stats"]
