"""Parallel layers of the port: SyncBatchNorm on one card."""

from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm_stats,
)

__all__ = ["SyncBatchNorm", "convert_syncbn_model", "sync_batch_norm_stats"]
