"""Transformer building blocks of the port: Megatron-style tensor,
sequence and pipeline parallelism over the mesh's process groups
(counterpart of ``apex_tpu.transformer``)."""

from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax,
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer import data
from apex_tpu_torch.transformer import functional
from apex_tpu_torch.transformer import log_util
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer import microbatches
from apex_tpu_torch.transformer import moe
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import pipeline_parallel
from apex_tpu_torch.transformer import random
from apex_tpu_torch.transformer.data import broadcast_data
from apex_tpu_torch.transformer.microbatches import (
    get_num_microbatches,
    setup_microbatch_calculator,
)
from apex_tpu_torch.transformer.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.utils import (
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType",
           "FusedScaleMaskSoftmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "column_parallel_linear", "row_parallel_linear",
           "vocab_parallel_embedding", "vocab_parallel_cross_entropy",
           "parallel_state", "mappings", "random", "log_util", "moe",
           "data", "functional", "microbatches", "pipeline_parallel",
           "broadcast_data", "setup_microbatch_calculator",
           "get_num_microbatches", "MoEConfig", "MoEMLP", "divide", "ensure_divisibility",
           "split_tensor_along_last_dim"]
