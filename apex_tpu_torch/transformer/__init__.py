"""Transformer building blocks of the port: Megatron-style tensor and
sequence parallelism over the mesh's process groups (counterpart of
``apex_tpu.transformer``; the pipeline schedules, microbatches and data
broadcast come with ROADMAP.md item 10b)."""

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
from apex_tpu_torch.transformer import log_util
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer import moe
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import random
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
           "MoEConfig", "MoEMLP", "divide", "ensure_divisibility",
           "split_tensor_along_last_dim"]
