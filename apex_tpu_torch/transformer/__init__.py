"""Transformer building blocks of the port (single-device layers)."""

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
from apex_tpu_torch.transformer import moe
from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType",
           "FusedScaleMaskSoftmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding", "moe",
           "MoEConfig", "MoEMLP"]
