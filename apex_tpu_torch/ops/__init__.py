"""Fused ops of the port: CUDA kernels with plain PyTorch twins."""

from apex_tpu_torch.ops._dispatch import resolve_device, resolve_impl
from apex_tpu_torch.ops.attention import (
    attention_reference,
    dropout_keep_mask,
    fused_attention,
    mask_to_bias,
)
from apex_tpu_torch.ops.batch_norm import (
    batch_norm_inference,
    batch_norm_reference,
    batch_norm_train,
)
from apex_tpu_torch.ops.group_norm import (
    GroupNorm,
    group_norm,
    group_norm_reference,
)
from apex_tpu_torch.ops.fused_sampling import (
    fused_sample,
    fused_sample_reference,
    prng_key,
    random_bits,
    split,
)
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_rms_norm,
    layer_norm_reference,
    rms_norm_reference,
)
from apex_tpu_torch.ops.mlp import (
    MLP,
    FusedDense,
    FusedDenseGeluDense,
    fused_dense,
    resolve_activation,
)
from apex_tpu_torch.ops.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    paged_decode_fused,
    paged_decode_fused_reference,
)
from apex_tpu_torch.ops.rope import fused_rope, rope_cos_sin, rope_reference
from apex_tpu_torch.ops.softmax import (
    fused_scale_mask_softmax,
    scale_mask_softmax_reference,
)
from apex_tpu_torch.ops.xentropy import (
    mean_cross_entropy,
    softmax_cross_entropy,
    softmax_cross_entropy_reference,
)

__all__ = [
    "resolve_device", "resolve_impl",
    "attention_reference", "dropout_keep_mask", "fused_attention",
    "mask_to_bias",
    "batch_norm_inference", "batch_norm_reference", "batch_norm_train",
    "fused_sample", "fused_sample_reference", "prng_key", "random_bits",
    "split",
    "fused_layer_norm", "fused_rms_norm", "layer_norm_reference",
    "rms_norm_reference",
    "FusedDense", "FusedDenseGeluDense", "MLP", "fused_dense",
    "resolve_activation",
    "group_norm", "group_norm_reference", "GroupNorm",
    "SelfMultiheadAttn", "EncdecMultiheadAttn",
    "paged_attention", "paged_attention_reference", "paged_decode_fused",
    "paged_decode_fused_reference",
    "fused_rope", "rope_cos_sin", "rope_reference",
    "fused_scale_mask_softmax", "scale_mask_softmax_reference",
    "mean_cross_entropy", "softmax_cross_entropy",
    "softmax_cross_entropy_reference",
]
