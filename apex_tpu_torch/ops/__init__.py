"""Fused ops of the port: CUDA kernels with plain PyTorch twins."""

from apex_tpu_torch.ops._dispatch import resolve_device, resolve_impl
from apex_tpu_torch.ops.attention import (
    attention_reference,
    dropout_keep_mask,
    fused_attention,
    mask_to_bias,
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
from apex_tpu_torch.ops.mlp import resolve_activation
from apex_tpu_torch.ops.rope import fused_rope, rope_cos_sin, rope_reference
from apex_tpu_torch.ops.xentropy import (
    mean_cross_entropy,
    softmax_cross_entropy,
    softmax_cross_entropy_reference,
)

__all__ = [
    "resolve_device", "resolve_impl",
    "attention_reference", "dropout_keep_mask", "fused_attention",
    "mask_to_bias",
    "fused_sample", "fused_sample_reference", "prng_key", "random_bits",
    "split",
    "fused_layer_norm", "fused_rms_norm", "layer_norm_reference",
    "rms_norm_reference",
    "resolve_activation",
    "fused_rope", "rope_cos_sin", "rope_reference",
    "mean_cross_entropy", "softmax_cross_entropy",
    "softmax_cross_entropy_reference",
]
