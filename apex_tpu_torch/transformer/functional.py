"""Reference-named fused functionals of ``apex_tpu.transformer.functional``.

``FusedScaleMaskSoftmax`` — Megatron's attention-score softmax, whose
``AttnMaskType`` picks the causal (upper-triangular) fill or an explicit
padding mask — over :func:`apex_tpu_torch.ops.fused_scale_mask_softmax`
(kernels B-4 / B-5), and ``fused_apply_rotary_pos_emb*`` over
:func:`apex_tpu_torch.ops.fused_rope`.
"""

from __future__ import annotations

from typing import Optional

from apex_tpu_torch.ops.rope import fused_rope, rope_cos_sin
from apex_tpu_torch.ops.softmax import fused_scale_mask_softmax
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached"]


class FusedScaleMaskSoftmax:
    """Callable with the reference's constructor shape.

    ``attn_mask_type``: :class:`AttnMaskType` — ``causal`` applies the
    upper-triangular fill; ``padding`` takes an explicit boolean mask
    (True = masked) at call time.  ``scaled_masked_softmax_fusion=False``
    runs the plain composition (``implementation="torch"``) on any
    device; otherwise the kernel for a CUDA tensor.
    """

    def __init__(self, attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scale: Optional[float] = None,
                 scaled_masked_softmax_fusion: bool = True):
        self.attn_mask_type = attn_mask_type
        self.scale = 1.0 if scale is None else float(scale)
        self.fusion = scaled_masked_softmax_fusion

    def __call__(self, x, mask=None):
        return fused_scale_mask_softmax(
            x, mask, scale=self.scale,
            causal=(self.attn_mask_type == AttnMaskType.causal),
            implementation=None if self.fusion else "torch")


def fused_apply_rotary_pos_emb(t, cos=None, sin=None, *, base=10000.0):
    """RoPE with on-the-fly tables (``fused_apply_rotary_pos_emb``).

    ``t``: (batch, seq, heads, dim).  ``cos``/``sin`` optional
    precomputed ``(seq, dim/2)`` tables."""
    if cos is None or sin is None:
        cos, sin = rope_cos_sin(t.shape[1], t.shape[-1], base=base,
                                device=t.device)
    return fused_rope(t, cos, sin)


def fused_apply_rotary_pos_emb_cached(t, cos, sin):
    """RoPE with caller-cached cos/sin tables (the reference's
    ``_cached`` variant; identical math, tables reused across layers)."""
    return fused_rope(t, cos, sin)
