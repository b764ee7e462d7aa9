"""Multi-head attention modules over the flash kernels.

Counterpart of ``apex_tpu/ops/multihead_attn.py`` (apex's
``contrib.multihead_attn``: ``SelfMultiheadAttn`` and
``EncdecMultiheadAttn`` with their fused variants — self / encdec ×
bias × norm-add × mask).  Every variant is one module over
:func:`apex_tpu_torch.ops.attention.fused_attention` (kernels B-6 to
B-8 on the card): the projections are ``F.linear`` products in the
compute dtype, ``include_norm_add`` puts the fused LayerNorm (kernels B-1
and B-2) before the attention and adds the residual after it.  The
modules have no kernel of their own.

Parameters, under the JAX module's names: ``qkv_proj`` (a Linear of
``(3·H·d, E)``, rows in the ``(3, H, d)`` order of the JAX DenseGeneral
kernel ``(E, 3, H, d)``), ``q_proj`` and ``kv_proj`` (``(H·d, E)``,
``(2·H·d, E)``), ``out_proj``, and ``ln_scale`` / ``ln_bias`` under
``include_norm_add``; :func:`apex_tpu_torch.models.mha_params_from_jax`
carries a JAX module's parameters over.  Attention-probability dropout
takes an integer ``dropout_seed`` (as ``models.gpt`` does), which the
counter hash of the flash kernels turns into the JAX package's keep mask
for the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import fused_attention, mask_to_bias
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.transformer.layers import ColumnParallelLinear

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]


def _attention_bias(mask, key_padding_mask):
    """``mask`` / ``key_padding_mask`` as one additive fp32 bias.

    Torch/apex MHA conventions: a boolean mask marks masked positions with
    True and becomes the -1e30 bias of :func:`mask_to_bias`; a float mask
    is already an additive bias.  ``mask`` is ``(sq, sk)`` or ``(b, sq,
    sk)`` (broadcast over heads); ``key_padding_mask`` is ``(b, sk)``.
    """
    def to_bias(m):
        if m.dtype == torch.bool:
            return mask_to_bias(m)
        return m.float()

    bias = None
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
        bias = to_bias(mask)
    if key_padding_mask is not None:
        kp = to_bias(key_padding_mask[:, None, None, :])
        bias = kp if bias is None else bias + kp
    return bias


class _MHABase(nn.Module):
    def __init__(self, embed_dim, num_heads, bias, include_norm_add, dropout,
                 dtype, param_dtype, device, implementation):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide embed_dim "
                             f"({embed_dim})")
        self.embed_dim, self.num_heads = int(embed_dim), int(num_heads)
        self.head_dim = embed_dim // num_heads
        self.use_bias, self.include_norm_add = bool(bias), include_norm_add
        self.dropout, self.dtype = float(dropout), dtype
        self.implementation = implementation
        self._dev, self._pdt = resolve_device(device), param_dtype
        if include_norm_add:
            self.ln_scale = nn.Parameter(torch.ones(
                embed_dim, dtype=param_dtype, device=self._dev))
            self.ln_bias = nn.Parameter(torch.zeros(
                embed_dim, dtype=param_dtype, device=self._dev))
        self.out_proj = self._linear(embed_dim, embed_dim)

    def _linear(self, n_in, n_out):
        """``F.linear`` in the compute dtype, weight ``(out, in)`` and
        bias cast to it, as flax's Dense / DenseGeneral with ``dtype``:
        whole weights on any mesh (``axis=None``), as the JAX modules'."""
        lin = ColumnParallelLinear(n_in, n_out, use_bias=self.use_bias,
                                   param_dtype=self._pdt, device=self._dev,
                                   axis=None)
        lin.init_weights()
        return lin

    def _norm(self, x):
        if not self.include_norm_add:
            return x
        return fused_layer_norm(x, self.ln_scale, self.ln_bias,
                                implementation=self.implementation)

    def _heads(self, t, parts):
        """``(b, s, parts·H·d)`` → ``parts`` tensors of ``(b, s, H, d)``."""
        b, s, _ = t.shape
        t = t.view(b, s, parts, self.num_heads, self.head_dim)
        return [t[:, :, i] for i in range(parts)]

    def _attend(self, q, k, v, causal, mask, key_padding_mask,
                deterministic, dropout_seed, residual):
        drop = self.dropout if (self.dropout > 0.0
                                and not deterministic) else 0.0
        if drop > 0.0 and dropout_seed is None:
            raise ValueError(
                f"{type(self).__name__}: dropout {self.dropout} with "
                "deterministic=False needs an integer dropout_seed")
        o = fused_attention(
            q, k, v, causal=causal,
            bias=_attention_bias(mask, key_padding_mask),
            dropout_rate=drop,
            dropout_seed=dropout_seed if drop > 0.0 else None,
            implementation=self.implementation)
        out = self.out_proj(o.reshape(*o.shape[:-2], self.embed_dim))
        if self.include_norm_add:
            out = out + residual.to(out.dtype)
        return out


class SelfMultiheadAttn(_MHABase):
    """Self-attention block (``apex.contrib.multihead_attn.
    SelfMultiheadAttn``); input and output ``(batch, seq, embed)``.

    ``include_norm_add``: LayerNorm before and the residual add after the
    attention.  ``dtype``: the compute dtype (default: the input's);
    ``implementation`` is handed to the attention and the LayerNorm.
    """

    def __init__(self, embed_dim: int, num_heads: int, *, bias: bool = False,
                 include_norm_add: bool = False, causal: bool = False,
                 dropout: float = 0.0, dtype=None,
                 param_dtype=torch.float32, device=None,
                 implementation: Optional[str] = None):
        super().__init__(embed_dim, num_heads, bias, include_norm_add,
                         dropout, dtype, param_dtype, device, implementation)
        self.causal = causal
        self.qkv_proj = self._linear(embed_dim, 3 * embed_dim)

    def forward(self, x, *, mask=None, key_padding_mask=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        dtype = self.dtype or x.dtype
        h = self._norm(x).to(dtype)
        q, k, v = self._heads(self.qkv_proj(h), 3)
        return self._attend(q, k, v, self.causal, mask, key_padding_mask,
                            deterministic, dropout_seed, x)


class EncdecMultiheadAttn(_MHABase):
    """Encoder-decoder attention (``EncdecMultiheadAttn``): queries from
    the decoder stream ``query`` ``(b, sq, E)``, keys and values from the
    encoder's ``key_value`` ``(b, sk, E)``."""

    def __init__(self, embed_dim: int, num_heads: int, *, bias: bool = False,
                 include_norm_add: bool = False, dropout: float = 0.0,
                 dtype=None, param_dtype=torch.float32, device=None,
                 implementation: Optional[str] = None):
        super().__init__(embed_dim, num_heads, bias, include_norm_add,
                         dropout, dtype, param_dtype, device, implementation)
        self.q_proj = self._linear(embed_dim, embed_dim)
        self.kv_proj = self._linear(embed_dim, 2 * embed_dim)

    def forward(self, query, key_value, *, mask=None, key_padding_mask=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        dtype = self.dtype or query.dtype
        h = self._norm(query).to(dtype)
        (q,) = self._heads(self.q_proj(h), 1)
        k, v = self._heads(self.kv_proj(key_value.to(dtype)), 2)
        return self._attend(q, k, v, False, mask, key_padding_mask,
                            deterministic, dropout_seed, query)
