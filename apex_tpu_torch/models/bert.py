"""BERT — the encoder of the repo's north-star workload.

Counterpart of ``apex_tpu/models/bert.py`` (``bert.py:64-140``): learned
positions and token types, the post-embedding LayerNorm, the
bidirectional pre-norm encoder (flash attention with an optional
key-padding bias from ``attention_mask``), the MLM head (gather of the
masked positions, dense, tanh-GELU, norm, tied decoder plus
``mlm_bias``) and the tanh pooler of ``[CLS]``.

Parameter names follow the flax module's (``emb_norm_scale``,
``mlm_norm``, ``mlm_dense``, ``pooler``, ...), so the amp norm filter
keeps the same leaves fp32 under O2, and
:func:`~apex_tpu_torch.models.jax_import.params_from_jax` maps a JAX
tree one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.models.transformer import (
    Norm,
    ParallelTransformer,
    TransformerConfig,
    dropout_seeds,
    init_module_weights,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.attention import mask_to_bias
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.xentropy import mean_cross_entropy
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    VocabParallelEmbedding,
)

__all__ = ["BertConfig", "BertModel", "bert_mlm_loss_fn"]


class _TypeRows(torch.autograd.Function):
    """``table[ids]`` for the token-type table, with the table's gradient
    ``one_hot(ids)^T dy`` as one product.  CUDA's embedding backward sums
    the 8192 uses of BERT's one token type (every id 0) in an order that
    changes from run to run (fault C-12: 10 of 30 reruns differed on an
    H100); the product's sum runs in a fixed order."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        hot = F.one_hot(ids.reshape(-1).long(), ctx.rows).to(dy.dtype)
        return None, hot.t() @ dy.reshape(-1, dy.shape[-1])


@dataclasses.dataclass(frozen=True)
class BertConfig(TransformerConfig):
    """BERT presets; bidirectional, learned positions."""

    causal: bool = False
    position_embedding: str = "learned"
    type_vocab_size: int = 2

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("max_seq_len", 128)
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw) -> "BertConfig":
        """The north-star config: BERT-Large (hidden 1024, 24 layers,
        16 heads, vocab 30528, 512 positions)."""
        kw.setdefault("vocab_size", 30528)
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("max_seq_len", 512)
        return cls(**kw)


class BertModel(nn.Module):
    """Encoder on ``device`` (default ``"cuda"``); returns
    ``(mlm_logits, pooled)``.  Parameters are allocated uninitialized:
    load a state dict or call :meth:`init_weights`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h, pdt = cfg.hidden_size, cfg.param_dtype
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, h, dtype=cfg.dtype, param_dtype=pdt, device=dev)
        self.position_embedding = nn.Parameter(torch.empty(
            cfg.max_seq_len, h, dtype=pdt, device=dev))
        if cfg.type_vocab_size:
            self.token_type_embedding = nn.Parameter(torch.empty(
                cfg.type_vocab_size, h, dtype=pdt, device=dev))
        else:
            self.register_parameter("token_type_embedding", None)
        self.emb_norm_scale = nn.Parameter(torch.ones(h, dtype=pdt,
                                                      device=dev))
        self.emb_norm_bias = nn.Parameter(torch.zeros(h, dtype=pdt,
                                                      device=dev))
        self.transformer = ParallelTransformer(cfg, dev)
        kw = dict(use_bias=True, dtype=cfg.dtype, param_dtype=pdt,
                  device=dev)
        self.mlm_dense = ColumnParallelLinear(h, h, **kw)
        self.mlm_norm = Norm(cfg, dev)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, dtype=pdt,
                                                 device=dev))
        self.pooler = ColumnParallelLinear(h, h, **kw)

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (on the model's device):
        normal tables (std 0.02), fan-in-scaled linears, unit norms,
        zero biases."""
        init_module_weights(self, generator)
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.02, generator=generator)
            if self.token_type_embedding is not None:
                self.token_type_embedding.normal_(0.0, 0.02,
                                                  generator=generator)
            self.emb_norm_scale.fill_(1.0)
            self.emb_norm_bias.zero_()
            self.mlm_bias.zero_()

    def forward(self, input_ids, *, token_type_ids=None, attention_mask=None,
                mlm_positions=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        """``input_ids`` (b, s); ``attention_mask`` (b, s), 1 = attend,
        0 = padding; ``mlm_positions`` (b, P) gathers the masked
        positions before the vocab projection.  ``mlm_logits`` is
        (b, P or s, vocab), ``pooled`` (b, hidden)."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embedding(input_ids)
        x = x + self.position_embedding[None, :s].to(x.dtype)
        if self.token_type_embedding is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + _TypeRows.apply(token_type_ids,
                                    self.token_type_embedding).to(x.dtype)
        # dtype None (O1) keeps fp32 here, as jnp's astype(None)
        act = cfg.dtype or torch.float32
        x = fused_layer_norm(x, self.emb_norm_scale, self.emb_norm_bias,
                             eps=cfg.layernorm_eps).to(act)
        mask_bias = None
        if attention_mask is not None:
            # (b, 1, 1, s) key padding: rides the flash kernel
            mask_bias = mask_to_bias(
                ~attention_mask[:, None, None, :].bool())
        x = self.transformer(x, mask_bias=mask_bias, seeds=dropout_seeds(
            cfg, deterministic, dropout_seed))
        x_mlm = x
        if mlm_positions is not None:
            idx = mlm_positions.long()[..., None].expand(
                -1, -1, x.shape[-1])
            x_mlm = torch.gather(x, 1, idx)
        hmid = F.gelu(self.mlm_dense(x_mlm), approximate="tanh")
        hmid = self.mlm_norm(hmid).to(act)
        logits = self.embedding.attend(hmid)
        logits = logits + self.mlm_bias.to(logits.dtype)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return logits, pooled


def bert_mlm_loss_fn(mlm_logits, labels, *, ignore_index: int = -100):
    """Masked-LM CE averaged over masked positions (fp32)."""
    return mean_cross_entropy(mlm_logits, labels, ignore_index=ignore_index)
