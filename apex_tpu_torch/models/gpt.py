"""GPT — decoder-only language model.

Counterpart of ``apex_tpu/models/gpt.py``: token embedding (plus learned
absolute positions for GPT-2-style configs), the stacked transformer,
the final norm and a tied or untied vocabulary head.  Without a cache
the forward runs the full sequence with causal flash attention (the JAX
module's ``decode=False``, the training forward); with one it is the
decode-mode forward: it runs ``input_ids`` against the KV cache, writes
their K/V and advances the cache index.  Logits ``(batch, seq, vocab)``
in ``cfg.dtype`` either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from apex_tpu_torch.models.transformer import (
    DecodeStep,
    Norm,
    ParallelTransformer,
    TransformerConfig,
    dropout_seeds,
    init_module_weights,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.xentropy import mean_cross_entropy
from apex_tpu_torch.ops.rope import rope_cos_sin
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    VocabParallelEmbedding,
)

__all__ = ["GPTConfig", "GPTModel", "gpt_loss_fn"]


@dataclasses.dataclass(frozen=True)
class GPTConfig(TransformerConfig):
    """GPT presets (reference workload: GPT-2 1.3B)."""

    tie_embeddings: bool = True

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("max_seq_len", 256)
        return cls(**kw)

    @classmethod
    def gpt2_1p3b(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 50304)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("max_seq_len", 2048)
        kw.setdefault("position_embedding", "learned")
        return cls(**kw)


class GPTModel(nn.Module):
    """Decoder-only LM on ``device`` (default ``"cuda"``; raises when
    CUDA is unavailable unless ``device="cpu"``).  Parameters are
    allocated uninitialized: load a state dict
    (:func:`~apex_tpu_torch.models.jax_import.params_from_jax`) or call
    :meth:`init_weights`."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=dev)
        if cfg.position_embedding == "learned":
            self.position_embedding = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=cfg.param_dtype,
                device=dev))
        else:
            self.register_parameter("position_embedding", None)
        self.transformer = ParallelTransformer(cfg, dev)
        self.final_norm = Norm(cfg, dev)
        self.lm_head = None if cfg.tie_embeddings else ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, use_bias=False,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=dev)
        if cfg.position_embedding == "rope":
            cos, sin = rope_cos_sin(cfg.max_seq_len, cfg.rot_dim,
                                    base=cfg.rope_base, device=dev)
        else:
            cos = sin = torch.empty(0, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (on the model's device):
        normal embeddings (std 0.02), fan-in-scaled linears, unit
        norms with zero bias."""
        init_module_weights(self, generator)
        if self.position_embedding is not None:
            with torch.no_grad():
                self.position_embedding.normal_(0.0, 0.02,
                                                generator=generator)

    def forward(self, input_ids, *, cache=None, kv_len: Optional[int] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        """Logits of ``input_ids`` (b, s).

        Without ``cache``: the full sequence, causal (``deterministic=
        False`` with an integer ``dropout_seed`` turns the config's
        dropouts on).  With ``cache`` (from :func:`~apex_tpu_torch.
        models.generate.init_cache`): decode, each row at its own cache
        index; ``kv_len`` bounds the cache slots any row can see after
        this call (``max(index) + s``; default the whole cache)."""
        if cache is None:
            return self._full(input_ids, deterministic, dropout_seed)
        cfg = self.cfg
        b, s = input_ids.shape
        index = cache["index"]
        positions = index[:, None].long() + torch.arange(
            s, device=input_ids.device)
        clamped = positions.clamp(max=cfg.max_seq_len - 1)
        step = DecodeStep(index=index.long(), positions=positions,
                          kv_len=int(kv_len or cfg.max_seq_len))
        if cfg.position_embedding == "rope":
            step.cos = self.rope_cos[clamped]
            step.sin = self.rope_sin[clamped]
        x = self.embedding(input_ids)
        if self.position_embedding is not None:
            x = x + self.position_embedding[clamped].to(x.dtype)
        x = x.to(cfg.dtype)
        x = self.transformer(x, cache, step)
        index += s
        return self._head(x)

    def _head(self, x):
        x = self.final_norm(x).to(self.cfg.dtype)
        if self.lm_head is None:
            return self.embedding.attend(x)
        return self.lm_head(x)

    def _full(self, input_ids, deterministic, dropout_seed):
        cfg = self.cfg
        s = input_ids.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        x = self.embedding(input_ids)
        if self.position_embedding is not None:
            x = x + self.position_embedding[None, :s].to(x.dtype)
        x = x.to(cfg.dtype)
        rope = None
        if cfg.position_embedding == "rope":
            rope = (self.rope_cos[:s], self.rope_sin[:s])
        x = self.transformer(x, rope=rope, seeds=dropout_seeds(
            cfg, deterministic, dropout_seed))
        return self._head(x)


def gpt_loss_fn(logits, labels, *, ignore_index: int = -100):
    """Next-token CE averaged over valid tokens (fp32)."""
    return mean_cross_entropy(logits, labels, ignore_index=ignore_index)
