"""Llama-family decoders (RMSNorm + RoPE + SwiGLU + GQA).

Counterpart of ``apex_tpu/models/llama.py``: presets over the shared
:class:`~apex_tpu_torch.models.gpt.GPTModel` core — untied head,
RMSNorm, half-rotation RoPE, gated SiLU MLP, no linear biases.  The
sliding-window presets (Mistral, Mixtral) come with ROADMAP.md A-4.
"""

from __future__ import annotations

import dataclasses

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["LlamaConfig", "LlamaModel"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig(GPTConfig):
    """Llama architecture defaults over the shared transformer config."""

    norm: str = "rmsnorm"
    position_embedding: str = "rope"
    activation: str = "silu"
    gated_mlp: bool = True
    add_bias_linear: bool = False
    tie_embeddings: bool = False
    rope_base: float = 10000.0
    layernorm_eps: float = 1e-6

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test size (GQA: 4 query heads over 2 kv heads)."""
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("ffn_hidden_size", 512)
        kw.setdefault("max_seq_len", 256)
        return cls(**kw)

    @classmethod
    def llama_1b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("num_layers", 20)
        kw.setdefault("num_heads", 16)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("ffn_hidden_size", 5632)
        kw.setdefault("max_seq_len", 2048)
        return cls(**kw)

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("layernorm_eps", 1e-5)
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("hidden_size", 4096)
        kw.setdefault("num_layers", 32)
        kw.setdefault("num_heads", 32)
        kw.setdefault("ffn_hidden_size", 11008)
        kw.setdefault("max_seq_len", 4096)
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("layernorm_eps", 1e-5)
        kw.setdefault("vocab_size", 128256)
        kw.setdefault("hidden_size", 4096)
        kw.setdefault("num_layers", 32)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("ffn_hidden_size", 14336)
        kw.setdefault("max_seq_len", 8192)
        kw.setdefault("rope_base", 500000.0)
        return cls(**kw)


# the Llama architecture is GPTModel under the Llama config: the module
# tree (and so the state dict layout) is the same
LlamaModel = GPTModel
