"""Llama-family decoders (RMSNorm + RoPE + SwiGLU + GQA).

Counterpart of ``apex_tpu/models/llama.py``: presets over the shared
:class:`~apex_tpu_torch.models.gpt.GPTModel` core — untied head,
RMSNorm, half-rotation RoPE, gated SiLU MLP, no linear biases; Mistral
adds GQA and a 4096-token sliding window, Mixtral 8 SwiGLU experts
under top-2 routing.
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
    def mistral_7b(cls, **kw) -> "LlamaConfig":
        """Mistral-7B: the llama recipe + GQA (8 kv heads) + 4096-token
        sliding-window attention (the flash kernel's banded grid; in
        decode a ring cache of 4096 slots)."""
        kw.setdefault("layernorm_eps", 1e-5)
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("hidden_size", 4096)
        kw.setdefault("num_layers", 32)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("ffn_hidden_size", 14336)
        kw.setdefault("max_seq_len", 8192)
        kw.setdefault("sliding_window", 4096)
        return cls(**kw)

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "LlamaConfig":
        """Mixtral-8x7B: the mistral_7b recipe with every dense MLP
        replaced by 8 SwiGLU experts under top-2 token-choice routing
        (sliding window included).  Add :func:`~apex_tpu_torch.models.
        moe_aux_loss` of the model to the task loss.

        ``moe_capacity_factor`` defaults to the *drop-free* value
        ``num_experts / top_k`` (= 4.0): per-expert capacity is
        ``cf·S·k/E`` tokens, so cf = E/k makes capacity = S and no
        routing assignment can ever be dropped.  HF Mixtral has no
        capacity bound at all — with the training default (1.25) an
        imbalanced real checkpoint drops assignments and the combine
        renormalization silently diverges from HF.

        The parity default costs memory: the dispatch/combine masks
        are ``(S, E, C)`` fp32 per batch row with ``C = cf·S·k/E``,
        so cf = 4.0 makes them quadratic in sequence length — 3.2x
        the 1.25 default, transiently per MoE layer.  Training from
        scratch (where HF parity is irrelevant and token drop is
        routine) should pass a tighter ``moe_capacity_factor``
        explicitly; imported-checkpoint inference should keep the
        drop-free default."""
        kw.setdefault("num_moe_experts", 8)
        kw.setdefault("moe_top_k", 2)
        # num_moe_experts=None is the dense twin of the preset; bad
        # values (top_k=0) go straight to config validation
        if kw["num_moe_experts"] and kw["moe_top_k"]:
            kw.setdefault("moe_capacity_factor",
                          kw["num_moe_experts"] / kw["moe_top_k"])
        return cls.mistral_7b(**kw)

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
