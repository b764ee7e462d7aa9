"""Decoder models of the port (dense KV-cached decode path)."""

from apex_tpu_torch.models.generate import (
    apply_decode,
    generate,
    init_cache,
    prefill_tokens,
    sample_logits,
)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.models.jax_import import params_from_jax
from apex_tpu_torch.models.llama import LlamaConfig, LlamaModel
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
)

__all__ = [
    "apply_decode", "generate", "init_cache", "prefill_tokens",
    "sample_logits",
    "GPTConfig", "GPTModel", "LlamaConfig", "LlamaModel",
    "params_from_jax",
    "ParallelAttention", "ParallelMLP", "ParallelTransformer",
    "ParallelTransformerLayer", "TransformerConfig",
]
