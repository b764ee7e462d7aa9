"""Models of the port: GPT/Llama decoders (full sequence and dense
KV-cached decode) and the BERT encoder."""

from apex_tpu_torch.models.bert import BertConfig, BertModel, bert_mlm_loss_fn
from apex_tpu_torch.models.generate import (
    apply_decode,
    generate,
    init_cache,
    prefill_tokens,
    sample_logits,
)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, gpt_loss_fn
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
    "BertConfig", "BertModel", "bert_mlm_loss_fn",
    "GPTConfig", "GPTModel", "gpt_loss_fn", "LlamaConfig", "LlamaModel",
    "params_from_jax",
    "ParallelAttention", "ParallelMLP", "ParallelTransformer",
    "ParallelTransformerLayer", "TransformerConfig",
]
