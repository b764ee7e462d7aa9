"""Models of the port: GPT/Llama/Mistral/Mixtral decoders (full
sequence; dense, ring and paged KV-cached decode), the BERT encoder,
ViT, ResNet, and the importers of JAX and HF/torchvision checkpoints."""

from apex_tpu_torch.models.bert import BertConfig, BertModel, bert_mlm_loss_fn
from apex_tpu_torch.models.generate import (
    apply_decode,
    generate,
    init_cache,
    init_paged_cache,
    prefill_tokens,
    sample_logits,
)
from apex_tpu_torch.models.gpt import (
    GPTConfig,
    GPTModel,
    gpt_loss_fn,
    gpt_pipeline_forward_backward,
    moe_aux_loss,
)
from apex_tpu_torch.models.jax_import import (
    closure_params_from_jax,
    group_norm_params_from_jax,
    mha_params_from_jax,
    mlp_params_from_jax,
    named_leaves_from_jax,
    params_from_jax,
    resnet_params_from_jax,
    stage_params_from_jax,
)
from apex_tpu_torch.models.llama import LlamaConfig, LlamaModel
from apex_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    convert_stem_to_s2d,
    resnet18,
    resnet50,
    space_to_depth,
    stem_conv_to_s2d,
)
from apex_tpu_torch.models.torch_import import (
    load_torch_gpt2,
    load_torch_llama,
    load_torch_resnet,
)
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
)
from apex_tpu_torch.models.vit import ViTConfig, ViTModel

__all__ = [
    "apply_decode", "generate", "init_cache", "init_paged_cache", "prefill_tokens",
    "sample_logits",
    "BertConfig", "BertModel", "bert_mlm_loss_fn",
    "GPTConfig", "GPTModel", "gpt_loss_fn", "gpt_pipeline_forward_backward",
    "moe_aux_loss",
    "LlamaConfig", "LlamaModel", "ViTConfig", "ViTModel",
    "load_torch_gpt2", "load_torch_llama", "load_torch_resnet",
    "named_leaves_from_jax", "params_from_jax", "resnet_params_from_jax",
    "group_norm_params_from_jax", "mha_params_from_jax",
    "mlp_params_from_jax", "stage_params_from_jax",
    "closure_params_from_jax",
    "ResNet", "ResNetConfig", "convert_stem_to_s2d", "resnet18", "resnet50",
    "space_to_depth", "stem_conv_to_s2d",
    "ParallelAttention", "ParallelMLP", "ParallelTransformer",
    "ParallelTransformerLayer", "TransformerConfig",
]
