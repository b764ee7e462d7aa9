"""Load HuggingFace / torchvision checkpoints into the port's models.

Counterpart of ``apex_tpu/models/torch_import.py``: the JAX importers
write a checkpoint into a flax tree; these build a ``state_dict`` for
the port's model of the same architecture, load it (``strict``) and
return it.

- :func:`load_torch_gpt2`: a ``GPT2LMHeadModel`` / ``GPT2Model`` state
  dict onto :class:`~apex_tpu_torch.models.GPTModel` (pre-LN, tied
  embeddings: the mapping is exact).  HF GPT-2's ``Conv1D`` weights are
  stored ``(in, out)`` and transposed to ``nn.Linear``'s ``(out, in)``.
- :func:`load_torch_llama`: a ``LlamaForCausalLM`` /
  ``MistralForCausalLM`` / ``MixtralForCausalLM`` state dict onto the
  Llama recipe (GQA included; Mixtral's ``block_sparse_moe`` router and
  per-expert ``w1`` / ``w3`` / ``w2`` land on ``moe_mlp``'s ``gate``,
  ``w1``, ``wg``, ``w2``).
- :func:`load_torch_resnet`: a torchvision bottleneck-ResNet state dict
  onto :class:`~apex_tpu_torch.models.ResNet` (either stem).

HF packs attention as a flat ``[q | k | v]`` output axis; the port's
``qkv_proj`` uses the Megatron per-kv-group layout ``[q_{g·rep} …
q_{g·rep+rep-1}, k_g, v_g]``, so the rows are permuted (unless the model
is built with ``qkv_grouped=False``).

BERT is deliberately not importable: HF BERT is post-LN while this
library's transformer (Megatron recipe) is pre-LN — a key-by-key weight
copy would silently compute a different function.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch
import torch.nn as nn

from apex_tpu_torch.models.resnet import stem_conv_to_s2d

__all__ = ["load_torch_gpt2", "load_torch_llama", "load_torch_resnet"]

_BERT = ("HF BERT is post-LN while this library's transformer (Megatron "
         "recipe) is pre-LN — a key-by-key weight copy would silently "
         "compute a different function.  Convert through a re-training "
         "or distillation step instead")


def _refuse_bert(model: nn.Module, sd: Mapping[str, Any]) -> None:
    if type(model).__name__.startswith("Bert") or any(
            k.startswith(("bert.", "encoder.layer.")) for k in sd):
        raise ValueError(f"BERT is not importable: {_BERT}")


def _qkv_flat_to_grouped(w: torch.Tensor, num_heads: int,
                         num_kv_heads: int) -> torch.Tensor:
    """Permute the rows (the output axis) of a flat ``[q | k | v]``
    weight or bias into the per-kv-group layout of ``qkv_proj``."""
    h, hk = num_heads, num_kv_heads
    rep = h // hk
    out = w.shape[0]
    if out % (h + 2 * hk):
        raise ValueError(
            f"qkv output dim {out} not divisible by num_heads+"
            f"2*num_kv_heads={h + 2 * hk}")
    d = out // (h + 2 * hk)
    q_idx = torch.arange(h * d).reshape(hk, rep, d)
    k_idx = (h * d + torch.arange(hk * d)).reshape(hk, 1, d)
    v_idx = ((h + hk) * d + torch.arange(hk * d)).reshape(hk, 1, d)
    perm = torch.cat([q_idx, k_idx, v_idx], dim=1).reshape(-1)
    return w[perm]


def _fetcher(sd: Mapping[str, Any]) -> Callable[[str], torch.Tensor]:
    def fetch(key: str) -> torch.Tensor:
        if key not in sd:
            raise KeyError(
                f"torch state dict is missing '{key}' (have e.g. "
                f"{sorted(sd)[:4]}...)")
        return torch.as_tensor(sd[key]).detach().cpu()
    return fetch


def _check_layer_count(n_ckpt: int, n_layers: int) -> None:
    if n_ckpt != n_layers:
        raise ValueError(
            f"torch checkpoint has {n_ckpt} layers but the model "
            f"has {n_layers} — refusing to silently truncate")


def _load(model: nn.Module, out: Dict[str, torch.Tensor]
          ) -> Dict[str, torch.Tensor]:
    model.load_state_dict(out, strict=True)
    return out


def load_torch_gpt2(model: nn.Module, state_dict: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """Load an HF GPT-2 state dict into ``model`` (a ``GPTModel`` with
    learned positions); returns the port's state dict.  The
    ``transformer.``-prefixed and unprefixed key forms both work.  An
    untied ``lm_head`` in the model takes ``lm_head.weight``."""
    _refuse_bert(model, state_dict)
    cfg = model.cfg
    sd = {(k[len("transformer."):] if k.startswith("transformer.") else k):
          v for k, v in state_dict.items()}
    fetch = _fetcher(sd)
    h, hk = cfg.num_heads, cfg.kv_heads

    def qkv(t):
        return _qkv_flat_to_grouped(t, h, hk) if cfg.qkv_grouped else t

    out = {"embedding.weight": fetch("wte.weight"),
           "final_norm.weight": fetch("ln_f.weight"),
           "final_norm.bias": fetch("ln_f.bias")}
    if cfg.position_embedding == "learned":
        wpe = fetch("wpe.weight")
        if wpe.shape[0] < cfg.max_seq_len:
            raise ValueError(
                f"torch wpe covers {wpe.shape[0]} positions < model "
                f"max_seq_len {cfg.max_seq_len}")
        out["position_embedding"] = wpe[:cfg.max_seq_len]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = fetch("lm_head.weight")
    n_ckpt = sum(1 for k in sd if k.endswith(".ln_1.weight"))
    _check_layer_count(n_ckpt, cfg.num_layers)
    for i in range(cfg.num_layers):
        src, dst = f"h.{i}.", f"transformer.layers.{i}."
        for a, b in (("ln_1", "input_norm"), ("ln_2", "post_attention_norm")):
            out[dst + b + ".weight"] = fetch(src + a + ".weight")
            out[dst + b + ".bias"] = fetch(src + a + ".bias")
        out[dst + "attention.qkv_proj.weight"] = qkv(
            fetch(src + "attn.c_attn.weight").T)
        out[dst + "attention.qkv_proj.bias"] = qkv(
            fetch(src + "attn.c_attn.bias"))
        for a, b in (("attn.c_proj", "attention.out_proj"),
                     ("mlp.c_fc", "mlp.dense_h_to_4h"),
                     ("mlp.c_proj", "mlp.dense_4h_to_h")):
            out[dst + b + ".weight"] = fetch(src + a + ".weight").T
            out[dst + b + ".bias"] = fetch(src + a + ".bias")
    return _load(model, out)


def load_torch_llama(model: nn.Module, state_dict: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """Load an HF ``LlamaForCausalLM`` / ``MistralForCausalLM`` /
    ``MixtralForCausalLM`` state dict into ``model`` (the Llama recipe:
    rmsnorm, rope, gated MLP, no biases); returns the port's state dict.

    The model's ``num_kv_heads`` must be the checkpoint's
    ``num_key_value_heads``.  Mixtral layers (their ``block_sparse_moe``
    keys) need a model built with ``num_moe_experts`` =
    ``num_local_experts`` and ``moe_top_k`` = ``num_experts_per_tok``;
    HF's softmax over the selected logits equals the port's
    softmax-then-renormalise.  HF Mixtral never drops a token, so logits
    agree only under a drop-free capacity, ``moe_capacity_factor >=
    num_experts / top_k`` (the ``mixtral_8x7b`` preset's default).
    """
    _refuse_bert(model, state_dict)
    cfg = model.cfg
    sd = dict(state_dict)
    fetch = _fetcher(sd)
    h, hk = cfg.num_heads, cfg.kv_heads
    out = {"embedding.weight": fetch("model.embed_tokens.weight"),
           "final_norm.weight": fetch("model.norm.weight")}
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = fetch("lm_head.weight")
    elif "lm_head.weight" in sd and not torch.equal(
            fetch("lm_head.weight"), out["embedding.weight"]):
        # state_dict() lists a tied head under both names: only a head
        # that differs from the embedding is an untied checkpoint
        raise ValueError(
            "checkpoint has an untied lm_head but the model ties "
            "embeddings — build it with tie_embeddings=False")
    ckpt_moe = any(".block_sparse_moe.gate.weight" in k for k in sd)
    if ckpt_moe != bool(cfg.num_moe_experts):
        raise ValueError(
            "checkpoint/model MLP form mismatch: the checkpoint "
            + ("has Mixtral block_sparse_moe layers — build the model "
               "with num_moe_experts=num_local_experts and "
               "moe_top_k=num_experts_per_tok" if ckpt_moe else
               "has dense MLP layers but the model was built with "
               "num_moe_experts"))
    n_ckpt = sum(1 for k in sd if k.endswith(".input_layernorm.weight"))
    _check_layer_count(n_ckpt, cfg.num_layers)
    for i in range(cfg.num_layers):
        src, dst = f"model.layers.{i}.", f"transformer.layers.{i}."
        qkv = torch.cat([fetch(src + f"self_attn.{n}_proj.weight")
                         for n in "qkv"], dim=0)
        out[dst + "attention.qkv_proj.weight"] = (
            _qkv_flat_to_grouped(qkv, h, hk) if cfg.qkv_grouped else qkv)
        out[dst + "attention.out_proj.weight"] = fetch(
            src + "self_attn.o_proj.weight")
        out[dst + "input_norm.weight"] = fetch(
            src + "input_layernorm.weight")
        out[dst + "post_attention_norm.weight"] = fetch(
            src + "post_attention_layernorm.weight")
        moe = src + "block_sparse_moe."
        if ckpt_moe:
            n_e = 0
            while moe + f"experts.{n_e}.w1.weight" in sd:
                n_e += 1
            if n_e == 0:
                raise KeyError(
                    f"checkpoint has '{moe}gate.weight' but no "
                    f"'{moe}experts.0.w1.weight' — unrecognized expert "
                    f"weight layout")
            out[dst + "moe_mlp.gate"] = fetch(moe + "gate.weight").T
            for a, b in (("w1", "w1"), ("w3", "wg"), ("w2", "w2")):
                out[dst + "moe_mlp." + b] = torch.stack(
                    [fetch(moe + f"experts.{j}.{a}.weight").T
                     for j in range(n_e)])
        else:
            for a, b in (("gate_proj", "dense_h_to_4h_gate"),
                         ("up_proj", "dense_h_to_4h"),
                         ("down_proj", "dense_4h_to_h")):
                out[dst + "mlp." + b + ".weight"] = fetch(
                    src + f"mlp.{a}.weight")
    return _load(model, out)


def load_torch_resnet(model: nn.Module, state_dict: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """Load a torchvision bottleneck-ResNet state dict into ``model`` (a
    :class:`~apex_tpu_torch.models.ResNet` whose ``stage_sizes`` match
    the checkpoint's ``layer{1..K}`` block counts); returns the port's
    state dict.  BN ``weight`` / ``bias`` / ``running_mean`` /
    ``running_var`` land on the port's ``weight`` / ``bias`` / ``mean``
    / ``var`` (torch tracks the Bessel-corrected variance, as the port
    does).  Under ``stem="s2d"`` the 7×7 ``conv1`` weight goes through
    :func:`~apex_tpu_torch.models.resnet.stem_conv_to_s2d`, so a standard
    checkpoint loads into either stem with the same logits."""
    cfg = model.cfg
    fetch = _fetcher(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def bn(src, dst):
        for a, b in (("weight", "weight"), ("bias", "bias"),
                     ("running_mean", "mean"), ("running_var", "var")):
            out[f"{dst}.{b}"] = fetch(f"{src}.{a}")

    w1 = fetch("conv1.weight")
    out["stem.weight"] = stem_conv_to_s2d(w1) if cfg.stem == "s2d" else w1
    bn("bn1", "bn_stem")
    for i, n in enumerate(cfg.stage_sizes):
        n_ckpt = sum(1 for k in state_dict
                     if k.startswith(f"layer{i + 1}.")
                     and k.endswith(".conv1.weight"))
        _check_layer_count(n_ckpt, n)
        for j in range(n):
            src, dst = f"layer{i + 1}.{j}", f"stage{i}_block{j}"
            for k in (1, 2, 3):
                out[f"{dst}.conv{k}.weight"] = fetch(f"{src}.conv{k}.weight")
                bn(f"{src}.bn{k}", f"{dst}.bn{k}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.downsample.weight"] = fetch(
                    f"{src}.downsample.0.weight")
                bn(f"{src}.downsample.1", f"{dst}.bn_down")
    out["fc.weight"] = fetch("fc.weight")
    out["fc.bias"] = fetch("fc.bias")
    return _load(model, out)
