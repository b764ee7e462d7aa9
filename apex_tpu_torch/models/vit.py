"""ViT — the large-batch FusedLAMB workload (BASELINE.json configs[4]).

Counterpart of ``apex_tpu/models/vit.py``: a patch-embedding convolution
(``F.conv2d``, stride = patch), a class token, learned positions, the
port's bidirectional :class:`~apex_tpu_torch.models.transformer.
ParallelTransformer` (flash attention and the LayerNorm kernels), the
final norm and an fp32 classification head on token 0.  Images are NHWC,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
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
from apex_tpu_torch.transformer.layers import ColumnParallelLinear

__all__ = ["ViTConfig", "ViTModel"]


@dataclasses.dataclass(frozen=True)
class ViTConfig(TransformerConfig):
    """Encoder constraints are part of the contract: ``causal`` is
    always False and ``position_embedding`` always "learned" — passing
    a conflicting value raises.  ``max_seq_len`` is the patch grid plus
    the class token, derived (``init=False``), so
    ``dataclasses.replace(cfg, patch_size=...)`` derives it again."""

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    causal: bool = False
    position_embedding: str = "learned"
    max_seq_len: int = dataclasses.field(init=False, default=-1)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("num_classes", 10)
        return cls(**kw)

    @classmethod
    def vit_huge(cls, **kw) -> "ViTConfig":
        """ViT-H/14 (the large-batch LAMB benchmark sizing)."""
        kw.setdefault("hidden_size", 1280)
        kw.setdefault("num_layers", 32)
        kw.setdefault("num_heads", 16)
        kw.setdefault("patch_size", 14)
        return cls(**kw)

    def __post_init__(self):
        super().__post_init__()
        if self.causal:
            raise ValueError(
                "ViTConfig is a bidirectional encoder; causal=True is "
                "not supported")
        if self.position_embedding != "learned":
            raise ValueError(
                "ViTConfig uses learned position embeddings; got "
                f"position_embedding={self.position_embedding!r}")
        seq = (self.image_size // self.patch_size) ** 2 + 1
        object.__setattr__(self, "max_seq_len", seq)


class ViTModel(nn.Module):
    """ViT classifier on ``device`` (default ``"cuda"``): NHWC images
    ``(n, H, W, in_channels)`` → ``(n, num_classes)`` fp32 logits.
    Parameters are allocated uninitialized: load a state dict
    (:func:`~apex_tpu_torch.models.jax_import.params_from_jax`) or call
    :meth:`init_weights`."""

    def __init__(self, cfg: ViTConfig, device=None, in_channels: int = 3):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        p, c = cfg.patch_size, cfg.hidden_size
        kw = dict(dtype=cfg.param_dtype, device=dev)
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(
            torch.empty(c, in_channels, p, p, **kw))
        self.patch_embed.bias = nn.Parameter(torch.zeros(c, **kw))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c, **kw))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_seq_len, c, **kw))
        self.transformer = ParallelTransformer(cfg, dev)
        self.final_norm = Norm(cfg, dev)
        self.head = ColumnParallelLinear(
            c, cfg.num_classes, dtype=torch.float32,
            param_dtype=cfg.param_dtype, device=dev)

    @property
    def device(self) -> torch.device:
        return self.cls_token.device

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (on the model's device):
        fan-in-scaled patch embedding and linears, zero class token and
        biases, positions normal (std 0.02), unit norms."""
        init_module_weights(self, generator)
        with torch.no_grad():
            w = self.patch_embed.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()),
                      generator=generator)
            self.patch_embed.bias.zero_()
            self.cls_token.zero_()
            self.position_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, *, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        cfg = self.cfg
        dt = cfg.dtype
        p = cfg.patch_size
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt),
                     self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        n, c = y.shape[:2]
        y = y.flatten(2).transpose(1, 2)                  # (n, h*w, c)
        y = torch.cat([self.cls_token.to(y.dtype).expand(n, 1, c), y],
                      dim=1)
        y = y + self.position_embedding[None, :y.shape[1]].to(y.dtype)
        y = self.transformer(y, seeds=dropout_seeds(cfg, deterministic,
                                                    dropout_seed))
        y = self.final_norm(y)
        return self.head(y[:, 0].float())
