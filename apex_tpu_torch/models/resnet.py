"""ResNet — the reference's canonical amp training workload.

Counterpart of ``apex_tpu/models/resnet.py``: bottleneck ResNet over an
NHWC ``(N, H, W, 3)`` input, BN as
:class:`~apex_tpu_torch.parallel.SyncBatchNorm` (one card), with
``ResNetConfig.fused_bn`` routing every BN and its block epilogue
(residual-add, ReLU) through the fused kernels of
:mod:`apex_tpu_torch.ops.batch_norm`, and ``ResNetConfig.stem="s2d"``
the MLPerf space-to-depth stem (the 7×7/stride-2 conv as a 4×4/stride-1
conv over ``(N, 112, 112, 12)``; :func:`stem_conv_to_s2d` maps the
weights).

Layout: inside the model activations are NCHW tensors in
``torch.channels_last`` memory, so cuDNN runs NHWC convolutions and each
BN hands its kernels ``x.permute(0, 2, 3, 1)`` — a dense ``(N·H·W, C)``
matrix — with no transpose.  The flax conventions are kept where they
differ from torch's: ``"SAME"`` padding is asymmetric at stride 2 on an
even input (the 3×3 stride-2 ``conv2`` pads (0, 1), the s2d stem (2,
1)), convs cast input and kernel to ``cfg.dtype``, and the global
average pool and ``fc`` run in fp32 whatever dtype amp stores ``fc`` in.

Module names follow the flax tree (``stem``, ``bn_stem``,
``stage{i}_block{j}.{conv1,bn1,conv2,bn2,conv3,bn3,downsample,bn_down}``,
``fc``), so the amp norm filter keeps the BN parameters fp32 under O2
and :func:`~apex_tpu_torch.models.jax_import.resnet_params_from_jax`
maps a JAX tree one to one.  Conv weights are OIHW, ``fc.weight`` is
``(out, in)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["ResNetConfig", "ResNet", "resnet50", "resnet18",
           "space_to_depth", "stem_conv_to_s2d", "convert_stem_to_s2d"]

_IMAGE_CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    #: BN statistics over the mesh group of these axes (None: local)
    bn_axis_names: Optional[Sequence[str]] = None
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    #: route every BN and its epilogue through the fused kernels
    fused_bn: bool = False
    #: "conv": the 7×7/stride-2 conv0; "s2d": the space-to-depth stem
    stem: str = "conv"


# --------------------------------------------------------------------- #
# space-to-depth stem helpers
# --------------------------------------------------------------------- #
def space_to_depth(x, block: int = 2):
    """NHWC space-to-depth: ``(N, H, W, C) → (N, H/b, W/b, b·b·C)``,
    depth ordered ``(row offset, col offset, channel)``."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"spatial dims {(h, w)} not divisible by block {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def stem_conv_to_s2d(w7):
    """An OIHW ``(O, C, 7, 7)`` stride-2 stem weight as the equivalent
    ``(O, 4·C, 4, 4)`` stride-1 weight over space-to-depth input: pad
    the kernel to 8×8 with one leading zero row and column, then fold
    each 2×2 tap offset into the input channels (the JAX function's
    transform in torch's layout).  With the conv padded (2, 1) it
    reproduces the 7×7 conv padded 3."""
    if w7.dim() != 4 or tuple(w7.shape[2:]) != (7, 7):
        raise ValueError(f"expected an (O, C, 7, 7) weight, got "
                         f"{tuple(w7.shape)}")
    o, c = w7.shape[:2]
    w8 = w7.new_zeros(o, c, 8, 8)
    w8[:, :, 1:, 1:] = w7
    # [o, c, 2M+a, 2N+b] -> [o, (a, b, c), M, N]
    v = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return v.reshape(o, 4 * c, 4, 4)


def convert_stem_to_s2d(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A plain-stem ResNet ``state_dict`` in the ``stem="s2d"`` layout
    (a new dict; only ``stem.weight`` changes)."""
    out = dict(state_dict)
    out["stem.weight"] = stem_conv_to_s2d(state_dict["stem.weight"])
    return out


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: the low side gets the
    smaller half."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Module):
    """Bias-free conv in ``cfg.dtype``; ``padding`` is "SAME", "VALID"
    or explicit ``(lo, hi)`` for both spatial dims."""

    def __init__(self, cin, cout, k, stride, padding, cfg, dev):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            cout, cin, k, k, dtype=cfg.param_dtype, device=dev))

    def init_weights(self, generator=None):
        """Fan-in-scaled normal (lecun normal)."""
        fan_in = self.weight.shape[1] * self.k * self.k
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)

    def forward(self, x):
        if self.padding == "VALID":
            pads = [(0, 0), (0, 0)]
        elif self.padding == "SAME":
            pads = [_same_pads(n, self.k, self.stride) for n in x.shape[2:]]
        else:
            pads = [self.padding] * 2
        # dtype None promotes input and kernel, as flax's nn.Conv
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            (hl, hh), (wl, wh) = pads
            x = F.pad(x, (wl, wh, hl, hh))
            padding = 0
        return F.conv2d(x, self.weight.to(dt), stride=self.stride,
                        padding=padding)


class _BN(SyncBatchNorm):
    """BN with the block's epilogue (residual-add, then ReLU) on NCHW
    channels_last activations: folded into the fused op under
    ``cfg.fused_bn``, separate ops otherwise; the same parameters
    either way."""

    def __init__(self, c, cfg, act, dev):
        super().__init__(c, axis_names=cfg.bn_axis_names,
                         param_dtype=cfg.param_dtype, fused=cfg.fused_bn,
                         act=act if cfg.fused_bn else None, device=dev)
        self.block_act = act

    def forward(self, x, residual=None):
        def nhwc(t):
            return None if t is None else t.permute(0, 2, 3, 1)
        if self.fused:
            return super().forward(nhwc(x), nhwc(residual)).permute(0, 3, 1, 2)
        y = super().forward(nhwc(x)).permute(0, 3, 1, 2)
        if residual is not None:
            y = y + residual
        if self.block_act == "relu":
            y = F.relu(y)
        return y


class _BottleneckBlock(nn.Module):
    def __init__(self, cin, features, stride, cfg, dev):
        super().__init__()
        cout = features * 4
        self.conv1 = _Conv(cin, features, 1, 1, "VALID", cfg, dev)
        self.bn1 = _BN(features, cfg, "relu", dev)
        self.conv2 = _Conv(features, features, 3, stride, "SAME", cfg, dev)
        self.bn2 = _BN(features, cfg, "relu", dev)
        self.conv3 = _Conv(features, cout, 1, 1, "VALID", cfg, dev)
        if stride != 1 or cin != cout:
            self.downsample = _Conv(cin, cout, 1, stride, "VALID", cfg, dev)
            self.bn_down = _BN(cout, cfg, None, dev)
        else:
            self.downsample = self.bn_down = None
        self.bn3 = _BN(cout, cfg, "relu", dev)

    def forward(self, x):
        r = self.bn1(self.conv1(x))
        r = self.bn2(self.conv2(r))
        r = self.conv3(r)
        if self.downsample is not None:
            x = self.bn_down(self.downsample(x))
        # bn3 + residual-add + ReLU: one fused pass under fused_bn
        return self.bn3(r, residual=x)


class _Dense(nn.Module):
    """The classifier, computed in fp32 whatever its storage dtype."""

    def __init__(self, cin, cout, cfg, dev):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cout, cin, dtype=cfg.param_dtype, device=dev))
        self.bias = nn.Parameter(torch.zeros(
            cout, dtype=cfg.param_dtype, device=dev))

    def init_weights(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=generator)
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class ResNet(nn.Module):
    """Bottleneck ResNet on ``device`` (default ``"cuda"``): NHWC input
    ``(N, H, W, 3)`` → fp32 logits ``(N, num_classes)``.  Train mode
    (the default) normalises with batch statistics and updates the
    running ones; ``eval()`` uses the running ones.  Parameters are
    allocated uninitialized: load a state dict or call
    :meth:`init_weights`."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        w = cfg.width
        if cfg.stem == "s2d":
            self.stem = _Conv(4 * _IMAGE_CHANNELS, w, 4, 1, (2, 1), cfg, dev)
        elif cfg.stem == "conv":
            self.stem = _Conv(_IMAGE_CHANNELS, w, 7, 2, (3, 3), cfg, dev)
        else:
            raise ValueError(
                f"unknown stem {cfg.stem!r} (want 'conv' or 's2d')")
        self.bn_stem = _BN(w, cfg, "relu", dev)
        cin = w
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                f = w * 2 ** i
                self.add_module(f"stage{i}_block{j}", _BottleneckBlock(
                    cin, f, 2 if (j == 0 and i > 0) else 1, cfg, dev))
                cin = f * 4
        self.fc = _Dense(cin, cfg.num_classes, cfg, dev)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (on the model's device):
        fan-in-scaled normal convs and classifier, zero classifier bias,
        unit BN scale, zero BN bias, running statistics at (0, 1)."""
        for mod in self.modules():
            if hasattr(mod, "init_weights") and mod is not self:
                mod.init_weights(generator)

    def forward(self, x):
        x = x.contiguous()
        if self.cfg.stem == "s2d":
            x = space_to_depth(x)
        # NHWC data as an NCHW tensor in channels_last memory
        x = self.bn_stem(self.stem(x.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i, n_blocks in enumerate(self.cfg.stage_sizes):
            for j in range(n_blocks):
                x = getattr(self, f"stage{i}_block{j}")(x)
        # the global average pool accumulates in fp32 (a bf16 running
        # sum over the spatial grid would lose low bits)
        return self.fc(x.float().mean(dim=(2, 3)))


def resnet50(device=None, **kw) -> ResNet:
    """ResNet-50 (3-4-6-3 bottleneck stages), the reference's
    ``examples/imagenet`` workload."""
    return ResNet(ResNetConfig(stage_sizes=(3, 4, 6, 3), **kw), device)


def resnet18(device=None, **kw) -> ResNet:
    """The JAX package's small variant (bottleneck blocks, 2-2-2-2)."""
    return ResNet(ResNetConfig(stage_sizes=(2, 2, 2, 2), **kw), device)
