"""Transformer core — the full-sequence (training) path and the dense
KV-cached decode path.

Counterpart of ``apex_tpu/models/transformer.py``: pre-norm layers of
qkv projection → RoPE → attention → output projection → residual →
norm → MLP → residual.  The norms, RoPE and the full-sequence attention
go through the port's CUDA kernels (flash attention forward and
backward, LayerNorm forward and backward); the products are
``torch.nn.functional.linear``, as the JAX package leaves them to XLA.

Full sequence (``decode=False`` in JAX): every layer attends over the
whole input with ``fused_attention`` — causal or not, with an optional
additive ``mask_bias`` and attention/hidden dropout.  ``remat=True``
recomputes each layer in the backward (``torch.utils.checkpoint``,
non-reentrant: the ``nothing_saveable`` policy).  Dropout masks come
from integer seeds drawn once per step outside the checkpointed layer,
so the recomputed forward draws the same masks.

Decode: the cache index is per row — every row of a batch sits at its
own position, which the JAX serving engine gets from its ``vmap`` over
slots.  The cache is a dict of tensors (``apex_tpu_torch.models.
generate.init_cache``): ``key`` / ``value`` of ``(layers, batch,
max_seq_len, kv_heads, head_dim)`` and ``index`` ``(batch,)`` — tokens
already cached per row.  A forward writes its tokens' K/V at
``index + i`` in place and advances ``index``.

Not in this slice (each raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it): the paged KV cache (A-3),
sliding-window attention and mixture-of-experts layers (A-4), remat
policies other than ``nothing_saveable`` (A-6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.ops.mlp import resolve_activation
from apex_tpu_torch.ops.rope import fused_rope
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)

__all__ = ["TransformerConfig", "DecodeStep", "ParallelAttention",
           "ParallelMLP", "ParallelTransformerLayer", "ParallelTransformer",
           "dropout_seeds", "init_module_weights"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture knobs shared by the model zoo (the JAX config's
    fields for the full-sequence and dense decode paths, with torch
    dtypes)."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: Optional[int] = None      # GQA; None = num_heads
    ffn_hidden_size: Optional[int] = None   # None = 4*hidden
    max_seq_len: int = 2048
    # "rope" (GPT-NeoX/Llama), "learned" (GPT-2) or "none"
    position_embedding: str = "rope"
    rotary_pct: float = 1.0
    rope_base: float = 10000.0
    norm: str = "layernorm"                 # or "rmsnorm"
    layernorm_eps: float = 1e-5
    causal: bool = True
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    activation: str = "gelu"
    add_bias_linear: bool = True
    sliding_window: Optional[int] = None
    gated_mlp: bool = False
    num_moe_experts: Optional[int] = None
    # recompute each layer in the backward (full-sequence path)
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    # flash-attention tiles; None = the kernels' tile (64, the only one)
    attention_block_q: Optional[int] = None
    attention_block_k: Optional[int] = None
    # steady-decode attention: "einsum" (one masked product over the
    # cache), "blocked" (online softmax over key blocks) or "auto"
    # (blocked from 2048 cache slots up, as in the JAX package)
    decode_attn: str = "auto"
    kv_cache: str = "dense"
    # Megatron per-kv-head grouped qkv layout: [q_g*rep..., k_g, v_g]
    qkv_grouped: bool = True
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def rot_dim(self) -> int:
        return int(self.rotary_pct * self.head_dim) // 2 * 2

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must divide hidden_size "
                f"({self.hidden_size})")
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_kv_heads ({self.num_kv_heads}) must divide "
                f"num_heads ({self.num_heads})")
        if self.position_embedding not in ("rope", "learned", "none"):
            raise ValueError(
                f"position_embedding={self.position_embedding!r} not in "
                "('rope', 'learned', 'none')")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"norm={self.norm!r} not in ('layernorm', 'rmsnorm')")
        if self.decode_attn not in ("auto", "einsum", "blocked"):
            raise ValueError(
                f"decode_attn={self.decode_attn!r} not in "
                "('auto', 'einsum', 'blocked')")
        if self.kv_cache not in ("dense", "paged"):
            raise ValueError(
                f"kv_cache={self.kv_cache!r} not in ('dense', 'paged')")
        if self.remat_policy != "nothing_saveable":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r}: only "
                "'nothing_saveable' is ported; the others come with "
                "ROADMAP.md A-6")
        if self.kv_cache == "paged":
            raise NotImplementedError(
                "kv_cache='paged' comes with ROADMAP.md A-3, the paged "
                "serving slice")
        if self.sliding_window is not None:
            raise NotImplementedError(
                "sliding_window comes with ROADMAP.md A-4")
        if self.num_moe_experts is not None:
            raise NotImplementedError(
                "mixture-of-experts layers come with ROADMAP.md A-4")


@dataclasses.dataclass
class DecodeStep:
    """What every layer of one decode-mode forward shares.

    ``index`` ``(b,)``: each row's cache cursor before this call;
    ``positions`` ``(b, s)``: the absolute positions of this call's
    tokens; ``kv_len``: cache slots that can be visible to any row
    (a host-side bound, so attention reads only the live prefix);
    ``cos`` / ``sin``: per-row RoPE tables ``(b, s, rot/2)`` or
    ``None``.
    """

    index: torch.Tensor
    positions: torch.Tensor
    kv_len: int
    cos: Optional[torch.Tensor] = None
    sin: Optional[torch.Tensor] = None


class Norm(nn.Module):
    """Pre-norm: RMSNorm or LayerNorm through the fused kernel."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.rms = cfg.norm == "rmsnorm"
        self.eps = cfg.layernorm_eps
        self.weight = nn.Parameter(torch.ones(
            cfg.hidden_size, dtype=cfg.param_dtype, device=device))
        if self.rms:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(
                cfg.hidden_size, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        if self.rms:
            return fused_rms_norm(x, self.weight, eps=self.eps)
        return fused_layer_norm(x, self.weight, self.bias, eps=self.eps)


def _cache_attention(q, keys, values, idx, scale):
    """Attention of ``q`` (b, s, h, d) over cached ``keys`` / ``values``
    (b, S, hk, d): grouped (GQA) products in fp32, positions past each
    row's ``idx + i`` masked, fp32 softmax."""
    b, s, h, d = q.shape
    S, hk = keys.shape[1], keys.shape[2]
    rep = h // hk
    qg = q.reshape(b, s, hk, rep, d).float()
    scores = torch.einsum("bsgrd,bkgd->bsgrk", qg, keys.float()) * scale
    pos_q = idx[:, None] + torch.arange(s, device=q.device)       # (b, s)
    k_pos = torch.arange(S, device=q.device)
    visible = k_pos[None, None, :] <= pos_q[:, :, None]           # (b, s, S)
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bsgrk,bkgd->bsgrd", p, values.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def _cache_attention_blocked(q, keys, values, idx, scale, block=1024):
    """The same attention as an online-softmax sweep over key blocks of
    ``block`` slots, so score temporaries stay ``(b, s, h, block)``."""
    b, s, h, d = q.shape
    S, hk = keys.shape[1], keys.shape[2]
    rep = h // hk
    dev = q.device
    qg = q.reshape(b, s, hk, rep, d).float() * scale
    pos_q = idx[:, None] + torch.arange(s, device=dev)            # (b, s)
    m = torch.full((b, s, hk, rep), -float("inf"), device=dev)
    l = torch.zeros((b, s, hk, rep), device=dev)
    acc = torch.zeros((b, s, hk, rep, d), device=dev)
    for start in range(0, S, block):
        kb = keys[:, start:start + block].float()
        vb = values[:, start:start + block].float()
        sc = torch.einsum("bsgrd,bkgd->bsgrk", qg, kb)
        k_pos = start + torch.arange(kb.shape[1], device=dev)
        vis = k_pos[None, None, :] <= pos_q[:, :, None]
        sc = torch.where(vis[:, :, None, None, :], sc,
                         torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(sc < -0.5e30, torch.zeros_like(p), p)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsgrk,bkgd->bsgrd", p, vb)
        m = m_new
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return o.reshape(b, s, h, d).to(q.dtype)


class ParallelAttention(nn.Module):
    """qkv projection → RoPE → attention → output projection: over the
    full sequence with ``fused_attention`` (the JAX module's
    ``decode=False``), or the dense decode path (cache write, attention
    over the cache) when given a :class:`DecodeStep`."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, hk, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        kw = dict(use_bias=cfg.add_bias_linear, dtype=cfg.dtype,
                  param_dtype=cfg.param_dtype, device=device)
        self.qkv_proj = ColumnParallelLinear(
            cfg.hidden_size, (h + 2 * hk) * d, **kw)
        self.out_proj = RowParallelLinear(h * d, cfg.hidden_size, **kw)

    def _qkv(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        qkv = self.qkv_proj(x)
        if cfg.qkv_grouped:
            rep = h // hk
            grouped = qkv.view(b, s, hk, rep + 2, d)
            q = grouped[..., :rep, :].reshape(b, s, h, d)
            k = grouped[..., rep, :]
            v = grouped[..., rep + 1, :]
        else:
            q = qkv[..., :h * d].reshape(b, s, h, d)
            k = qkv[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
            v = qkv[..., (h + hk) * d:].reshape(b, s, hk, d)
        return q, k, v

    def forward(self, x, cache_k=None, cache_v=None,
                step: Optional[DecodeStep] = None, *, mask_bias=None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                attn_seed: Optional[int] = None):
        """Full sequence when ``step`` is None: ``mask_bias`` an
        additive bias broadcastable to ``(b, h, s, s)``, ``rope`` the
        ``(s, rot/2)`` cos/sin tables, ``attn_seed`` the dropout seed
        (None: no attention dropout).  Decode otherwise."""
        if step is not None:
            return self._decode(x, cache_k, cache_v, step)
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        if rope is not None:
            q = fused_rope(q, *rope)
            k = fused_rope(k, *rope)
        drop = cfg.attention_dropout if attn_seed is not None else 0.0
        o = fused_attention(
            q, k, v, causal=cfg.causal, bias=mask_bias,
            window=cfg.sliding_window, dropout_rate=drop,
            dropout_seed=attn_seed if drop > 0.0 else None,
            block_q=cfg.attention_block_q, block_k=cfg.attention_block_k)
        return self.out_proj(o.reshape(b, s, cfg.num_heads * cfg.head_dim))

    def _decode(self, x, cache_k, cache_v, step: DecodeStep):
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError(
                "decode=True requires a causal model (the cache attends "
                "over the generated prefix)")
        b, s, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        q, k, v = self._qkv(x)
        if step.cos is not None:
            q = fused_rope(q, step.cos, step.sin)
            k = fused_rope(k, step.cos, step.sin)
        rows = torch.arange(b, device=x.device)[:, None]
        cache_k[rows, step.positions] = k.to(cache_k.dtype)
        cache_v[rows, step.positions] = v.to(cache_v.dtype)
        keys = cache_k[:, :step.kv_len]
        values = cache_v[:, :step.kv_len]
        scale = d ** -0.5
        S = cfg.max_seq_len
        if s == 1:
            mode = cfg.decode_attn
            if mode == "blocked" or (mode == "auto" and S >= 2048):
                o = _cache_attention_blocked(q, keys, values, step.index,
                                             scale, block=512)
            else:
                o = _cache_attention(q, keys, values, step.index, scale)
        else:
            o = _cache_attention_blocked(q, keys, values, step.index, scale)
        return self.out_proj(o.reshape(b, s, h * d))


class ParallelMLP(nn.Module):
    """h → ffn (+ activation, gated for SwiGLU) → h."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.act = resolve_activation(cfg.activation, gelu_approximate=True)
        kw = dict(use_bias=cfg.add_bias_linear, dtype=cfg.dtype,
                  param_dtype=cfg.param_dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_size, **kw)
        self.dense_h_to_4h_gate = (ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_size, **kw) if cfg.gated_mlp else None)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn_size, cfg.hidden_size, **kw)

    def forward(self, x):
        y = self.dense_h_to_4h(x)
        if self.dense_h_to_4h_gate is not None:
            y = self.act(self.dense_h_to_4h_gate(x)) * y
        else:
            y = self.act(y)
        return self.dense_4h_to_h(y)


def _dropout(x, rate: float, seed: int):
    """Inverted dropout with a mask drawn from a generator seeded by
    ``seed`` on ``x``'s device, so a recomputation draws it again."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout_seeds(cfg: TransformerConfig, deterministic: bool,
                  dropout_seed: Optional[int]
                  ) -> Optional[List[Tuple[int, ...]]]:
    """Per layer, the seeds of its attention dropout and its two hidden
    dropouts, drawn on the host from ``dropout_seed`` (no device read):
    one draw per step, outside any recomputed region.  None when no
    dropout runs."""
    if deterministic or (cfg.hidden_dropout <= 0.0
                         and cfg.attention_dropout <= 0.0):
        return None
    if dropout_seed is None:
        raise ValueError(
            "deterministic=False with dropout needs an integer "
            "dropout_seed (draw one per step, e.g. from a torch.Generator)")
    g = torch.Generator().manual_seed(int(dropout_seed))
    draw = torch.randint(0, 2 ** 31 - 1, (cfg.num_layers, 3), generator=g)
    return [tuple(int(v) for v in row) for row in draw.tolist()]


class ParallelTransformerLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_norm = Norm(cfg, device)
        self.attention = ParallelAttention(cfg, device)
        self.post_attention_norm = Norm(cfg, device)
        self.mlp = ParallelMLP(cfg, device)

    def forward(self, x, cache_k=None, cache_v=None,
                step: Optional[DecodeStep] = None, *, mask_bias=None,
                rope=None, seeds: Optional[Sequence[int]] = None):
        """``seeds``: this layer's (attention, hidden, hidden) dropout
        seeds, or None without dropout."""
        rate = self.cfg.hidden_dropout
        a = self.attention(self.input_norm(x), cache_k, cache_v, step,
                           mask_bias=mask_bias, rope=rope,
                           attn_seed=None if seeds is None else seeds[0])
        if seeds is not None and rate > 0.0:
            a = _dropout(a, rate, seeds[1])
        x = x + a.to(x.dtype)
        m = self.mlp(self.post_attention_norm(x))
        if seeds is not None and rate > 0.0:
            m = _dropout(m, rate, seeds[2])
        return x + m.to(x.dtype)


class ParallelTransformer(nn.Module):
    """``num_layers`` stacked layers: over the full sequence (each layer
    recomputed in the backward under ``remat``), or over a stacked KV
    cache in decode."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(cfg, device)
            for _ in range(cfg.num_layers))

    def forward(self, x, cache=None, step: Optional[DecodeStep] = None, *,
                mask_bias=None, rope=None, seeds=None):
        if step is not None:
            for i, layer in enumerate(self.layers):
                x = layer(x, cache["key"][i], cache["value"][i], step)
            return x
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            kw = dict(mask_bias=mask_bias, rope=rope,
                      seeds=None if seeds is None else seeds[i])
            if remat:
                x = checkpoint(layer, x, use_reentrant=False, **kw)
            else:
                x = layer(x, **kw)
        return x


def init_module_weights(model: nn.Module,
                        generator: Optional[torch.Generator] = None):
    """Random weights from ``generator`` (on the model's device):
    normal embeddings and learned tables (std 0.02), fan-in-scaled
    linears, unit norms with zero bias."""
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "init_weights") and mod is not model:
                mod.init_weights(generator)
            elif isinstance(mod, Norm):
                mod.weight.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
