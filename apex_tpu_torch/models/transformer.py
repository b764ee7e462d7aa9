"""Transformer core — the full-sequence (training) path and the dense
KV-cached decode path.

Counterpart of ``apex_tpu/models/transformer.py``: pre-norm layers of
qkv projection → RoPE → attention → output projection → residual →
norm → MLP → residual.  The norms, RoPE and the full-sequence attention
go through the port's CUDA kernels (flash attention forward and
backward, LayerNorm forward and backward); the products are
``torch.nn.functional.linear``, as the JAX package leaves them to XLA.

Full sequence (``decode=False`` in JAX): every layer attends over the
whole input with ``fused_attention`` — causal or not, banded under
``sliding_window``, with an optional additive ``mask_bias`` and
attention/hidden dropout.  ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``, non-reentrant) under
``remat_policy``: a selective-checkpoint policy keeps the outputs of
the ops it names — the 2-D products, or the flash forward (one
dispatcher op, ``apex_tpu_torch::flash_fwd``, whose ``(o, lse)`` are the
JAX kernel's ``attn_out`` / ``attn_lse`` residuals) — and
``remat_skip_every`` exempts every k-th layer.  Dropout masks come
from integer seeds drawn once per step outside the checkpointed layer,
so the recomputed forward draws the same masks.  Under
``num_moe_experts`` the MLP is a mixture of experts and each layer keeps
its load-balance term (``moe_aux``).

Decode: the cache index is per row — every row of a batch sits at its
own position, which the JAX serving engine gets from its ``vmap`` over
slots.  The cache is a dict of tensors (``apex_tpu_torch.models.
generate.init_cache``): ``key`` / ``value`` of ``(layers, batch,
max_seq_len, kv_heads, head_dim)`` and ``index`` ``(batch,)`` — tokens
already cached per row.  A forward writes its tokens' K/V at
``index + i`` in place and advances ``index``.  With a
``sliding_window`` below ``max_seq_len`` the cache is a ring of that
many slots (``(layers, batch, window, kv_heads, head_dim)``) plus
``slot_positions`` ``(batch, window)`` (position + 1, 0 = empty).

Paged decode (a cache from ``init_paged_cache``, the serving engine's
layout; ``cfg.kv_cache == "paged"`` marks a model configured for it):
every layer owns a page pool ``(kv_heads, kv_pool_blocks,
kv_block_size, head_dim)`` — in the compute dtype, or int8 / e4m3 codes
with per-(kv head, page) fp32 scales under ``kv_dtype`` — and a
:class:`PagedStep` carries the engine's block tables, cursors and real
lane counts to every layer.  A width-1 step goes through the fused
decode kernel (RoPE, the quantize-and-write of the new row, the attend);
a wider step (chunked prefill, the speculative verify) rotates with the
per-row RoPE kernel, scatters its K/V into the pool and attends with the
paged attention kernel.  The pool is updated in place.

Tensor parallelism: built while a mesh is initialized
(:mod:`apex_tpu_torch.core.mesh`), each layer holds its rank's shard of
the heads (the grouped qkv layout keeps whole kv groups on a rank) and
of the MLP's hidden features (:mod:`apex_tpu_torch.transformer.layers`).
Under ``sequence_parallel`` the activations between the blocks are the
rank's chunk of the sequence (dim 1): the norms, residuals and hidden
dropout run on the chunk, a column layer all-gathers it on entry and a
row layer reduce-scatters on exit, as the JAX model's sharding
constraints place them.  A sharded run computes what the unsharded one
computes, dropout included: the attention-dropout hash takes each local
head's global lane (``fused_attention(dropout_lanes=...)``), and the
hidden dropout draws the whole mask and keeps the rank's chunk.

Decode at tp > 1 (tensor-parallel serving): each rank's cache or page
pool holds its share of the kv heads (``kv_heads / tp``), the layer
attends on its heads and the row-parallel output all-reduces.  The
model is built on the serving mesh (its layers hold their heads from
it); the serving engine carries that mesh and checks it as the JAX
config checks ``kv_mesh`` / ``kv_shard_axis``, which the config here
does not repeat.  Decode runs without sequence parallelism.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch.amp import o1
from apex_tpu_torch.core.mesh import TENSOR_AXIS
from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.ops.mlp import resolve_activation
from apex_tpu_torch.ops.paged_attention import (
    kv_quant_spec,
    paged_attention,
    paged_decode_fused,
    pool_qmax,
    quantize_kv,
)
from apex_tpu_torch.ops.rope import _rope_qk
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    tensor_parallel,
)
from apex_tpu_torch.transformer.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_tensor_parallel_region,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP

__all__ = ["TransformerConfig", "DecodeStep", "PagedStep",
           "REMAT_POLICIES", "remat_saves", "remat_context_fn",
           "ParallelAttention",
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
    # sliding-window attention (Mistral; requires causal): each query
    # attends to the last `sliding_window` positions.  Below max_seq_len
    # the decode cache is a ring of that many slots.
    sliding_window: Optional[int] = None
    gated_mlp: bool = False
    # Mixture-of-Experts FFN (Mixtral): every layer's MLP becomes
    # `num_moe_experts` experts under top-k token-choice routing
    # (transformer/moe.py); each MoE layer records its weighted
    # load-balance term, summed by models.moe_aux_loss(model)
    num_moe_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 1e-2
    moe_expert_axis: Optional[str] = "tensor"
    # recompute each layer in the backward (full-sequence path) under
    # `remat_policy`: "nothing_saveable" (recompute all),
    # "everything_saveable" (no recomputation),
    # "dots_with_no_batch_dims_saveable" (keep the outputs of the 2-D
    # products) or "save_only:<name>[,<name>...]" with the flash
    # forward's residuals "attn_out" and "attn_lse"
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    # with remat: layer i with i % remat_skip_every == 0 keeps its
    # activations (no recomputation); 0 disables
    remat_skip_every: int = 0
    # flash-attention tiles; None = the kernels' tile (64, the only one)
    attention_block_q: Optional[int] = None
    attention_block_k: Optional[int] = None
    # steady-decode attention: "einsum" (one masked product over the
    # cache), "blocked" (online softmax over key blocks) or "auto"
    # (blocked from 2048 cache slots up, as in the JAX package)
    decode_attn: str = "auto"
    kv_cache: str = "dense"
    # the paged pool (kv_cache="paged"): tokens per page, pages per
    # layer including the null page 0, and the storage ("int8", "fp8";
    # None stores the compute dtype)
    kv_block_size: int = 16
    kv_pool_blocks: int = 0
    kv_dtype: Optional[str] = None
    # Megatron per-kv-head grouped qkv layout: [q_g*rep..., k_g, v_g]
    qkv_grouped: bool = True
    # with a mesh: the activations between blocks are the rank's chunk
    # of the sequence over the tensor axis (Korthikanti et al.)
    sequence_parallel: bool = False
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
        if self.sliding_window is not None:
            if not self.causal:
                raise ValueError("sliding_window requires causal=True")
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window must be >= 1, got "
                    f"{self.sliding_window}")
        if self.decode_attn not in ("auto", "einsum", "blocked"):
            raise ValueError(
                f"decode_attn={self.decode_attn!r} not in "
                "('auto', 'einsum', 'blocked')")
        if self.kv_cache not in ("dense", "paged"):
            raise ValueError(
                f"kv_cache={self.kv_cache!r} not in ('dense', 'paged')")
        if self.kv_cache == "paged":
            if not self.causal:
                raise ValueError("kv_cache='paged' requires causal=True "
                                 "(it is a decode-cache layout)")
            if self.sliding_window is not None:
                raise ValueError(
                    "kv_cache='paged' does not support sliding_window "
                    "— the paged pool already bounds decode memory to "
                    "live tokens; serve with sliding_window=None")
            if self.kv_block_size < 1:
                raise ValueError(
                    f"kv_block_size must be >= 1, got {self.kv_block_size}")
            if self.kv_pool_blocks < 2:
                raise ValueError(
                    "kv_pool_blocks must be >= 2 (block 0 is the "
                    f"reserved null page), got {self.kv_pool_blocks}")
        if self.kv_dtype is not None:
            if self.kv_cache != "paged":
                raise ValueError(
                    "kv_dtype requires kv_cache='paged' — quantized KV "
                    "pages live in the paged pool; the dense slab stores "
                    "K/V in the compute dtype")
            kv_quant_spec(self.kv_dtype)
        if self.num_moe_experts is not None:
            if self.num_moe_experts < 2:
                raise ValueError(
                    f"num_moe_experts must be >= 2, got "
                    f"{self.num_moe_experts}")
            if self.moe_top_k < 1:
                raise ValueError(
                    f"moe_top_k must be >= 1, got {self.moe_top_k}")
            if self.moe_top_k > self.num_moe_experts:
                raise ValueError(
                    f"moe_top_k ({self.moe_top_k}) cannot exceed "
                    f"num_moe_experts ({self.num_moe_experts})")
        remat_saves(self.remat_policy)
        if self.remat_skip_every < 0:
            raise ValueError(
                f"remat_skip_every must be >= 0, got {self.remat_skip_every}")

    @property
    def ring_window(self) -> Optional[int]:
        """Slots of the decode cache's ring: ``sliding_window`` when it
        is below ``max_seq_len``, else None (the dense cache)."""
        w = self.sliding_window
        return w if w is not None and w < self.max_seq_len else None


REMAT_POLICIES = ("nothing_saveable", "everything_saveable",
                  "dots_with_no_batch_dims_saveable",
                  "save_only:<name>[,<name>...]")
#: the residuals the flash forward names (``apex_tpu/ops/attention.py``)
SAVEABLE_NAMES = ("attn_out", "attn_lse")


def remat_saves(policy: str):
    """What a remat policy keeps for the backward: None (nothing: the
    whole layer is recomputed), ``"all"`` (no recomputation), or the
    tuple of dispatcher ops whose outputs are kept.  Raises
    ``ValueError`` for any other policy."""
    if policy == "nothing_saveable":
        return None
    if policy == "everything_saveable":
        return "all"
    if policy == "dots_with_no_batch_dims_saveable":
        return (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    if policy.startswith("save_only:"):
        names = [n for n in policy[len("save_only:"):].split(",") if n]
        bad = [n for n in names if n not in SAVEABLE_NAMES]
        if not names or bad:
            raise ValueError(
                f"remat_policy={policy!r}: save_only takes names among "
                f"{SAVEABLE_NAMES}")
        # the flash forward is one op producing both residuals: kept
        # when both are named; with one, the backward needs the other,
        # so the recomputation reruns the op either way
        if set(names) == set(SAVEABLE_NAMES):
            return (torch.ops.apex_tpu_torch.flash_fwd.default,)
        return None
    raise ValueError(
        f"remat_policy={policy!r} not in {REMAT_POLICIES}")


@dataclasses.dataclass
class DecodeStep:
    """What every layer of one decode-mode forward shares.

    ``index`` ``(b,)``: each row's cache cursor before this call;
    ``positions`` ``(b, s)``: the absolute positions of this call's
    tokens; ``kv_len``: cache slots that can be visible to any row
    (a host-side bound, so attention reads only the live prefix);
    ``cos`` / ``sin``: per-row RoPE tables ``(b, s, rot/2)`` or
    ``None``.

    A ring cache (``cfg.ring_window``) adds ``slots`` ``(b, n)``: the
    ring slots this call writes (one when ``s == 1``, else the chunk's
    last ``min(s, window)`` tokens), and ``key_positions`` ``(b,
    window)``: each slot's absolute position (-1 empty) as the layers
    read the ring — after the write when ``s == 1``, before it for a
    chunk, as in the JAX module.
    """

    index: torch.Tensor
    positions: torch.Tensor
    kv_len: int
    cos: Optional[torch.Tensor] = None
    sin: Optional[torch.Tensor] = None
    slots: Optional[torch.Tensor] = None
    key_positions: Optional[torch.Tensor] = None


@dataclasses.dataclass
class PagedStep:
    """What every layer of one paged forward shares (the engine owns the
    tables and cursors; the model never advances them).

    ``tables`` ``(b, pages_per_seq)`` int32 block tables; ``cursors``
    ``(b,)`` int32 tokens already cached per row; ``chunk_lens`` ``(b,)``
    int32 real lanes of this call per row (pad lanes of a quantized pool
    are written to the null page); ``positions`` ``(b, s)`` absolute
    positions; ``cos`` / ``sin`` per-row RoPE tables ``(b, s, rot/2)``
    at the positions clamped to ``max_seq_len - 1``, or ``None``.
    """

    tables: torch.Tensor
    cursors: torch.Tensor
    chunk_lens: torch.Tensor
    positions: torch.Tensor
    cos: Optional[torch.Tensor] = None
    sin: Optional[torch.Tensor] = None


class Norm(nn.Module):
    """Pre-norm: RMSNorm or LayerNorm through the fused kernel.

    ``sequence_parallel``: the norm runs on the rank's sequence chunk
    (with a mesh and ``cfg.sequence_parallel``), so each tensor rank's
    gradient of the replicated weights is a part: they enter through
    ``copy_to_tensor_parallel_region``, whose backward sums the parts
    over the tensor group (Megatron's all-reduce of the
    sequence-parallel gradients)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.sequence_parallel = (sequence_parallel and cfg.sequence_parallel
                                  and tensor_parallel()[0])
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
        w, b = self.weight, self.bias
        if self.sequence_parallel:
            w = copy_to_tensor_parallel_region(w)
            b = None if b is None else copy_to_tensor_parallel_region(b)
        if self.rms:
            return fused_rms_norm(x, w, eps=self.eps)
        return fused_layer_norm(x, w, b, eps=self.eps)


def _visible(pos_q, k_pos, window):
    """``(b, s, S)`` True where a query at ``pos_q`` ``(b, s)`` sees a
    key at ``k_pos`` (``(S,)`` slot indices or ``(b, S)`` per-slot
    positions, -1 empty): at or before the query and, with ``window``,
    less than ``window`` positions back."""
    k_pos = k_pos if k_pos.dim() == 2 else k_pos[None]
    k_pos = k_pos[:, None, :]
    vis = (k_pos >= 0) & (k_pos <= pos_q[:, :, None])
    if window is not None:
        vis = vis & (k_pos > pos_q[:, :, None] - window)
    return vis


def _cache_attention(q, keys, values, idx, scale, window=None,
                     key_positions=None):
    """Attention of ``q`` (b, s, h, d) over cached ``keys`` / ``values``
    (b, S, hk, d): grouped (GQA) products in fp32, positions past each
    row's ``idx + i`` (and, with ``window``, at or before ``idx + i -
    window``) masked, fp32 softmax.  ``key_positions`` ``(b, S)``: each
    slot's absolute position (a ring cache; -1 empty), else the slot
    index is the position."""
    b, s, h, d = q.shape
    S, hk = keys.shape[1], keys.shape[2]
    rep = h // hk
    qg = q.reshape(b, s, hk, rep, d).float()
    scores = torch.einsum("bsgrd,bkgd->bsgrk", qg, keys.float()) * scale
    pos_q = idx[:, None] + torch.arange(s, device=q.device)       # (b, s)
    k_pos = (torch.arange(S, device=q.device) if key_positions is None
             else key_positions)
    visible = _visible(pos_q, k_pos, window)                      # (b, s, S)
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bsgrk,bkgd->bsgrd", p, values.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def _cache_attention_blocked(q, keys, values, idx, scale, window=None,
                             key_positions=None, block=1024):
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
        k_pos = (start + torch.arange(kb.shape[1], device=dev)
                 if key_positions is None
                 else key_positions[:, start:start + block])
        vis = _visible(pos_q, k_pos, window)
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
        active, tp, rank = tensor_parallel()
        if hk % tp:
            raise ValueError(f"kv heads ({hk}) must split over the tensor "
                             f"axis ({tp})")
        if tp > 1 and not cfg.qkv_grouped:
            raise ValueError("tensor parallelism needs qkv_grouped=True "
                             "(whole kv groups on a rank)")
        # this rank's heads, and their global lanes for attention dropout
        self.heads, self.kv_heads = h // tp, hk // tp
        self.dropout_lanes = (h, rank * self.heads)
        self.tp_size = tp
        self.sequence_parallel = active and cfg.sequence_parallel and tp > 1
        kw = dict(use_bias=cfg.add_bias_linear, dtype=cfg.dtype,
                  param_dtype=cfg.param_dtype, device=device,
                  sequence_parallel=cfg.sequence_parallel)
        self.qkv_proj = ColumnParallelLinear(
            cfg.hidden_size, (h + 2 * hk) * d, **kw)
        self.out_proj = RowParallelLinear(h * d, cfg.hidden_size, **kw)

    def _qkv(self, x, rope=None):
        """q ``(b, s, h, d)``, k and v ``(b, s, hk, d)`` from the packed
        projection; with ``rope`` (the cos/sin tables) q and k come back
        rotated by one kernel launch that reads them through their
        strides, so neither is copied first."""
        cfg = self.cfg
        h, hk, d = self.heads, self.kv_heads, cfg.head_dim
        qkv = self.qkv_proj(x)
        b, s, _ = qkv.shape
        if cfg.qkv_grouped:
            rep = h // hk
            grouped = qkv.view(b, s, hk, rep + 2, d)
            q = grouped[..., :rep, :]
            k = grouped[..., rep, :]
            v = grouped[..., rep + 1, :]
        else:
            q = qkv[..., :h * d].reshape(b, s, h, d)
            k = qkv[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
            v = qkv[..., (h + hk) * d:].reshape(b, s, hk, d)
        if rope is not None:
            q, k = _rope_qk(q, k, *rope)
        elif cfg.qkv_grouped:
            q = q.reshape(b, s, h, d)
        return q, k, v

    def forward(self, x, cache_k=None, cache_v=None,
                step: Optional[DecodeStep] = None, *, mask_bias=None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                attn_seed: Optional[int] = None, scales=None):
        """Full sequence when ``step`` is None: ``mask_bias`` an
        additive bias broadcastable to ``(b, h, s, s)``, ``rope`` the
        ``(s, rot/2)`` cos/sin tables, ``attn_seed`` the dropout seed
        (None: no attention dropout).  Dense decode for a
        :class:`DecodeStep`; paged decode for a :class:`PagedStep`, with
        ``cache_k`` / ``cache_v`` this layer's page pools and ``scales``
        its ``(k_scales, v_scales)`` when the pool is quantized."""
        if step is not None and self.sequence_parallel:
            raise ValueError(
                "decode runs without sequence parallelism: build the "
                "serving model with sequence_parallel=False")
        if isinstance(step, PagedStep):
            return self._paged_decode(x, cache_k, cache_v, scales, step)
        if step is not None:
            return self._decode(x, cache_k, cache_v, step)
        cfg = self.cfg
        q, k, v = self._qkv(x, rope)
        b, s = q.shape[:2]
        drop = cfg.attention_dropout if attn_seed is not None else 0.0
        o = fused_attention(
            q, k, v, causal=cfg.causal, bias=mask_bias,
            window=cfg.sliding_window, dropout_rate=drop,
            dropout_seed=attn_seed if drop > 0.0 else None,
            dropout_lanes=self.dropout_lanes,
            block_q=cfg.attention_block_q, block_k=cfg.attention_block_k)
        return self.out_proj(o.reshape(b, s, self.heads * cfg.head_dim))

    def _decode(self, x, cache_k, cache_v, step: DecodeStep):
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError(
                "decode=True requires a causal model (the cache attends "
                "over the generated prefix)")
        b, s, _ = x.shape
        h, d = self.heads, cfg.head_dim
        q, k, v = self._qkv(x, None if step.cos is None else (
            step.cos, step.sin))
        rows = torch.arange(b, device=x.device)[:, None]
        scale = d ** -0.5
        if step.slots is not None:
            o = self._ring_decode(q, k, v, cache_k, cache_v, step, scale)
            return self.out_proj(o.reshape(b, s, h * d))
        cache_k[rows, step.positions] = k.to(cache_k.dtype)
        cache_v[rows, step.positions] = v.to(cache_v.dtype)
        keys = cache_k[:, :step.kv_len]
        values = cache_v[:, :step.kv_len]
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

    def _ring_decode(self, q, k, v, ring_k, ring_v, step: DecodeStep,
                     scale):
        """Attention over the sliding-window ring ``(b, W, hk, d)``.

        ``s == 1``: write the token into its slot, then attend over the
        ring by per-slot positions.  A chunk: only its first ``min(W,
        s)`` queries can see ring entries, so they attend over ``[ring ‖
        chunk head]`` by the blocked online softmax; the rest see only
        the chunk and go through the banded flash kernel; then the
        chunk's last ``min(s, W)`` tokens overwrite their slots."""
        W = ring_k.shape[1]
        b, s = q.shape[:2]
        rows = torch.arange(b, device=q.device)[:, None]
        if s == 1:
            ring_k[rows, step.slots] = k.to(ring_k.dtype)
            ring_v[rows, step.slots] = v.to(ring_v.dtype)
            return _cache_attention(q, ring_k, ring_v, step.index, scale,
                                    window=W,
                                    key_positions=step.key_positions)
        hlen = min(W, s)
        cat_k = torch.cat([ring_k, k[:, :hlen].to(ring_k.dtype)], dim=1)
        cat_v = torch.cat([ring_v, v[:, :hlen].to(ring_v.dtype)], dim=1)
        cat_pos = torch.cat([step.key_positions,
                             step.positions[:, :hlen]], dim=1)
        o = _cache_attention_blocked(q[:, :hlen], cat_k, cat_v, step.index,
                                     scale, window=W, key_positions=cat_pos)
        if s > hlen:
            o_tail = fused_attention(q[:, hlen:], k, v, causal=True,
                                     scale=scale, window=W)
            o = torch.cat([o, o_tail], dim=1)
        tail = step.slots.shape[1]
        ring_k[rows, step.slots] = k[:, s - tail:].to(ring_k.dtype)
        ring_v[rows, step.slots] = v[:, s - tail:].to(ring_v.dtype)
        return o

    def _paged_decode(self, x, kp, vp, scales, step: PagedStep):
        """Write-then-attend over the paged pool (updated in place).

        Width 1: the fused decode kernel rotates q and the new key,
        writes the (coded) row into its page and attends.  Wider: rotate
        per row, scatter the chunk into the pool — positions at or past
        ``max_seq_len`` go to the null page, and under a quantized pool
        so do pad lanes (past ``chunk_lens``), whose amax must never
        reach a live page's scale — then attend over the pool.  The
        quantized scatter keeps the running-amax discipline of the JAX
        model: a page's scale is reset at its first write (offset 0),
        each token contributes the running amax of its row (a cummax
        over the chunk seeded from the previous page's scale), and the
        page takes the max (a scatter-max, so duplicate indices are
        order-free)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = self.heads, cfg.head_dim
        S, BS, MB = cfg.max_seq_len, kp.shape[2], step.tables.shape[1]
        # the pool's own dtype says whether it holds codes
        qmax = pool_qmax(kp.dtype)
        ks, vs = scales if qmax is not None else (None, None)
        # width 1: the fused decode kernel rotates q and k itself
        q, k, v = self._qkv(x, None if step.cos is None or s == 1 else (
            step.cos, step.sin))
        scale = d ** -0.5
        if s == 1:
            rope = {}
            if step.cos is not None:
                rope = dict(cos_b=step.cos[:, :, None, :],
                            sin_b=step.sin[:, :, None, :])
            o = paged_decode_fused(
                q, k, v, kp, vp, step.tables, step.cursors, max_seq_len=S,
                scale=scale, k_scales=ks, v_scales=vs,
                chunk_lens=None if qmax is None else step.chunk_lens,
                **rope)[0]
            return self.out_proj(o.reshape(b, 1, h * d))
        pos = step.positions
        tables = step.tables.long()
        phys = tables.gather(1, torch.clamp(pos // BS, max=MB - 1))
        phys = torch.where(pos < S, phys, torch.zeros_like(phys))
        off = pos % BS
        kT = k.permute(2, 0, 1, 3)                        # (hk, b, s, d)
        vT = v.permute(2, 0, 1, 3)
        if qmax is None:
            kp[:, phys, off] = kT.to(kp.dtype)
            vp[:, phys, off] = vT.to(vp.dtype)
            o = paged_attention(q, kp, vp, step.tables, step.cursors,
                                scale=scale)
            return self.out_proj(o.reshape(b, s, h * d))
        hk = kT.shape[0]
        real = (torch.arange(s, device=x.device)[None, :]
                < step.chunk_lens[:, None])               # (b, s)
        phys = torch.where(real, phys, torch.zeros_like(phys))
        cur = step.cursors.long()
        base = tables.gather(1, torch.clamp(
            torch.div(cur - 1, BS, rounding_mode="floor"), 0, MB - 1)[:, None])
        has_prefix = (cur > 0)[None, :, None]
        fresh = torch.where(off == 0, phys, torch.zeros_like(phys))
        idx = phys.reshape(1, -1).expand(hk, -1)
        for sc, xT in ((ks, kT), (vs, vT)):
            amax = xT.float().abs().amax(dim=-1)          # (hk, b, s)
            amax = torch.where(real[None], amax, torch.zeros_like(amax))
            seed = torch.where(has_prefix, sc[:, base], torch.zeros(
                (), device=x.device))                     # (hk, b, 1)
            run = torch.maximum(torch.cummax(amax, dim=2).values, seed)
            sc[:, fresh] = 0.0
            sc.scatter_reduce_(1, idx, run.reshape(hk, -1), "amax")
        kp[:, phys, off] = quantize_kv(kT, ks[:, phys], qmax, kp.dtype)
        vp[:, phys, off] = quantize_kv(vT, vs[:, phys], qmax, vp.dtype)
        o = paged_attention(q, kp, vp, step.tables, step.cursors,
                            scale=scale, k_scales=ks, v_scales=vs)
        return self.out_proj(o.reshape(b, s, h * d))


class ParallelMLP(nn.Module):
    """h → ffn (+ activation, gated for SwiGLU) → h."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.act = resolve_activation(cfg.activation, gelu_approximate=True)
        kw = dict(use_bias=cfg.add_bias_linear, dtype=cfg.dtype,
                  param_dtype=cfg.param_dtype, device=device,
                  sequence_parallel=cfg.sequence_parallel)
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


def _dropout(x, rate: float, seed: int, seq_chunk=None):
    """Inverted dropout with a mask drawn from a generator seeded by
    ``seed`` on ``x``'s device, so a recomputation draws it again.
    ``seq_chunk`` ``(rank, n)``: ``x`` is chunk ``rank`` of ``n`` along
    dim 1; the whole mask is drawn and the chunk's part kept, so the
    sharded run drops what the unsharded one drops."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    shape = list(x.shape)
    if seq_chunk is not None:
        shape[1] *= seq_chunk[1]
    keep = torch.rand(shape, generator=g, device=x.device) >= rate
    if seq_chunk is not None:
        keep = keep.narrow(1, seq_chunk[0] * x.shape[1], x.shape[1])
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
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x)); the MLP
    is a :class:`~apex_tpu_torch.transformer.moe.MoEMLP` under
    ``num_moe_experts``, and the layer then keeps the weighted
    load-balance term of its last forward in ``moe_aux`` (the
    counterpart of flax's ``sow("losses", ...)``)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        active, tp, rank = tensor_parallel()
        # the hidden dropout's chunk of the whole mask
        self.seq_chunk = ((rank, tp) if cfg.sequence_parallel and active
                          else None)
        # the MoE layer routes whole batch rows: under SP at tp > 1 it
        # runs on the gathered sequence (:meth:`_moe`)
        self.moe_whole_sequence = self.seq_chunk is not None and tp > 1
        self.input_norm = Norm(cfg, device, sequence_parallel=True)
        self.attention = ParallelAttention(cfg, device)
        self.post_attention_norm = Norm(cfg, device, sequence_parallel=True)
        self.moe_aux: Optional[torch.Tensor] = None
        if cfg.num_moe_experts:
            self.moe_mlp = MoEMLP(MoEConfig(
                num_experts=cfg.num_moe_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                hidden_size=cfg.hidden_size, ffn_hidden_size=cfg.ffn_size,
                activation=cfg.activation, gated=cfg.gated_mlp,
                use_bias=cfg.add_bias_linear,
                expert_axis=cfg.moe_expert_axis,
                aux_loss_weight=cfg.moe_aux_loss_weight, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype), device)
        else:
            self.mlp = ParallelMLP(cfg, device)

    def forward(self, x, cache_k=None, cache_v=None,
                step: Optional[DecodeStep] = None, *, mask_bias=None,
                rope=None, seeds: Optional[Sequence[int]] = None,
                scales=None):
        """``seeds``: this layer's (attention, hidden, hidden) dropout
        seeds, or None without dropout; ``scales``: the layer's paged
        pool scales (quantized pools)."""
        x, aux = self.block(x, cache_k, cache_v, step, mask_bias=mask_bias,
                            rope=rope, seeds=seeds, scales=scales)
        if aux is not None:
            self.moe_aux = aux
        return x

    def block(self, x, cache_k=None, cache_v=None,
              step: Optional[DecodeStep] = None, *, mask_bias=None,
              rope=None, seeds: Optional[Sequence[int]] = None,
              scales=None):
        """The layer as ``(x, aux)``, ``aux`` the MoE term or None; it
        records nothing, so a recomputation under remat leaves
        ``moe_aux`` alone."""
        rate = self.cfg.hidden_dropout
        a = self.attention(self.input_norm(x), cache_k, cache_v, step,
                           mask_bias=mask_bias, rope=rope,
                           attn_seed=None if seeds is None else seeds[0],
                           scales=scales)
        if seeds is not None and rate > 0.0:
            a = _dropout(a, rate, seeds[1], self.seq_chunk)
        x = x + a.to(x.dtype)
        h = self.post_attention_norm(x)
        aux = None
        if self.cfg.num_moe_experts:
            m, aux = self._moe(h)
        else:
            m = self.mlp(h)
        if seeds is not None and rate > 0.0:
            m = _dropout(m, rate, seeds[2], self.seq_chunk)
        return x + m.to(x.dtype), aux

    def _moe(self, h):
        """The MoE MLP.  Under sequence parallelism at tp > 1 the rank's
        sequence chunk is gathered first (its backward keeps the own
        chunk: every tensor rank ends with the whole input gradient), so
        the routing, the capacity and the aux term are those of the
        unsharded layer, which routes whole batch rows as the JAX layer
        does.  With the experts sharded over the tensor axis the ranks'
        parts of the output are reduce-scattered back to the chunk
        (:class:`~apex_tpu_torch.transformer.moe.MoEMLP`); with whole
        experts the output is cut back to the chunk (its backward
        all-gathers)."""
        if not self.moe_whole_sequence:
            return self.moe_mlp(h)
        whole = gather_from_tensor_parallel_region(h, dim=1)
        moe = self.moe_mlp
        if moe.ep_active and moe.cfg.expert_axis == TENSOR_AXIS:
            return moe(whole, seq_scatter_dim=1)
        m, aux = moe(whole)
        return scatter_to_sequence_parallel_region(m, dim=1), aux


@contextlib.contextmanager
def _stacked(*contexts):
    """One context entering ``contexts`` in order when it is entered."""
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def remat_context_fn(policy: str) -> Callable:
    """A ``context_fn`` for non-reentrant ``torch.utils.checkpoint``:
    the selective-checkpoint pair of ``policy`` (ops whose outputs are
    kept rather than recomputed), composed with the O1 intercept active
    now, under which the recomputation reruns."""
    o1_fn = o1.checkpoint_context_fn()
    saves = remat_saves(policy)
    if saves is None:
        return o1_fn

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saves
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def context_fn():
        fwd, rec = create_selective_checkpoint_contexts(policy_fn)
        o1_fwd, o1_rec = o1_fn()
        return _stacked(fwd, o1_fwd), _stacked(rec, o1_rec)
    return context_fn


class ParallelTransformer(nn.Module):
    """``num_layers`` stacked layers: over the full sequence (under
    ``remat`` each layer recomputed in the backward as ``remat_policy``
    says, but for every ``remat_skip_every``-th), or over a stacked KV
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
            quantized = "key_scales" in cache
            for i, layer in enumerate(self.layers):
                x = layer(x, cache["key"][i], cache["value"][i], step,
                          scales=(cache["key_scales"][i],
                                  cache["value_scales"][i])
                          if quantized else None)
            return x
        cfg = self.cfg
        remat = (cfg.remat and torch.is_grad_enabled()
                 and remat_saves(cfg.remat_policy) != "all")
        context_fn = remat_context_fn(cfg.remat_policy) if remat else None
        k = cfg.remat_skip_every
        for i, layer in enumerate(self.layers):
            kw = dict(mask_bias=mask_bias, rope=rope,
                      seeds=None if seeds is None else seeds[i])
            if remat and not (k and i % k == 0):
                # the recomputation reruns `block`, which records
                # nothing: the MoE term stays the first forward's
                x, aux = checkpoint(layer.block, x, use_reentrant=False,
                                    context_fn=context_fn, **kw)
                if aux is not None:
                    layer.moe_aux = aux
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
