"""GPT — decoder-only language model.

Counterpart of ``apex_tpu/models/gpt.py``: token embedding (plus learned
absolute positions for GPT-2-style configs), the stacked transformer,
the final norm and a tied or untied vocabulary head.  Without a cache
the forward runs the full sequence with causal flash attention (the JAX
module's ``decode=False``, the training forward); with one it is the
decode-mode forward: it runs ``input_ids`` against the KV cache, writes
their K/V and advances the cache index.  Logits ``(batch, seq, vocab)``
in ``cfg.dtype`` either way.

Built on a mesh (:mod:`apex_tpu_torch.core.mesh`), the training forward
is tensor-parallel: the embedding and head are sharded by vocabulary, so
the logits are this rank's ``(batch, seq, vocab / tp)`` slice, which
:func:`gpt_loss_fn` reduces with the vocab-parallel cross entropy when
the tensor group has more than one rank.  Under ``sequence_parallel``
the embeddings are cut into the rank's chunk of the sequence before the
layers and the final norm's output is all-gathered into the head.
The decode forwards (dense or paged cache) gather the vocabulary shards,
so their logits are whole on every tensor rank (tensor-parallel
serving).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from apex_tpu_torch.models.transformer import (
    DecodeStep,
    Norm,
    PagedStep,
    ParallelTransformer,
    TransformerConfig,
    dropout_seeds,
    init_module_weights,
)
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.ops.xentropy import mean_cross_entropy
from apex_tpu_torch.ops.rope import rope_cos_sin
from apex_tpu_torch.transformer import mappings
from apex_tpu_torch.transformer.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.layers import (
    ColumnParallelLinear,
    VocabParallelEmbedding,
    tensor_parallel,
)

__all__ = ["GPTConfig", "GPTModel", "gpt_loss_fn", "moe_aux_loss",
           "gpt_pipeline_forward_backward"]


@dataclasses.dataclass(frozen=True)
class GPTConfig(TransformerConfig):
    """GPT presets (reference workload: GPT-2 1.3B)."""

    tie_embeddings: bool = True

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("max_seq_len", 256)
        return cls(**kw)

    @classmethod
    def gpt2_1p3b(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 50304)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("max_seq_len", 2048)
        kw.setdefault("position_embedding", "learned")
        return cls(**kw)


class GPTModel(nn.Module):
    """Decoder-only LM on ``device`` (default ``"cuda"``; raises when
    CUDA is unavailable unless ``device="cpu"``).  Parameters are
    allocated uninitialized: load a state dict
    (:func:`~apex_tpu_torch.models.jax_import.params_from_jax`) or call
    :meth:`init_weights`."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embedding = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=dev)
        if cfg.position_embedding == "learned":
            self.position_embedding = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.hidden_size, dtype=cfg.param_dtype,
                device=dev))
        else:
            self.register_parameter("position_embedding", None)
        self.transformer = ParallelTransformer(cfg, dev)
        self.final_norm = Norm(cfg, dev, sequence_parallel=True)
        # the activations between the blocks are sequence chunks
        self.sequence_parallel = (cfg.sequence_parallel
                                  and tensor_parallel()[0])
        # built on a mesh: the head's logits are vocabulary shards
        self.vocab_parallel = tensor_parallel()[0]
        self.lm_head = None if cfg.tie_embeddings else ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, use_bias=False,
            sequence_parallel=cfg.sequence_parallel,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=dev)
        if cfg.position_embedding == "rope":
            cos, sin = rope_cos_sin(cfg.max_seq_len, cfg.rot_dim,
                                    base=cfg.rope_base, device=dev)
        else:
            cos = sin = torch.empty(0, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (on the model's device):
        normal embeddings (std 0.02), fan-in-scaled linears, unit
        norms with zero bias."""
        init_module_weights(self, generator)
        if self.position_embedding is not None:
            with torch.no_grad():
                self.position_embedding.normal_(0.0, 0.02,
                                                generator=generator)

    def forward(self, input_ids, *, cache=None, kv_len: Optional[int] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None,
                last_index: Optional[torch.Tensor] = None):
        """Logits of ``input_ids`` (b, s).

        Without ``cache``: the full sequence, causal (``deterministic=
        False`` with an integer ``dropout_seed`` turns the config's
        dropouts on).  With ``cache`` (from :func:`~apex_tpu_torch.
        models.generate.init_cache`): decode, each row at its own cache
        index; ``kv_len`` bounds the cache slots any row can see after
        this call (``max(index) + s``; default the whole cache).  A
        paged pool (:func:`~apex_tpu_torch.models.generate.
        init_paged_cache`, told apart by its ``block_tables``) runs the
        paged decode: the caller sets ``block_tables`` / ``cursors`` /
        ``chunk_lens`` before the call, and the model never advances
        them.  ``last_index``
        (b,) picks one position per row before the head: logits are then
        ``(b, 1, vocab)``."""
        if cache is None:
            return self._full(input_ids, deterministic, dropout_seed)
        if "block_tables" in cache:
            return self._paged(input_ids, cache, last_index)
        cfg = self.cfg
        b, s = input_ids.shape
        index = cache["index"]
        positions = index[:, None].long() + torch.arange(
            s, device=input_ids.device)
        clamped = positions.clamp(max=cfg.max_seq_len - 1)
        step = DecodeStep(index=index.long(), positions=positions,
                          kv_len=int(kv_len or cfg.max_seq_len))
        ring = cache.get("slot_positions")
        if ring is not None:
            self._ring_step(step, ring, s)
        if cfg.position_embedding == "rope":
            step.cos = self.rope_cos[clamped]
            step.sin = self.rope_sin[clamped]
        x = self.embedding(input_ids)
        if self.position_embedding is not None:
            x = x + self.position_embedding[clamped].to(x.dtype)
        x = x.to(cfg.dtype)
        x = self.transformer(x, cache, step)
        if ring is not None:
            rows = torch.arange(b, device=ring.device)[:, None]
            tail = step.slots.shape[1]
            ring[rows, step.slots] = (positions[:, s - tail:] + 1).to(
                ring.dtype)
        index += s
        return self._decode_logits(x, last_index)

    @staticmethod
    def _ring_step(step: DecodeStep, ring, s: int):
        """The ring slots this call writes and the slot positions the
        layers read (``DecodeStep``): after the write for one token,
        before it for a chunk."""
        W = ring.shape[1]
        tail = min(s, W)
        written = step.positions[:, s - tail:]
        step.slots = written % W
        key_pos = ring.long() - 1
        if s == 1:
            rows = torch.arange(ring.shape[0], device=ring.device)[:, None]
            key_pos = key_pos.clone()
            key_pos[rows, step.slots] = written
        step.key_positions = key_pos

    def _paged(self, input_ids, cache, last_index):
        cfg = self.cfg
        b, s = input_ids.shape
        cursors = cache["cursors"]
        positions = cursors[:, None].long() + torch.arange(
            s, device=input_ids.device)
        # pad positions clamp into the tables: their K/V is unreachable
        clamped = positions.clamp(max=cfg.max_seq_len - 1)
        step = PagedStep(tables=cache["block_tables"], cursors=cursors,
                         chunk_lens=cache["chunk_lens"], positions=positions)
        if cfg.position_embedding == "rope":
            step.cos = self.rope_cos[clamped]
            step.sin = self.rope_sin[clamped]
        x = self.embedding(input_ids)
        if self.position_embedding is not None:
            x = x + self.position_embedding[clamped].to(x.dtype)
        x = self.transformer(x.to(cfg.dtype), cache, step)
        return self._decode_logits(x, last_index)

    def _decode_logits(self, x, last_index):
        """Decode logits over the whole vocabulary: on a mesh the head's
        vocabulary shards are all-gathered, so a sampler on every tensor
        rank draws from the same logits."""
        logits = self._head(x, last_index)
        if self.vocab_parallel:
            logits = mappings.gather_from_tensor_parallel_region(logits,
                                                                 dim=-1)
        return logits

    def _head(self, x, last_index=None, sequence_parallel=False):
        if last_index is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        x = self.final_norm(x).to(self.cfg.dtype)
        if self.lm_head is None:
            return self.embedding.attend(x, sequence_parallel)
        return self.lm_head(x)

    def embed(self, input_ids):
        """The layers' input of the full-sequence forward: the token
        embeddings plus the learned positions, in ``cfg.dtype``, this
        rank's sequence chunk under sequence parallelism.  With
        :meth:`head` it is the closure of a pipeline whose stages run
        the layers in between (``num_layers=0`` and an untied head make
        a model of just the two)."""
        cfg = self.cfg
        s = input_ids.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds max_seq_len {cfg.max_seq_len}")
        x = self.embedding(input_ids)
        if self.position_embedding is not None:
            x = x + self.position_embedding[None, :s].to(x.dtype)
        x = x.to(cfg.dtype)
        if self.sequence_parallel:
            x = mappings.scatter_to_sequence_parallel_region(x, dim=1)
        return x

    def head(self, x):
        """Logits of the last layer's output ``x`` of the full-sequence
        forward (the final norm, then the vocabulary head)."""
        return self._head(x, sequence_parallel=self.sequence_parallel)

    def _full(self, input_ids, deterministic, dropout_seed):
        cfg = self.cfg
        x = self.embed(input_ids)
        rope = None
        if cfg.position_embedding == "rope":
            s = input_ids.shape[1]
            rope = (self.rope_cos[:s], self.rope_sin[:s])
        x = self.transformer(x, rope=rope, seeds=dropout_seeds(
            cfg, deterministic, dropout_seed))
        return self.head(x)


def gpt_loss_fn(logits, labels, *, ignore_index: int = -100):
    """Next-token CE averaged over valid tokens (fp32).  When a mesh's
    tensor group has more than one rank the logits are this rank's
    vocabulary slice, and the loss is the vocab-parallel cross entropy's
    (:func:`~apex_tpu_torch.transformer.cross_entropy.
    vocab_parallel_cross_entropy`), the same on every tensor rank."""
    if tensor_parallel()[1] == 1:
        return mean_cross_entropy(logits, labels, ignore_index=ignore_index)
    valid = labels != ignore_index
    nll = vocab_parallel_cross_entropy(
        logits, torch.where(valid, labels, torch.zeros_like(labels)))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp_min(valid.sum(), 1).float()


def gpt_pipeline_forward_backward(closure: GPTModel, stage_fn, stage,
                                  input_ids, labels, *,
                                  num_microbatches: int, scale_loss=None,
                                  axis: str = "pipe"):
    """The forward and backward of a GPT whose layers run in the 1F1B
    pipeline (``parallel.pipeline.run_1f1b`` over this rank's
    ``stage``, applied by ``stage_fn`` from ``build_model``) with the
    embedding, positions, final norm and head closed over the pipelined
    region.  ``closure`` is a :class:`GPTModel` of no layers with an
    untied head (the layout of the JAX GPT-2 3D train step).

    ``input_ids`` / ``labels`` ``(M·mb, s)`` are cut into
    ``num_microbatches``.  Each microbatch's embedding output enters the
    schedule detached; the final norm's and the head's parameters are
    its ``loss_params``; after the schedule each embedding output is
    backpropagated with its input cotangent, in microbatch order.  So
    every parameter's ``.grad``, the closure's and the stage's,
    accumulates the gradient of the mean microbatch loss, the same
    gradients as ``forward_backward_no_pipelining`` over the whole
    model.  ``scale_loss`` (e.g. a train state's ``scale_loss``) maps
    each microbatch's cross entropy to the loss differentiated.

    Returns ``(loss, scaled)`` on every pipe rank: the mean microbatch
    cross entropy, and the schedule's mean of the scaled losses."""
    from apex_tpu_torch.parallel.pipeline import run_1f1b
    from apex_tpu_torch.transformer.pipeline_parallel import schedules

    m = num_microbatches
    ids_mb, lab_mb = input_ids.chunk(m), labels.chunk(m)
    hs = [closure.embed(i) for i in ids_mb]
    ces = []

    def loss_fn(loss_params, y, i):
        ce = gpt_loss_fn(closure.head(y).float(), lab_mb[i])
        ces.append(ce.detach())
        return ce if scale_loss is None else scale_loss(ce)

    scaled, _, aux = run_1f1b(
        stage_fn, loss_fn, stage, torch.stack([h.detach() for h in hs]),
        axis=axis, return_input_cotangents=True,
        loss_params=[*closure.final_norm.parameters(),
                     closure.lm_head.weight])
    for h, ct in zip(hs, aux["input_cotangents"]):
        h.backward(ct)
    rank, pp = schedules.pipe_rank_and_size(axis)
    loss = (torch.stack(ces).mean() if rank == pp - 1 else torch.zeros(
        (), dtype=torch.float32, device=input_ids.device))
    return schedules._broadcast(loss, pp - 1, axis), scaled


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the load-balance terms the MoE layers of ``model``
    recorded in their last forward (each already carries
    ``moe_aux_loss_weight``); fp32, 0 for a model without MoE layers.

    Usage with ``num_moe_experts`` configs::

        logits = model(ids)
        loss = gpt_loss_fn(logits, labels) + moe_aux_loss(model)
    """
    terms = [m.moe_aux.float() for m in model.modules()
             if getattr(m, "moe_aux", None) is not None]
    if not terms:
        dev = next(iter(model.parameters())).device
        return torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack(terms).sum()
