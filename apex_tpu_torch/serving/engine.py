"""Continuous-batching decode engines: the slotted dense KV cache and
the paged pool.

Counterpart of ``apex_tpu/serving/engine.py``.  The dense
:class:`Engine` below; the paged :class:`PagedEngine` further down (its
own docstring).  The dense engine serves one model to ``max_slots``
tenants:

- ``admit`` prefills the prompt, right-padded to its length bucket,
  into a one-row scratch cache through the shared prefill path
  (:func:`apex_tpu_torch.models.generate.prefill_tokens`), rewinds the
  cursor to ``true_len - 1`` (the first decode step re-feeds the last
  real prompt token), copies the row into the pool and installs the
  tenant's sampling parameters;
- ``step`` runs ONE batched decode-mode forward over all slots, each at
  its own cursor, then samples every row with
  :func:`~apex_tpu_torch.ops.fused_sampling.fused_sample` on keys split
  from the slots' threefry keys — the fused sampling kernel on the card;
- ``release`` zeroes the slot row and clears its active bit.

Greedy decoding through the engine is token-identical to the port's
``generate()`` (same prefill path, same fp32 argmax), and sampled
tokens equal the JAX engine's for the same prompts and seeds: the keys
are split and consumed as ``engine.py`` does there.

The host keeps a mirror of every slot's cursor, so attention reads only
the live prefix of the cache (``kv_len``) without a device-to-host read;
the one sync per step is ``step()`` reading the sampled tokens and the
finished flags back together.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import TENSOR_AXIS
from apex_tpu_torch.models.generate import (
    apply_decode,
    init_cache,
    init_paged_cache,
    prefill_tokens,
)
from apex_tpu_torch.ops.paged_attention import (
    kv_quant_spec,
    kv_store_bytes_per_token,
    tp_head_shards,
)
from apex_tpu_torch.ops.fused_sampling import (
    fused_sample,
    fused_sample_reference,
    split,
)
from apex_tpu_torch.serving import cache as slot_cache
from apex_tpu_torch.utils.metrics import counters

__all__ = ["Engine", "PagedEngine", "StepOutput", "sample_dynamic",
           "prompt_lookup_draft", "DEFAULT_BUCKETS", "tp_mesh"]

DEFAULT_BUCKETS: Tuple[int, ...] = (32, 128, 512)


class StepOutput(NamedTuple):
    """One :class:`PagedEngine` step's host-visible result.

    ``tokens`` ``(max_slots, width)``: a speculative step can emit
    several tokens per slot; ``counts[i]`` of row i's are real this step
    (0 for a tenant still prefilling).  ``finished[i]`` latches on row
    i's last emitted token; ``emitted`` is ``counts > 0``.
    ``preempted`` lists slots evicted for block exhaustion before the
    step ran (pages and slot state already released; the scheduler
    requeues them).  The dense engine's ``step`` returns a plain
    ``(tokens, finished)`` pair."""

    tokens: np.ndarray
    finished: np.ndarray
    emitted: np.ndarray
    preempted: Tuple[int, ...]
    counts: np.ndarray


def sample_dynamic(logits, keys, temperature, top_k, top_p,
                   vocab_size: int):
    """Per-row sampling with tensor parameters: the plain composition
    behind :func:`~apex_tpu_torch.ops.fused_sampling.fused_sample`
    (the JAX engines' ``sample_dynamic``)."""
    return fused_sample_reference(logits, keys, temperature, top_k, top_p,
                                  vocab_size)


def prompt_lookup_draft(context, k: int, max_ngram: int = 3) -> np.ndarray:
    """Up to ``k`` draft tokens by prompt lookup: the tokens that followed
    the most recent earlier occurrence of the context's trailing n-gram
    (longest ``n <= max_ngram`` first); empty when nothing matches."""
    context = np.asarray(context, np.int32).reshape(-1)
    n_ctx = int(context.size)
    if k < 1 or n_ctx < 2:
        return np.empty((0,), np.int32)
    for n in range(min(int(max_ngram), n_ctx - 1), 0, -1):
        pattern = context[n_ctx - n:]
        windows = np.lib.stride_tricks.sliding_window_view(
            context[:n_ctx - 1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n
            drafts = context[start:start + int(k)]
            if drafts.size:
                return drafts.astype(np.int32)
    return np.empty((0,), np.int32)


def tp_mesh(tp: int):
    """A one-replica tensor-parallel serving mesh: ``tp`` ranks on the
    ``tensor`` axis of the initialized process group (the data axis
    takes the rest).  The current mesh when its tensor axis already has
    ``tp`` ranks, else a new one made current (a collective call) — the
    model must be built on it, since its layers hold their rank's
    shards.  Raises when the process group has fewer than ``tp``
    ranks."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < tp:
        raise ValueError(
            f"tp={tp} needs {tp} devices (processes of the initialized "
            f"process group), only {world} available")
    if mesh_lib.mesh_is_initialized() \
            and mesh_lib.get_mesh().shape[TENSOR_AXIS] == tp:
        return mesh_lib.get_mesh()
    return mesh_lib.initialize_mesh(tensor_model_parallel_size=tp)


def _serving_mesh(mesh, model):
    """``(mesh, tp)`` of a paged engine from its ``mesh=`` argument, with
    the JAX engine's gates: an int ≤ 1 (or None) is the single-chip
    engine ``(None, 1)``; an int > 1 goes through :func:`tp_mesh`; a
    mesh without a tensor axis, ``kv_heads % tp`` and a model not built
    on a tensor axis of ``tp`` ranks raise ``ValueError``.  A mesh passed
    in runs the tensor-parallel code even when its tensor axis has one
    rank (the collectives then move nothing)."""
    cfg = model.cfg
    if mesh is None or (isinstance(mesh, int) and mesh <= 1):
        return None, 1
    if isinstance(mesh, int):
        tp_head_shards(cfg.num_heads, cfg.kv_heads, mesh)
        mesh = tp_mesh(mesh)
    shape = dict(getattr(mesh, "shape", {}) or {})
    if TENSOR_AXIS not in shape:
        raise ValueError(
            f"mesh has no {TENSOR_AXIS!r} axis (axes: "
            f"{tuple(getattr(mesh, 'axis_names', ()))}) — build the "
            f"serving mesh with serving.tp_mesh(tp), or pass an int")
    tp = int(shape[TENSOR_AXIS])
    tp_head_shards(cfg.num_heads, cfg.kv_heads, tp)
    built = {int(m.tp_size) for m in model.modules()
             if hasattr(m, "tp_size") and hasattr(m, "kv_heads")}
    if built and built != {tp}:
        raise ValueError(
            f"the model's layers are built on a tensor axis of "
            f"{sorted(built)} ranks, the mesh's has {tp}: build the model "
            f"on the serving mesh")
    return mesh, tp


def _check_sampling(vocab_size: int, top_k, top_p) -> None:
    if top_k is not None and top_k != 0 \
            and not 1 <= top_k <= vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={vocab_size}] "
            f"(or 0/None to disable), got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1] (or None to disable), "
            f"got {top_p}")


class Engine:
    """Multi-tenant KV-cached decode over one model (on the model's
    device).  Host API, single-threaded (the server's worker owns it):
    :meth:`admit`, :meth:`step`, :meth:`release`, :meth:`warmup`."""

    #: dense slab layout — :class:`PagedEngine` is the paged twin
    paged = False

    def __init__(self, model, *, max_slots: int = 4,
                 prompt_buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefill_chunk: int = 0):
        cfg = getattr(model, "cfg", None)
        if cfg is None or not hasattr(cfg, "max_seq_len"):
            raise ValueError(
                "Engine needs a model with a .cfg carrying max_seq_len "
                "and vocab_size (GPTModel / LlamaModel contract)")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq_len = int(cfg.max_seq_len)
        self.vocab_size = int(cfg.vocab_size)
        buckets = sorted({int(b) for b in prompt_buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"prompt_buckets must be positive, got {prompt_buckets}")
        if buckets[-1] >= self.max_seq_len:
            raise ValueError(
                f"largest prompt bucket ({buckets[-1]}) must be < "
                f"max_seq_len ({self.max_seq_len}) — the cache must "
                f"hold prompt + generated tokens")
        self.prompt_buckets = tuple(buckets)
        self._prefill_chunk = int(prefill_chunk)
        self._scratch = init_cache(model, 1)
        slot_cache.validate_cache_tree(self._scratch)
        self.cache = init_cache(model, self.max_slots)
        self.state = slot_cache.init_slot_state(self.max_slots, self.device)
        # host mirrors: each slot's cache cursor and occupancy
        self._cursor = np.zeros(self.max_slots, np.int64)
        self._active = np.zeros(self.max_slots, bool)

    # ------------------------------------------------------------- host
    def bucket_for(self, prompt_len: int) -> int:
        """Smallest configured bucket holding ``prompt_len`` tokens."""
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest "
            f"prompt bucket ({self.prompt_buckets[-1]}); configure "
            f"larger prompt_buckets")

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt=None) -> bool:
        """The slab reserves a whole row per slot: a free slot is always
        admissible."""
        del prompt_len, max_new_tokens, prompt
        return True

    def validate_request(self, prompt_len: int, max_new_tokens: int,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None) -> int:
        """Static admission checks; returns the prompt's bucket."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        bucket = self.bucket_for(prompt_len)
        if prompt_len + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt_len ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        _check_sampling(self.vocab_size, top_k, top_p)
        del temperature      # any float is admissible (<=0 -> greedy)
        return bucket

    @torch.no_grad()
    def admit(self, slot: int, prompt, *, max_new_tokens: int,
              temperature: float = 0.0, top_k: Optional[int] = None,
              top_p: Optional[float] = None,
              eos_id: Optional[int] = None, seed: int = 0) -> None:
        """Prefill ``prompt`` (1-D int tokens) and install it in
        ``slot``; admitting over an occupied slot replaces the tenant."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bucket = self.validate_request(
            prompt.shape[0], max_new_tokens, temperature, top_k, top_p)
        if not 0 <= slot < self.max_slots:
            raise ValueError(
                f"slot must be in [0, {self.max_slots}), got {slot}")
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :prompt.shape[0]] = prompt
        one = self._scratch
        for t in one.values():
            t.zero_()
        prefill_tokens(self.model, one,
                       torch.from_numpy(padded).to(self.device),
                       self._prefill_chunk)
        slot_cache.rewind_index(one, prompt.shape[0] - 1)
        slot_cache.write_slot(self.cache, slot, one)
        slot_cache.admit_slot(
            self.state, slot, int(prompt[-1]), max_new_tokens,
            temperature, top_k or 0, 0.0 if top_p is None else top_p,
            -1 if eos_id is None else eos_id, seed)
        self._cursor[slot] = prompt.shape[0] - 1
        self._active[slot] = True

    @torch.no_grad()
    def step(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decode one token for every slot.

        Returns ``(tokens, finished)`` — numpy, length ``max_slots``.
        ``finished[i]`` latches when slot i produced its eos or spent
        its budget this step; the caller should :meth:`release` it.
        """
        st = self.state
        logits, _ = apply_decode(self.model, self.cache, st.tok[:, None],
                                 kv_len=int(self._cursor.max()) + 1)
        keys = split(st.rng)                          # (slots, 2, 2)
        # released slots' stale filter parameters are masked, as in the
        # JAX engine: their tokens are discarded either way
        top_k = torch.where(st.active, st.top_k, torch.zeros_like(st.top_k))
        top_p = torch.where(st.active, st.top_p, torch.zeros_like(st.top_p))
        nxt = fused_sample(logits[:, -1], keys[:, 0], st.temperature,
                           top_k, top_p, vocab_size=self.vocab_size)
        produced = st.produced + st.active.to(torch.int32)
        hit_budget = produced >= st.budget
        hit_eos = (st.eos_id >= 0) & (nxt == st.eos_id)
        finished = st.active & (hit_budget | hit_eos)
        st.tok = torch.where(st.active, nxt, st.tok)
        st.produced = produced
        st.active = st.active & ~finished
        st.rng = keys[:, 1].contiguous()
        # the step's one device-to-host read: tokens and flags together
        out = torch.stack([nxt, finished.to(torch.int32)]).cpu().numpy()
        toks, fin = out[0], out[1].astype(bool)
        # cursors of free slots stay at 0 so their garbage rows never
        # run past the cache
        self._cursor += 1
        self._active &= ~fin
        idle = torch.from_numpy(~self._active).to(self.device)
        self.cache["index"].masked_fill_(idle, 0)
        self._cursor[~self._active] = 0
        return toks, fin

    @torch.no_grad()
    def release(self, slot: int) -> None:
        """Zero and free ``slot``."""
        slot_cache.reset_slot(self.cache, slot)
        slot_cache.release_slot(self.state, slot)
        self._cursor[slot] = 0
        self._active[slot] = False

    def warmup(self) -> None:
        """One dummy tenant per prompt bucket through admit → step →
        release: builds the kernels and warms every code path before
        the first real request."""
        for bucket in self.prompt_buckets:
            self.admit(0, np.zeros((bucket,), np.int32), max_new_tokens=1)
            self.step()
            self.release(0)


# --------------------------------------------------------------------- #
# paged engine — the token-granular serving datapath
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _Tenant:
    """Host record of one slot's tenant (the card sees only the tables
    and cursors built from it)."""

    prompt: np.ndarray          # full prompt tokens
    fed: int = 0                # prompt tokens already fed
    cursor: int = 0             # tokens written into the pool
    blocks: List[int] = dataclasses.field(default_factory=list)
    seq: int = 0                # admission order (preemption key)
    budget: int = 0             # max_new_tokens
    emitted: int = 0            # tokens emitted so far
    gen: List[int] = dataclasses.field(default_factory=list)
    digests: List[bytes] = dataclasses.field(default_factory=list)
    registered: int = 0         # prompt blocks offered to the trie


class PagedEngine:
    """Continuous batching over a paged KV pool (counterpart of the JAX
    ``PagedEngine``).

    K/V live in ``block_size``-token pages of one pool per layer, sized
    in tokens (``pool_tokens``) and shared by the tenants through
    per-slot block tables (:class:`~apex_tpu_torch.serving.cache.
    BlockAllocator`, block 0 the null page), so memory and per-step
    attention bytes scale with live tokens.  Every step is ONE model
    application over the ragged batch:

    - prompts are fed in ``prefill_chunk``-token pieces inside the step,
      beside decoding tenants (chunked prefill); a tenant emits its
      first token with its last chunk;
    - admission is token-gated (:meth:`can_admit`: free pages must cover
      the prompt plus ``admit_headroom`` tokens), and a step that runs
      out of pages preempts the youngest tenant, reported in
      :class:`StepOutput` ``preempted`` for the scheduler to requeue;
    - ``share_prefixes`` maps trie-resident full prompt blocks of a new
      prompt refcounted instead of recomputing them; a whole-prompt hit
      re-feeds its last block into a private page (copy-on-write by
      recompute, counted in ``cow_forks``), and a write that would land
      in a read-only page swaps in a private one first;
    - ``spec_tokens = K`` drafts up to K tokens per decoding row by
      prompt lookup and verifies ``[current, d_1..d_K]`` in one
      application; the longest draft prefix matching the sampled chain
      plus one token is emitted and the cursor rolls back over the
      rest; the k-th emitted token always consumes the k-th key split,
      so greedy and sampled chains equal one-token decoding;
    - ``kv_dtype`` "int8" / "fp8" stores 1-byte codes with per-page
      scales; the default pool then holds the dense slab's bytes
      (``max_slots × max_seq_len`` tokens at the compute dtype) in coded
      tokens.

    Width-1 steps go through the fused decode kernel, wider ones through
    the paged attention kernel.  Each step copies its host inputs (feed,
    token counts, prefill and emit flags, tables, cursors) to the card
    in one transfer and reads tokens, counts and finished flags back in
    one.  ``block_size=0`` means 16 and ``kv_dtype="auto"`` means
    unquantized (the port has no tuning table yet).

    ``mesh``: an int (the tensor-parallel degree; ≤ 1 is the single-chip
    engine) or a :class:`~apex_tpu_torch.core.mesh.Mesh` with a tensor
    axis, on which the model was built.  The engine is then SPMD: every
    tensor rank holds the same host state (scheduler, allocator, trie,
    tables), is driven by the same calls in the same order, and holds
    its ``kv_heads / tp`` heads of every page; the model's decode logits
    are gathered over the vocabulary, so the sampled tokens are the same
    on every rank.  :attr:`chips_per_replica` and :attr:`mesh_shape` are
    the JAX engine's gauges.
    """

    paged = True

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 0,
                 pool_tokens: Optional[int] = None, prefill_chunk: int = 32,
                 admit_headroom: Optional[int] = None,
                 share_prefixes: bool = False, spec_tokens: int = 0,
                 spec_ngram: int = 3, kv_dtype: Optional[str] = None,
                 mesh=None):
        cfg = getattr(model, "cfg", None)
        if cfg is None or not hasattr(cfg, "max_seq_len"):
            raise ValueError(
                "PagedEngine needs a model with a .cfg carrying max_seq_len "
                "and vocab_size (GPTModel / LlamaModel contract)")
        if not getattr(cfg, "causal", True):
            raise ValueError("PagedEngine requires a causal model")
        if getattr(cfg, "sliding_window", None) is not None:
            raise ValueError(
                "PagedEngine does not support sliding-window models — "
                "the paged pool already bounds decode memory to live "
                "tokens; serve with sliding_window=None")
        self.mesh, self.tp = _serving_mesh(mesh, model)
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq_len = int(cfg.max_seq_len)
        self.vocab_size = int(cfg.vocab_size)
        self._chunk = int(prefill_chunk)
        self.share_prefixes = bool(share_prefixes)
        self.spec_tokens = int(spec_tokens)
        self.spec_ngram = int(spec_ngram)
        self._drafter = prompt_lookup_draft
        if kv_dtype == "auto":
            kv_dtype = None
        store_dt, _ = kv_quant_spec(kv_dtype)
        self.kv_dtype = kv_dtype
        #: pool storage bits per K/V element
        self.kv_bits = 8 * torch.empty(
            (), dtype=cfg.dtype if store_dt is None else store_dt
        ).element_size()
        block_size = int(block_size) or 16
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        if pool_tokens is None:
            pool_tokens = self.max_slots * self.max_seq_len
            if store_dt is not None:
                # equal bytes: the dense slab's budget in coded tokens
                unq = kv_store_bytes_per_token(cfg.head_dim, block_size,
                                               dtype=cfg.dtype)
                qnt = kv_store_bytes_per_token(cfg.head_dim, block_size,
                                               kv_dtype)
                pool_tokens = int(pool_tokens * unq / qnt)
        min_tokens = min(self._chunk + 3 + self.spec_tokens,
                         self.max_seq_len)
        if pool_tokens < min_tokens:
            raise ValueError(
                f"pool_tokens ({pool_tokens}) must cover at least the "
                f"warmup tenant ({min_tokens} tokens)")
        num_blocks = slot_cache.blocks_for(pool_tokens, block_size) + 1
        self._alloc = slot_cache.BlockAllocator(num_blocks, block_size)
        self._trie = slot_cache.PrefixTrie()
        self.cow_forks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._headroom = (2 * block_size if admit_headroom is None
                          else int(admit_headroom))
        self.cache = init_paged_cache(model, self.max_slots,
                                      block_size=block_size,
                                      num_blocks=num_blocks,
                                      kv_dtype=kv_dtype)
        self.state = slot_cache.init_slot_state(self.max_slots, self.device)
        mb = slot_cache.blocks_for(self.max_seq_len, block_size)
        self._tables = np.zeros((self.max_slots, mb), np.int32)
        self._cursors = np.zeros((self.max_slots,), np.int32)
        self._tenants: List[Optional[_Tenant]] = [None] * self.max_slots
        self._admit_seq = 0

    # ------------------------------------------------------------- host
    def validate_request(self, prompt_len: int, max_new_tokens: int,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None) -> None:
        """Static admission checks: the request must fit the cache and,
        alone, the pool."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt_len + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt_len ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        need = slot_cache.blocks_for(prompt_len + max_new_tokens,
                                     self.block_size)
        if need > self._alloc.blocks_total:
            raise ValueError(
                f"request needs {need} pages ({prompt_len}+{max_new_tokens} "
                f"tokens at block_size={self.block_size}) but the whole "
                f"pool holds {self._alloc.blocks_total} — raise pool_tokens")
        _check_sampling(self.vocab_size, top_k, top_p)
        del temperature

    def _match(self, prompt: np.ndarray):
        """``(digests, matched, n_share)``: the prompt's block digests,
        the pages of its leading run resident in the trie, and how many
        of them to map — capped so the last prompt token is always
        re-fed (the logits source)."""
        digests = slot_cache.chain_digests(prompt, self.block_size)
        matched = self._trie.match(digests)
        return digests, matched, min(len(matched),
                                     (int(prompt.size) - 1) // self.block_size)

    def prefix_hit_blocks(self, prompt) -> int:
        """Pages of ``prompt``'s prefix resident in the trie (0 with
        sharing off)."""
        if not self.share_prefixes:
            return 0
        return self._match(np.asarray(prompt, np.int32).reshape(-1))[2]

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt=None) -> bool:
        """Free pages must cover the prompt plus the decode headroom;
        trie-resident prefix pages (with ``prompt`` given) cost
        nothing."""
        shared = 0 if prompt is None else self.prefix_hit_blocks(prompt)
        need = slot_cache.blocks_for(
            prompt_len + min(int(max_new_tokens), self._headroom),
            self.block_size) - shared
        return self._alloc.blocks_free >= need

    def admit(self, slot: int, prompt, *, max_new_tokens: int,
              temperature: float = 0.0, top_k: Optional[int] = None,
              top_p: Optional[float] = None,
              eos_id: Optional[int] = None, seed: int = 0) -> None:
        """Install one request into a free slot.  No prefill and no page
        allocation happen here (the steps feed the prompt and extend
        the table); shared prefix pages are mapped here."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.validate_request(prompt.shape[0], max_new_tokens, temperature,
                              top_k, top_p)
        if not 0 <= slot < self.max_slots:
            raise ValueError(
                f"slot must be in [0, {self.max_slots}), got {slot}")
        if self._tenants[slot] is not None:
            raise ValueError(f"slot {slot} is occupied (the tenant owns "
                             "pool pages)")
        self._admit_seq += 1
        rec = _Tenant(prompt=prompt, seq=self._admit_seq,
                      budget=int(max_new_tokens))
        if self.share_prefixes:
            rec.digests, matched, n_share = self._match(prompt)
            if len(matched) > n_share:
                # whole-prompt hit: the last block is re-derived into a
                # private page (copy-on-write by recompute)
                self.cow_forks += 1
                counters.inc("serving.cow_fork")
            for page in matched[:n_share]:
                self._alloc.incref(page)
            rec.blocks = list(matched[:n_share])
            self._tables[slot, :n_share] = rec.blocks
            rec.fed = rec.cursor = n_share * self.block_size
            rec.registered = n_share
            self._cursors[slot] = rec.cursor
        self._tenants[slot] = rec
        slot_cache.admit_slot(
            self.state, slot, int(prompt[-1]), max_new_tokens, temperature,
            top_k or 0, 0.0 if top_p is None else top_p,
            -1 if eos_id is None else eos_id, seed)

    def _youngest(self) -> int:
        live = [s for s, t in enumerate(self._tenants) if t is not None]
        return max(live, key=lambda s: self._tenants[s].seq)

    def _free_tenant(self, slot: int) -> None:
        """Return a tenant's pages (refcounted) and clear its state; the
        pool is untouched — freed pages are garbage the mask hides."""
        rec = self._tenants[slot]
        if rec is not None:
            for page in self._alloc.free(rec.blocks):
                self._trie.forget(page)
            self._tables[slot] = 0
            self._cursors[slot] = 0
            self._tenants[slot] = None
        slot_cache.release_slot(self.state, slot)

    def _read_only(self, page: int) -> bool:
        return (self._alloc.refcount(page) > 1
                or self._trie.holds_block(page))

    def _preempt_for(self, slot: int, preempted: List[int]) -> bool:
        """Free the youngest tenant; False when that was ``slot``."""
        victim = self._youngest()
        self._free_tenant(victim)
        preempted.append(victim)
        return victim != slot

    def _extend(self, slot: int, n: int, preempted: List[int]) -> None:
        """Grow ``slot``'s table to cover its next ``n`` tokens,
        preempting the youngest tenant on exhaustion.  Copy-on-write
        guard: a write that starts a block the tenant maps read-only
        (an exact-boundary fork) swaps in a fresh private page."""
        rec = self._tenants[slot]
        while rec is not None and rec.cursor % self.block_size == 0:
            wb = rec.cursor // self.block_size
            if wb >= len(rec.blocks) or not self._read_only(rec.blocks[wb]):
                break
            try:
                got = self._alloc.alloc(1)
            except slot_cache.BlockExhausted:
                if not self._preempt_for(slot, preempted):
                    return
                continue
            for page in self._alloc.free([rec.blocks[wb]]):
                self._trie.forget(page)
            rec.blocks[wb] = got[0]
            self._tables[slot, wb] = got[0]
            self.cow_forks += 1
            counters.inc("serving.cow_fork")
            break
        while self._tenants[slot] is not None:
            need = min(slot_cache.blocks_for(rec.cursor + n, self.block_size),
                       self._tables.shape[1]) - len(rec.blocks)
            if need <= 0:
                return
            try:
                got = self._alloc.alloc(need)
            except slot_cache.BlockExhausted:
                if not self._preempt_for(slot, preempted):
                    return
                continue
            start = len(rec.blocks)
            self._tables[slot, start:start + len(got)] = got
            rec.blocks.extend(got)

    def _register_blocks(self, rec: _Tenant) -> None:
        """Offer newly completed full prompt blocks to the trie."""
        full = min(int(rec.fed), int(rec.prompt.size)) // self.block_size
        while rec.registered < min(full, len(rec.digests)):
            i = rec.registered
            self._trie.register(rec.digests[i], rec.blocks[i])
            rec.registered += 1

    def _plan_drafts(self) -> List[Optional[np.ndarray]]:
        """Prompt-lookup drafts for every decoding row, capped by the
        remaining budget and the cache."""
        drafts: List[Optional[np.ndarray]] = [None] * self.max_slots
        for slot, rec in enumerate(self._tenants):
            if rec is None:
                continue
            cap = min(self.spec_tokens, rec.budget - rec.emitted - 1,
                      self.max_seq_len - rec.cursor - 1)
            if cap < 1:
                continue
            context = rec.prompt
            if rec.gen:
                context = np.concatenate(
                    [context, np.asarray(rec.gen, np.int32)])
            proposal = self._drafter(context, cap, self.spec_ngram)
            if proposal.size:
                drafts[slot] = proposal[:cap]
        return drafts

    # ----------------------------------------------------------- device
    def _upload(self, feed, n_tokens, is_prefill, emit):
        """The step's host inputs to the card in one copy; views of it
        become the pool's tables / cursors / chunk lengths."""
        slots, w = feed.shape
        parts = [feed.ravel(), n_tokens, is_prefill, emit,
                 self._tables.ravel(), self._cursors]
        buf = torch.from_numpy(np.concatenate(
            [np.asarray(p, np.int32).ravel() for p in parts])).to(self.device)
        sizes = [p.size for p in parts]
        feed_d, n_d, pre_d, emit_d, tab_d, cur_d = torch.split(buf, sizes)
        self.cache["block_tables"] = tab_d.view(self._tables.shape)
        self.cache["cursors"] = cur_d
        self.cache["chunk_lens"] = n_d
        return feed_d.view(slots, w), n_d, pre_d.bool(), emit_d.bool()

    def _sampling_params(self):
        st = self.state
        return (st.temperature,
                torch.where(st.active, st.top_k, torch.zeros_like(st.top_k)),
                torch.where(st.active, st.top_p, torch.zeros_like(st.top_p)))

    def _run_step(self, feed, n_tokens, is_prefill, emit):
        """One prefill/decode application and its sampling; returns the
        (slots, 2) int32 device tensor [token, finished]."""
        st = self.state
        tok_ids = torch.zeros_like(feed)
        tok_ids[:, 0] = st.tok
        ids = torch.where(is_prefill[:, None], feed, tok_ids)
        logits = self.model(ids, cache=self.cache, last_index=n_tokens - 1)
        keys = split(st.rng)                          # (slots, 2, 2)
        nxt = fused_sample(logits[:, 0], keys[:, 0], *self._sampling_params(),
                           vocab_size=self.vocab_size)
        # a mid-prefill tenant computes but emits nothing, and its key
        # does not advance: the k-th produced token uses the k-th split
        emit = emit & st.active
        produced = st.produced + emit.to(torch.int32)
        hit_eos = (st.eos_id >= 0) & (nxt == st.eos_id)
        finished = emit & ((produced >= st.budget) | hit_eos)
        st.tok = torch.where(emit, nxt, st.tok)
        st.produced = produced
        st.active = st.active & ~finished
        st.rng = torch.where(emit[:, None], keys[:, 1], st.rng)
        return torch.stack([nxt, finished.to(torch.int32)], dim=1)

    def _run_spec_step(self, feed, n_tokens, emit):
        """The draft/verify step: row i feeds [current, d_1..d_k]; one
        application scores every position, position j samples with the
        j-th split of the row's key, and the longest draft prefix that
        matches the sampled chain plus one token is emitted.  Returns
        the (slots, w + 2) int32 device tensor [sampled.., count,
        finished]."""
        st = self.state
        w = feed.shape[1]
        ids = feed.clone()
        ids[:, 0] = st.tok
        logits = self.model(ids, cache=self.cache)
        chain, keys, chains = st.rng, [], [st.rng]
        for _ in range(w):
            sp = split(chain)
            keys.append(sp[:, 0])
            chain = sp[:, 1]
            chains.append(chain)
        sampled = fused_sample(logits, torch.stack(keys, dim=1),
                               *self._sampling_params(),
                               vocab_size=self.vocab_size)     # (slots, w)
        idx = torch.arange(w, device=feed.device, dtype=torch.int32)
        match = (sampled[:, :-1] == feed[:, 1:]) \
            & (idx[None, 1:] < n_tokens[:, None])
        accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_emit = torch.minimum(accept + 1, n_tokens)
        eos_hit = (st.eos_id[:, None] >= 0) & (sampled == st.eos_id[:, None])
        eos_pos = torch.where(eos_hit, idx[None, :],
                              torch.full_like(sampled, w)).amin(dim=1)
        n_emit = torch.minimum(n_emit, eos_pos + 1)
        n_emit = torch.minimum(n_emit, torch.clamp(st.budget - st.produced,
                                                   min=0))
        n_emit = torch.where(emit & st.active, n_emit,
                             torch.zeros_like(n_emit)).to(torch.int32)
        produced = st.produced + n_emit
        finished = (n_emit > 0) & ((produced >= st.budget)
                                   | (eos_pos < n_emit))
        last = sampled.gather(1, torch.clamp(n_emit - 1, min=0)[:, None].long())
        # the key advances once per emitted token
        new_rng = torch.stack(chains, dim=1).gather(
            1, n_emit.long()[:, None, None].expand(-1, 1, 2))[:, 0]
        st.tok = torch.where(n_emit > 0, last[:, 0], st.tok)
        st.produced = produced
        st.active = st.active & ~finished
        st.rng = new_rng
        return torch.cat([sampled, n_emit[:, None],
                          finished.to(torch.int32)[:, None]], dim=1)

    @torch.no_grad()
    def step(self) -> StepOutput:
        """One mixed prefill+decode step over every slot (a drafted
        verify step when speculation is on, nothing is prefilling and a
        draft hit); inactive slots compute garbage into the null page.
        The one device-to-host read of the step is here."""
        any_prefill = any(rec is not None and rec.fed < rec.prompt.size
                          for rec in self._tenants)
        drafts: List[Optional[np.ndarray]] = [None] * self.max_slots
        if not any_prefill and self.spec_tokens > 0:
            drafts = self._plan_drafts()
        any_spec = any(d is not None for d in drafts)
        w = (self._chunk if any_prefill
             else 1 + self.spec_tokens if any_spec else 1)
        feed = np.zeros((self.max_slots, w), np.int32)
        n_tokens = np.ones((self.max_slots,), np.int32)
        is_prefill = np.zeros((self.max_slots,), bool)
        emit = np.zeros((self.max_slots,), bool)
        preempted: List[int] = []
        for slot in range(self.max_slots):
            rec = self._tenants[slot]
            if rec is None:
                continue
            if rec.fed < rec.prompt.size:
                n = min(w, rec.prompt.size - rec.fed)
                feed[slot, :n] = rec.prompt[rec.fed:rec.fed + n]
                n_tokens[slot] = n
                is_prefill[slot] = True
                emit[slot] = rec.fed + n >= rec.prompt.size
            else:
                emit[slot] = True
                if drafts[slot] is not None:
                    d = drafts[slot]
                    feed[slot, 1:1 + d.size] = d
                    n_tokens[slot] = 1 + d.size
            self._extend(slot, int(n_tokens[slot]), preempted)
        for slot in preempted:
            feed[slot] = 0
            n_tokens[slot] = 1
            is_prefill[slot] = False
            emit[slot] = False
            drafts[slot] = None
        feed_d, n_d, pre_d, emit_d = self._upload(feed, n_tokens,
                                                  is_prefill, emit)
        if any_spec:
            out = self._run_spec_step(feed_d, n_d, emit_d).cpu().numpy()
            tokens, counts = out[:, :w], out[:, w]
        else:
            out = self._run_step(feed_d, n_d, pre_d, emit_d).cpu().numpy()
            tokens, counts = out[:, :1], emit.astype(np.int32)
        finished = out[:, -1].astype(bool)
        for slot in range(self.max_slots):
            rec = self._tenants[slot]
            if rec is None:
                continue
            kept = int(counts[slot])
            if any_spec:
                # the cursor rolls back over rejected drafts, whose pool
                # writes sit past it, unreachable, until overwritten
                rec.cursor += kept
                proposed = int(n_tokens[slot]) - 1
                if proposed > 0:
                    self.spec_proposed += proposed
                    self.spec_accepted += max(kept - 1, 0)
            else:
                n = int(n_tokens[slot])
                if is_prefill[slot]:
                    rec.fed += n
                    if self.share_prefixes:
                        self._register_blocks(rec)
                rec.cursor += n
            if kept:
                rec.emitted += kept
                rec.gen.extend(int(t) for t in tokens[slot, :kept])
            self._cursors[slot] = rec.cursor
        return StepOutput(tokens, finished, counts > 0, tuple(preempted),
                          counts)

    def release(self, slot: int) -> None:
        """Free ``slot``: pages back to the pool (shared pages survive
        their other tenants), state cleared."""
        self._free_tenant(slot)

    def warmup(self) -> None:
        """Build the kernels and run every step kind once: a dummy
        tenant whose prompt spans a chunk plus one token (a prefill step,
        then a decode step), and with speculation on a second one under
        forced drafts (a verify step)."""
        drafter = self._drafter

        def run_one(plen: int, budget: int) -> None:
            self.admit(0, np.zeros((plen,), np.int32), max_new_tokens=budget)
            while self._tenants[0] is not None:
                if bool(self.step().finished[0]):
                    break
            self.release(0)

        try:
            self._drafter = lambda context, k, ngram: np.empty((0,), np.int32)
            run_one(max(1, min(self._chunk + 1, self.max_seq_len - 2)), 2)
            if self.spec_tokens:
                self._drafter = lambda context, k, ngram: np.zeros(
                    (k,), np.int32)
                run_one(max(1, min(self._chunk + 1, self.max_seq_len - 2
                                   - self.spec_tokens)),
                        2 + self.spec_tokens)
        finally:
            self._drafter = drafter

    # ------------------------------------------------------------ gauges
    @property
    def chips_per_replica(self) -> int:
        """Cards this one replica spans (the tensor-parallel degree; 1
        for the single-chip engine)."""
        return self.tp

    @property
    def mesh_shape(self) -> Optional[dict]:
        """``{"tensor": tp}`` of the replica's mesh, or None for the
        single-chip engine."""
        if self.mesh is None:
            return None
        return {TENSOR_AXIS: self.tp}

    @property
    def blocks_total(self) -> int:
        return self._alloc.blocks_total

    @property
    def blocks_free(self) -> int:
        return self._alloc.blocks_free

    @property
    def blocks_in_use(self) -> int:
        return self._alloc.blocks_in_use

    @property
    def pool_tokens(self) -> int:
        return self._alloc.tokens_total

    @property
    def live_tokens(self) -> int:
        """Tokens written for live tenants."""
        return int(sum(t.cursor for t in list(self._tenants)
                       if t is not None))

    @property
    def shared_blocks(self) -> int:
        return self._alloc.shared_blocks

    @property
    def blocks_saved(self) -> int:
        return self._alloc.blocks_saved

    @property
    def trie_blocks(self) -> int:
        return len(self._trie)

    @property
    def spec_accept_rate(self) -> float:
        """Accepted over proposed draft tokens (0.0 before any)."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / self.spec_proposed
