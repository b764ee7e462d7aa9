"""Continuous-batching decode engine over the slotted dense KV cache.

Counterpart of the dense :class:`Engine` of
``apex_tpu/serving/engine.py``.  One model, ``max_slots`` tenants:

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
the one sync per step is ``step()`` returning the sampled tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.generate import (
    apply_decode,
    init_cache,
    prefill_tokens,
)
from apex_tpu_torch.ops.fused_sampling import (
    fused_sample,
    fused_sample_reference,
    split,
)
from apex_tpu_torch.serving import cache as slot_cache

__all__ = ["Engine", "StepOutput", "sample_dynamic", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS: Tuple[int, ...] = (32, 128, 512)


class StepOutput(NamedTuple):
    """One engine step's host-visible result, in the JAX engines' form
    (``tokens`` ``(max_slots, width)``, ``counts[i]`` real tokens of row
    i).  Nothing in this package builds it yet: the dense engine's
    ``step`` returns a plain ``(tokens, finished)`` pair, which is all
    the scheduler reads.  The paged engine (ROADMAP A-3) will return it."""

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
        self.cache = init_cache(model, self.max_slots)
        self._scratch = init_cache(model, 1)
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
        toks = nxt.cpu().numpy()
        fin = finished.cpu().numpy()
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
