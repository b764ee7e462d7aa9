"""Slotted dense KV-cache pool — the fixed-shape substrate of the engine.

Counterpart of the dense half of ``apex_tpu/serving/cache.py``.  The
pool is the model's dense decode cache at batch ``max_slots``
(:func:`apex_tpu_torch.models.generate.init_cache`): each slot is one
row of ``key`` / ``value`` and one entry of the per-row ``index``.
Admission prefills a one-row cache and writes it into its slot
(:func:`write_slot`), eviction zeroes the row (:func:`reset_slot`), and
decode advances every row, each at its own cursor.  The helpers update
tensors in place — the pool is the engine's own, and one copy of
``max_slots × max_seq_len`` K/V is all the card holds.

Per-slot scalar bookkeeping (active mask, next token, produced count,
budget, sampling parameters, threefry key) lives in :class:`SlotState`:
``(max_slots,)`` tensors on the engine's device, so slots decoding
greedily and slots sampling with top-k / top-p share one decode step.

The paged engine's host side lives here too (the counterpart of the
paged half of the JAX module): :class:`BlockAllocator`, the refcounted
free list over the page pool with the reserved null page 0;
:func:`chain_digests`, the chained sha256 digests of a prompt's full
blocks (byte-equal to the JAX package's); and :class:`PrefixTrie`, the
digest → page index of live read-only prompt blocks that prefix
sharing maps.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import numpy as np

import torch

from apex_tpu_torch.ops.fused_sampling import prng_key

__all__ = ["validate_cache_tree", "SlotState", "init_slot_state",
           "admit_slot", "release_slot", "write_slot", "reset_slot",
           "rewind_index", "BlockExhausted", "blocks_for", "BlockAllocator",
           "chain_digests", "PrefixTrie"]

Cache = Dict[str, torch.Tensor]
_RING_LEAF = "slot_positions"


def validate_cache_tree(cache: Cache) -> None:
    """Reject caches the slot pool cannot manage: raises ``ValueError``
    for the sliding-window ring cache (its slots are not positions)."""
    if _RING_LEAF in cache:
        raise ValueError(
            "the serving engine requires the dense KV-cache layout; "
            "this model uses the sliding-window ring-buffer cache "
            f"(found a {_RING_LEAF!r} leaf).  Serve sliding-window "
            "models with sliding_window=None (or >= max_seq_len) — "
            "the dense cache computes the same function whenever "
            "sequences stay within the window")


@dataclasses.dataclass
class SlotState:
    """Per-slot device state, ``(max_slots,)`` tensors.

    Conventions: ``top_k == 0`` disables truncation, ``top_p <= 0`` (or
    ``>= 1``) disables the nucleus filter, ``eos_id == -1`` disables eos
    stopping, and ``rng`` ``(max_slots, 2)`` holds each slot's threefry
    key, so a request's sampled tokens depend on its own seed only.
    """

    active: torch.Tensor        # bool
    tok: torch.Tensor           # int32 — next token to feed
    produced: torch.Tensor      # int32 — tokens produced so far
    budget: torch.Tensor        # int32 — max_new_tokens
    temperature: torch.Tensor   # float32
    top_k: torch.Tensor         # int32
    top_p: torch.Tensor         # float32
    eos_id: torch.Tensor        # int32
    rng: torch.Tensor           # int64 (max_slots, 2) uint32 words


def init_slot_state(max_slots: int, device=None) -> SlotState:
    """All-free slot state (inactive slots decode garbage that is
    ignored on the host and overwritten at admission)."""
    def z(dt):
        return torch.zeros((max_slots,), dtype=dt, device=device)
    return SlotState(
        active=z(torch.bool),
        tok=z(torch.int32),
        produced=z(torch.int32),
        budget=torch.ones((max_slots,), dtype=torch.int32, device=device),
        temperature=z(torch.float32),
        top_k=z(torch.int32),
        top_p=z(torch.float32),
        eos_id=torch.full((max_slots,), -1, dtype=torch.int32,
                          device=device),
        rng=torch.zeros((max_slots, 2), dtype=torch.int64, device=device),
    )


def admit_slot(state: SlotState, slot: int, tok: int, budget: int,
               temperature: float, top_k: int, top_p: float, eos_id: int,
               seed: int) -> None:
    """Install one tenant's parameters into ``slot`` (in place); its key
    is ``prng_key(seed)``, as ``jax.random.PRNGKey(seed)`` in the JAX
    engine."""
    state.active[slot] = True
    state.tok[slot] = int(tok)
    state.produced[slot] = 0
    state.budget[slot] = int(budget)
    state.temperature[slot] = float(temperature)
    state.top_k[slot] = int(top_k)
    state.top_p[slot] = float(top_p)
    state.eos_id[slot] = int(eos_id)
    state.rng[slot] = prng_key(seed, state.rng.device)


def release_slot(state: SlotState, slot: int) -> None:
    """Mark ``slot`` free."""
    state.active[slot] = False


def write_slot(pool: Cache, slot: int, one: Cache) -> None:
    """Copy a one-row cache into row ``slot`` of the pool."""
    pool["key"][:, slot] = one["key"][:, 0]
    pool["value"][:, slot] = one["value"][:, 0]
    pool["index"][slot] = one["index"][0]


def reset_slot(pool: Cache, slot: int) -> None:
    """Zero row ``slot`` (stale K/V never outlives its tenant)."""
    pool["key"][:, slot].zero_()
    pool["value"][:, slot].zero_()
    pool["index"][slot] = 0


def rewind_index(cache: Cache, position: int) -> None:
    """Set every row's cache index to ``position``, leaving K/V as is.

    The admission trick: a prompt right-padded to its bucket prefills
    positions ``[0, bucket)``; rewinding to ``true_len - 1`` makes the
    first decode step re-feed the last real prompt token at its true
    position.  Pad K/V beyond the cursor is invisible (attention masks
    positions past the index) and is overwritten before it can be seen.
    """
    cache["index"].fill_(int(position))


# --------------------------------------------------------------------- #
# paged KV cache: the host-side page pool
# --------------------------------------------------------------------- #
class BlockExhausted(RuntimeError):
    """The paged pool has no free blocks left (the engine preempts a
    tenant instead of failing the step)."""


def blocks_for(tokens: int, block_size: int) -> int:
    """Pages needed to hold ``tokens`` cache positions."""
    return -(-int(tokens) // int(block_size))


class BlockAllocator:
    """Refcounted LIFO free list over the physical page pool.

    Physical block 0 is the null page — unallocated table entries point
    at it and pad writes land in it — and is never handed out.
    :meth:`alloc` hands out pages at refcount 1 (atomically: all or
    none), :meth:`incref` lets another tenant map a live page (a shared
    prompt block), :meth:`free` drops one reference and returns the
    pages whose last reference dropped.  ``blocks_in_use`` counts
    physical pages, so it stays exact under sharing.  Not thread-safe:
    the engine's thread is the only caller (gauges read snapshots).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError(
                "num_blocks must be >= 2 (block 0 is the reserved null "
                f"page), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO: pages freed together are reused together
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def blocks_total(self) -> int:
        return self.num_blocks - 1

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.blocks_total - len(self._free)

    @property
    def tokens_total(self) -> int:
        return self.blocks_total * self.block_size

    @property
    def tokens_free(self) -> int:
        return len(self._free) * self.block_size

    @property
    def shared_blocks(self) -> int:
        """Pages mapped by more than one reference."""
        return sum(1 for r in list(self._refs.values()) if r > 1)

    @property
    def blocks_saved(self) -> int:
        """Pages sharing reclaims right now: Σ (refcount − 1)."""
        return sum(r - 1 for r in list(self._refs.values()) if r > 1)

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages at refcount 1; :class:`BlockExhausted`
        (taking none) when fewer are free."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n > len(self._free):
            raise BlockExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool: {self.blocks_total} × {self.block_size} tok)")
        taken = self._free[-n:] if n else []
        del self._free[len(self._free) - n:]
        for blk in taken:
            self._refs[blk] = 1
        return taken

    def incref(self, block: int) -> int:
        """One more reference to a live page; raises on a free one."""
        blk = int(block)
        if blk not in self._refs:
            raise ValueError(f"incref of block {blk} which is not allocated")
        self._refs[blk] += 1
        return self._refs[blk]

    def free(self, blocks) -> List[int]:
        """Drop one reference per page; returns the pages that went back
        to the pool.  A free page, or one outside the pool, raises."""
        freed: List[int] = []
        for blk in blocks:
            blk = int(blk)
            if not 1 <= blk < self.num_blocks:
                raise ValueError(
                    f"block {blk} outside the allocatable range "
                    f"[1, {self.num_blocks})")
            refs = self._refs.get(blk)
            if refs is None:
                raise ValueError(f"double free of block {blk}")
            if refs > 1:
                self._refs[blk] = refs - 1
            else:
                del self._refs[blk]
                self._free.append(blk)
                freed.append(blk)
        return freed


def chain_digests(tokens, block_size: int) -> List[bytes]:
    """``digest_i = sha256(digest_{i-1} || block_i)`` over every FULL
    block of ``tokens`` (raw int32 bytes), seeded with
    ``b"apex-tpu-prefix-v1"``: equal digests mean equal prefixes through
    that block.  Byte-equal to the JAX package's digests."""
    tokens = np.ascontiguousarray(tokens, np.int32)
    out: List[bytes] = []
    digest = b"apex-tpu-prefix-v1"
    for i in range(tokens.size // int(block_size)):
        h = hashlib.sha256(digest)
        h.update(tokens[i * block_size:(i + 1) * block_size].tobytes())
        digest = h.digest()
        out.append(digest)
    return out


class PrefixTrie:
    """Digest → physical page of LIVE read-only prompt blocks: a tenant
    registers a prompt block once it is fully written, a later admission
    maps the longest matching run, and a page is forgotten when its last
    reference drops."""

    def __init__(self):
        self._by_digest: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_digest)

    def register(self, digest: bytes, block: int) -> bool:
        """Index ``block`` under ``digest``; first writer wins, and one
        page holds one digest.  Returns whether the entry was added."""
        block = int(block)
        if digest in self._by_digest or block in self._by_block:
            return False
        self._by_digest[digest] = block
        self._by_block[block] = digest
        return True

    def forget(self, block: int) -> None:
        digest = self._by_block.pop(int(block), None)
        if digest is not None:
            del self._by_digest[digest]

    def holds_block(self, block: int) -> bool:
        return int(block) in self._by_block

    def match(self, digests: List[bytes]) -> List[int]:
        """Pages of the leading run of ``digests`` present in the trie."""
        pages: List[int] = []
        for digest in digests:
            block = self._by_digest.get(digest)
            if block is None:
                break
            pages.append(block)
        return pages
