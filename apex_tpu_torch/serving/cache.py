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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from apex_tpu_torch.ops.fused_sampling import prng_key

__all__ = ["SlotState", "init_slot_state", "admit_slot", "release_slot",
           "write_slot", "reset_slot", "rewind_index"]

Cache = Dict[str, torch.Tensor]


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
