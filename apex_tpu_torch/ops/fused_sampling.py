"""Fused decode-step sampling — CUDA kernel plus plain PyTorch — and the
threefry key helpers the serving engine draws its noise from.

Counterpart of ``apex_tpu/ops/fused_sampling.py``.  :func:`fused_sample`
turns ``(rows, vocab)`` logits into one token per row with per-row
``temperature`` / ``top_k`` / ``top_p`` tensors and one threefry key per
row.  For a CUDA tensor it launches ``csrc/fused_sampling.cu`` (one
thread-block cluster per row, replacing the Pallas ``_sampling_kernel``;
:func:`sample_plan` sizes the clusters); for a CPU tensor it runs
:func:`fused_sample_reference`, the sort-based composition of the JAX
package, verbatim.

**Keys and noise.**  Keys are ``(rows, 2)`` int64 tensors holding the
two uint32 words of a jax threefry key (int64, because PyTorch has no
general uint32 arithmetic).  :func:`prng_key`, :func:`split` and
:func:`random_bits` replay ``jax.random.PRNGKey``, ``split`` and
``bits`` under jax's partitionable threefry layout:

- ``prng_key(seed)`` is ``[0, seed]``;
- ``split(key)[i]`` is both output words of ``threefry2x32(key, (0, i))``;
- ``random_bits(key, V)[j]`` is ``x0 ^ x1`` of ``threefry2x32(key, (0, j))``.

The categorical draw is the first argmax of ``masked + gumbel`` with
``gumbel = -log(-log(u))``, ``u = max(tiny, f * (1 - tiny) + tiny)`` and
``f`` the top 23 bits as a float in [0, 1) — ``jax.random.categorical``
bit for bit, so the port's tokens equal the JAX engine's for the same
seeds.

**Parity contract.**  Greedy rows (``temperature <= 0``) are the first
argmax of the raw fp32 logits.  Sampled rows agree with the reference
key for key: the top-k threshold is the exact k-th largest (selection),
the noise is bit-identical, ties break to the first index.  One caveat,
as in the JAX module: the nucleus boundary compares a sum of
exponentials against ``top_p * Z``, and the kernel sums in another
order and precision than the reference's sorted fp32 cumsum, so a token
can differ only when the boundary lands within rounding of the mass
target and the straddling token is the one drawn.

**The kernel's mass.**  It finds the boundary by a radix descent over
a histogram of mass: each ``e = exp(v - m) <= 1`` (``m`` the row's max)
becomes the integer ``q = round(e * 2^40)`` (round to nearest, even on a
tie; ``e < 2^-41`` adds nothing), and the sums are 64-bit integer sums,
exact in any order, so a rerun is bitwise.  Against the exact sum of
``e``, ``Z`` errs by at most ``vocab * 2^-41`` (5.8e-8 at 128256
entries), relative to ``Z >= 1``; an fp32 sum of the same terms errs by
up to ``~log2(vocab) * 2^-24`` relative (1e-6) in a tree, more in
sequence.  The target is ``ceil(top_p * Z)`` taken in float64.  The
boundary is the largest key ``E`` with ``sum of q over keys >= E``
reaching the target; keys below ``E`` leave the nucleus.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["fused_sample", "fused_sample_reference", "prng_key", "split",
           "random_bits", "gumbel", "threefry2x32", "sampling_cost_bytes",
           "sample_plan"]

_NEG_INF = -1e30
#: smallest positive normal fp32 — jax.random.gumbel's uniform floor
_TINY = float(np.finfo(np.float32).tiny)
_MASK = 0xFFFFFFFF
#: threefry-2x32 round rotations (Salmon et al.; jax.random's cipher)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the kernel's cluster sizes (CTAs a row), its shared-memory cap a CTA
#: (``kSmemCap`` in csrc/fused_sampling.cu), and the smallest slice worth
#: a CTA of its own
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMEM_CAP = 200 * 1024
MIN_SLICE = 1024


# --------------------------------------------------------------------- #
# threefry-2x32 over int64 tensors holding uint32 words
# --------------------------------------------------------------------- #
def threefry2x32(k0, k1, c0, c1):
    """The 20-round threefry-2x32 block cipher, elementwise; every
    argument is an int64 tensor (or int) of uint32 words, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (c0 + k0) & _MASK
    x1 = (c1 + k1) & _MASK
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << d) & _MASK) | (x1 >> (32 - d))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` builds for a uint32 seed:
    ``[0, seed]`` as a ``(2,)`` int64 tensor."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` over the leading axes of ``keys`` (``(..., 2)``):
    returns ``(..., num, 2)``."""
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    ctr = torch.arange(num, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each key of ``keys``
    (``(..., 2)``): returns ``(..., n)`` int64 uint32 words."""
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return x0 ^ x1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") fp32 noise of shape
    ``(rows, n)``, one row per key."""
    bits = random_bits(keys, n)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fb.view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def sampling_cost_bytes(rows: int, vocab: int, dtype) -> int:
    """Device-memory bytes one fused sampling call must move: the
    logits read once, the per-row key pair (two int64 words) and
    temperature / top-k / top-p read, one int32 token written."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (int(rows) * int(vocab) * itemsize
            + int(rows) * (16 + 4 + 4 + 4) + int(rows) * 4)


# --------------------------------------------------------------------- #
# plain composition (golden semantics; the CPU path)
# --------------------------------------------------------------------- #
def _flatten_width(logits, keys, temperature, top_k, top_p):
    """``(rows, width, vocab)`` logits with ``(rows, width, 2)`` keys —
    the speculative verify's 1 + K draws per row — as ``rows * width``
    rows, the per-row parameters repeated over the width, as the JAX
    function does.  Returns the flattened arguments and the width (None
    for 2-D logits)."""
    if logits.ndim == 2:
        return logits, keys, temperature, top_k, top_p, None
    if logits.ndim != 3:
        raise ValueError(
            f"logits must be (rows, vocab) or (rows, width, vocab), got "
            f"{tuple(logits.shape)}")
    rows, width, vocab = logits.shape
    if tuple(keys.shape) != (rows, width, 2):
        raise ValueError(
            f"keys shape {tuple(keys.shape)} != (rows, width, 2) = "
            f"{(rows, width, 2)}")
    for name, t in (("temperature", temperature), ("top_k", top_k),
                    ("top_p", top_p)):
        if tuple(t.shape) != (rows,):
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != (rows,) = {(rows,)}")
    return (logits.reshape(rows * width, vocab), keys.reshape(rows * width, 2),
            temperature.repeat_interleave(width),
            top_k.repeat_interleave(width), top_p.repeat_interleave(width),
            width)


def fused_sample_reference(logits, keys, temperature, top_k, top_p,
                           vocab_size: int):
    """Per-row sampling with tensor parameters — the JAX engines'
    ``sample_dynamic`` composition, verbatim.

    ``logits`` (rows, vocab); ``keys`` (rows, 2) int64 uint32 words;
    ``temperature`` / ``top_k`` / ``top_p`` (rows,); or ``(rows, width,
    vocab)`` logits with ``(rows, width, 2)`` keys and per-row
    parameters, returning ``(rows, width)``.  Per row: fp32
    argmax when ``temperature <= 0``, else top-k- and/or
    nucleus-truncated categorical at ``logits / temperature``
    (``top_k == 0`` and ``top_p <= 0`` / ``>= 1`` disable their filters
    exactly).  The sort + softmax + cumsum tail runs only when some row
    enables a filter; with none enabled it is an exact no-op.
    """
    rows = logits.shape[0]
    logits, keys, temperature, top_k, top_p, width = _flatten_width(
        logits, keys, temperature, top_k, top_p)
    if width is not None:
        return fused_sample_reference(logits, keys, temperature, top_k,
                                      top_p, vocab_size).reshape(rows, width)
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / safe_t
    p_on = (top_p > 0.0) & (top_p < 1.0)
    masked = scaled
    if bool(((top_k > 0) | p_on).any()):
        k = torch.where(top_k > 0, top_k,
                        torch.full_like(top_k, vocab_size)).long()
        ordered = torch.sort(scaled, dim=-1).values          # ascending
        kth = ordered.gather(-1, (vocab_size - k)[:, None])
        neg = torch.full_like(scaled, _NEG_INF)
        masked = torch.where(scaled < kth, neg, scaled)
        # nucleus over the top-k-masked distribution, the sort reused
        rev = ordered.flip(-1)
        desc = torch.where(rev < kth, neg, rev)
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cut = torch.where(p_on, top_p.float(),
                          torch.ones_like(top_p, dtype=torch.float32))
        keep = cum - probs < cut[:, None]
        thresh = torch.where(keep, desc, torch.full_like(desc, np.inf)
                             ).min(dim=-1, keepdim=True).values
        masked = torch.where(p_on[:, None] & (masked < thresh), neg, masked)
    noise = gumbel(keys.to(torch.int64), logits.shape[-1])
    sampled = torch.argmax(noise + masked, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def _slice(vocab: int, cluster: int) -> int:
    """Vocab entries a CTA of a ``cluster``-CTA row: the even share,
    rounded up to 16 (so every slice starts at the row's 16-byte
    phase)."""
    per = -(-int(vocab) // int(cluster))
    return -(-per // 16) * 16


def sample_plan(rows: int, vocab: int, itemsize: int, capacity) -> tuple:
    """``(cluster, slice, resident)`` of one kernel call.

    ``capacity``: ``{cluster size: clusters the card runs at once}`` (0
    or absent: that size does not fit).  The row's keys (4 bytes an
    entry) and its staged logits (``itemsize``) stay in shared memory
    when a CTA's slice fits under :data:`SMEM_CAP`; the cluster is the
    fewest CTAs for which it does (16 when none does: the slice then
    streams and its keys go to a scratch buffer), grown to the most CTAs
    that keep every row in one wave of clusters and slices of at least
    :data:`MIN_SLICE` entries."""
    sizes = [c for c in CLUSTER_SIZES if capacity.get(c, 0) > 0] or [1]

    def resident(c):
        return _slice(vocab, c) * (4 + itemsize) + 16 <= SMEM_CAP

    cluster = next((c for c in sizes if resident(c)), sizes[-1])
    for c in sizes:
        if (c > cluster and _slice(vocab, c) >= MIN_SLICE
                and rows <= capacity[c]):
            cluster = c
    return cluster, _slice(vocab, cluster), resident(cluster)


_CAPACITY = {}


def _capacity(dev, dtype):
    """``{cluster size: clusters at once}`` of the kernel on ``dev``
    (asked of the card once per device and dtype)."""
    key = (dev.index, dtype)
    if key not in _CAPACITY:
        fn = _build.function("fused_sampling", "apex_fused_sample_capacity",
                             [ctypes.c_int, ctypes.c_void_p])
        out = (ctypes.c_int * len(CLUSTER_SIZES))()
        with torch.cuda.device(dev):
            code = fn(_build.DTYPE_CODES[dtype], ctypes.addressof(out))
        if code != 0:
            raise RuntimeError(f"fused_sampling: CUDA error {code} sizing "
                               f"its clusters")
        _CAPACITY[key] = dict(zip(CLUSTER_SIZES, list(out)))
    return _CAPACITY[key]


def _sample_kernel(logits, keys, temperature, top_k, top_p):
    if logits.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported logits dtype {logits.dtype}")
    dev = logits.device
    for name, t in (("keys", keys), ("temperature", temperature),
                    ("top_k", top_k), ("top_p", top_p)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, logits on {dev}")
    rows, vocab = logits.shape
    out = torch.empty((rows,), dtype=torch.int32, device=dev)
    if rows == 0:
        return out
    x = logits.contiguous()
    kk = keys.to(torch.int64).contiguous()
    t = temperature.to(torch.float32).contiguous()
    k = top_k.to(torch.int32).contiguous()
    p = top_p.to(torch.float32).contiguous()
    cluster, slice_, resident = sample_plan(
        rows, vocab, x.element_size(), _capacity(dev, x.dtype))
    scratch = None if resident else torch.empty(
        rows * cluster * slice_, dtype=torch.int32, device=dev)
    fn = _build.function("fused_sampling", "apex_fused_sample", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    code = fn(x.data_ptr(), kk.data_ptr(), t.data_ptr(), k.data_ptr(),
              p.data_ptr(), out.data_ptr(), rows, vocab,
              _build.DTYPE_CODES[x.dtype], cluster, slice_, int(resident),
              None if scratch is None else scratch.data_ptr(),
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fused_sampling")
    return out


def fused_sample(logits, keys, temperature, top_k, top_p, *,
                 vocab_size: Optional[int] = None,
                 implementation: Optional[str] = None, block_v: int = 0):
    """Sample one int32 token per row of ``logits`` ``(rows, vocab)``.

    ``keys`` ``(rows, 2)`` int64 uint32 words (:func:`split` products);
    ``temperature`` / ``top_k`` / ``top_p`` ``(rows,)`` tensors with the
    semantics of :func:`fused_sample_reference`.  ``(rows, width,
    vocab)`` logits with ``(rows, width, 2)`` keys (the speculative
    verify) run as ``rows * width`` rows of the same kernel, the per-row
    parameters repeated over the width, and return ``(rows, width)``.
    ``block_v``: the vocab tile hint of the JAX package (0: its
    autotuned tile); any non-negative value is taken and ignored — the
    kernel chooses its own passes and the token does not depend on them.
    ``implementation`` as in :mod:`._dispatch`.
    """
    if int(block_v) < 0:
        raise ValueError(f"block_v must be a non-negative tile hint, got "
                         f"{block_v}")
    n0 = logits.shape[0]
    logits, keys, temperature, top_k, top_p, width = _flatten_width(
        logits, keys, temperature, top_k, top_p)
    if width is not None:
        return fused_sample(logits, keys, temperature, top_k, top_p,
                            vocab_size=vocab_size,
                            implementation=implementation).reshape(n0, width)
    rows, vocab = logits.shape
    if tuple(keys.shape) != (rows, 2):
        raise ValueError(
            f"keys shape {tuple(keys.shape)} != (rows, 2) = {(rows, 2)}")
    if vocab_size is not None and int(vocab_size) != vocab:
        raise ValueError(
            f"vocab_size ({vocab_size}) != logits vocab axis ({vocab})")
    for name, arr in (("temperature", temperature), ("top_k", top_k),
                      ("top_p", top_p)):
        if tuple(arr.shape) != (rows,):
            raise ValueError(
                f"{name} shape {tuple(arr.shape)} != (rows,) = {(rows,)}")
    if resolve_impl(implementation, logits) == "torch":
        return fused_sample_reference(logits, keys, temperature, top_k,
                                      top_p, vocab)
    return _sample_kernel(logits, keys, temperature, top_k, top_p)
