"""The fused sampler's selection, modelled in numpy and held against the
JAX package's reference.

``csrc/fused_sampling.cu`` selects by digits: the k-th largest key by a
radix select over four 8-bit digits of count histograms, the nucleus
boundary by the same descent over histograms of mass in 2^-40 fixed
point, each CTA of a row's cluster adding its slice into the bins.  The
numpy model here does the same, slice by slice as :func:`sample_plan`
cuts the row, and is checked against a model of the bitwise descent the
earlier kernel made (the same threshold and boundary) and, through the
Gumbel draw, against ``apex_tpu.ops.fused_sampling.fused_sample_reference``
run on the CPU (the same tokens, except where the nucleus boundary
lands within rounding of the mass target: ``_nucleus_tie``).  The
host-side plan (cluster size, slice, residency) and the softmax
kernel's magic divisors are checked against Python's arithmetic.  The
kernel itself is held against the plain version on a card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 1.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.fused_sampling import (
    fused_sample_reference as jax_sample_reference,
)
from apex_tpu_torch.ops import fused_sampling as fs
from apex_tpu_torch.ops import softmax as S

#: a card's cluster capacity as the plan sees it (clusters at once)
CAPACITY = {1: 132, 2: 66, 4: 32, 8: 16, 16: 8}
NEG = np.float32(-1e30)


def mono(v):
    """The order-preserving uint32 image of float32 ``v`` (the kernel's
    ``mono``)."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u >> 31 == 0, u | np.uint32(0x80000000), ~u)


def unmono(k):
    k = np.asarray(k, np.uint32)
    return np.where(k >> 31 != 0, k & np.uint32(0x7FFFFFFF), ~k).view(
        np.float32)


def slices(vocab, itemsize):
    """The index ranges of the CTAs of one row under the plan."""
    cluster, sl, _ = fs.sample_plan(1, vocab, itemsize, CAPACITY)
    return [(r * sl, min((r + 1) * sl, vocab)) for r in range(cluster)]


def radix_kth(keys, k, parts):
    """The k-th largest key: four 8-bit digits, each from a 256-bin count
    histogram summed over the slices."""
    prefix, target = 0, k
    for shift in (24, 16, 8, 0):
        hist = np.zeros(256, np.int64)
        for a, b in parts:
            kk = keys[a:b].astype(np.int64)
            if shift < 24:
                kk = kk[kk >> (shift + 8) == prefix]
            hist += np.bincount((kk >> shift) & 255, minlength=256)
        suffix = np.cumsum(hist[::-1])[::-1]       # S(d) = bins >= d
        ok = np.nonzero(suffix >= target)[0]
        d = int(ok[-1]) if ok.size else 0
        target -= int(suffix[d + 1]) if d < 255 else 0
        prefix = (prefix << 8) | d
    return prefix


def bitwise_kth(keys, k):
    """The earlier kernel's descent: the largest key with at least k keys
    at or above it, one bit at a time."""
    acc = 0
    kk = keys.astype(np.int64)
    for bit in range(31, -1, -1):
        cand = acc | (1 << bit)
        if int((kk >= cand).sum()) >= k:
            acc = cand
    return acc


def fixed_mass(v, m):
    """exp(v - m) as the kernel's 2^-40 fixed point (round to nearest,
    even on a tie), in exact integers."""
    e = np.exp((v - m).astype(np.float32)).astype(np.float32)
    return np.rint(e.astype(np.float64) * 2.0 ** 40).astype(np.int64)


def cut_of(p, total):
    """ceil(top_p * Z) in float64, as the kernel takes it."""
    return max(1, math.ceil(float(np.float64(np.float32(p)) * float(total))))


def radix_edge(keys, q, p, parts):
    """The nucleus's smallest key: the largest E with the mass of keys >=
    E reaching ceil(p * Z), by four digits of mass histograms."""
    prefix, target = 0, None
    for shift in (24, 16, 8, 0):
        hist = np.zeros(256, object)
        for a, b in parts:
            kk, qq = keys[a:b].astype(np.int64), q[a:b]
            if shift < 24:
                sel = kk >> (shift + 8) == prefix
                kk, qq = kk[sel], qq[sel]
            for d in np.unique((kk >> shift) & 255):
                hist[d] += int(qq[((kk >> shift) & 255) == d].sum())
        if target is None:
            target = cut_of(p, int(sum(hist)))
        suffix = np.cumsum(hist[::-1])[::-1]
        ok = [d for d in range(256) if suffix[d] >= target]
        d = ok[-1] if ok else 0
        target -= int(suffix[d + 1]) if d < 255 else 0
        prefix = (prefix << 8) | d
    return prefix


def bitwise_edge(keys, q, p):
    """The earlier kernel's nucleus descent with the same mass: the
    largest B with the mass of keys > B reaching the target; E = B + 1."""
    kk = keys.astype(np.int64)
    target = cut_of(p, int(q.sum()))
    acc = 0
    for bit in range(31, -1, -1):
        cand = acc | (1 << bit)
        if int(q[kk > cand].sum()) >= target:
            acc = cand
    return acc + 1


def model_row(x, temp, top_k, top_p, noise, itemsize):
    """The kernel's token for one row of fp32 logits ``x``."""
    vocab = x.size
    if not temp > 0:
        return int(np.argmax(x))
    parts = slices(vocab, itemsize)
    v = (x / np.float32(max(temp, 1e-6))).astype(np.float32)
    keys = mono(v)
    k = vocab if top_k <= 0 or top_k > vocab else top_k
    kth = np.float32(-np.inf)
    if k < vocab:
        kth = unmono(np.uint32(radix_kth(keys, k, parts)))
    masked = np.where(v < kth, NEG, v)
    if 0 < top_p < 1:
        q = np.where(v < kth, 0, fixed_mass(v, v.max()))
        edge = radix_edge(keys, q, top_p, parts)
        masked = np.where(mono(masked).astype(np.int64) < edge, NEG, masked)
    tot = (masked + noise).astype(np.float32)
    return int(np.argmax(tot))


def nucleus_tie(x, temp, top_k, top_p):
    """The documented exception (``chip_smoke._nucleus_tie``): top-p on
    and the exclusive cumulative mass (fp64, sorted) at the boundary
    within 1e-5 of top_p."""
    if not 0 < top_p < 1:
        return False
    s = np.sort(x.astype(np.float64) / max(temp, 1e-6))[::-1]
    if 0 < top_k < s.size:
        s = s[:top_k]
    pr = np.exp(s - s.max())
    pr /= pr.sum()
    excl = np.cumsum(pr) - pr
    return bool(np.abs(excl - top_p).min() <= 1e-5)


def _rows(vocab, n, seed, bf16=False):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.normal(size=(n, vocab))).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _tokens_vs_jax(x, cfgs, seed, itemsize=4):
    rows, vocab = x.shape
    t = np.array([c[0] for c in cfgs], np.float32)
    k = np.array([c[1] for c in cfgs], np.int32)
    p = np.array([c[2] for c in cfgs], np.float32)
    seeds = np.random.default_rng(seed).integers(0, 2 ** 32, rows,
                                                 dtype=np.uint64)
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    tk = torch.stack([fs.prng_key(int(s)) for s in seeds])
    ref = np.asarray(jax_sample_reference(
        jnp.asarray(x), jk, jnp.asarray(t), jnp.asarray(k), jnp.asarray(p),
        vocab))
    noise = fs.gumbel(tk, vocab).numpy()
    got = np.array([model_row(x[i], *cfgs[i], noise[i], itemsize)
                    for i in range(rows)])
    bad = [i for i in range(rows) if got[i] != ref[i]
           and not nucleus_tie(x[i], *cfgs[i])]
    assert not bad, (bad, got[bad], ref[bad])
    return got, ref


# ------------------------------------------------------------------ #
# the selection against the bitwise descents
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("vocab", [999, 1001, 32001, 50257, 128256])
def test_radix_kth_equals_bitwise_descent(vocab):
    x = _rows(vocab, 1, vocab)[0]
    keys = mono(x / np.float32(0.8))
    parts = slices(vocab, 4)
    for k in (1, 2, vocab - 1, vocab):
        got = radix_kth(keys, k, parts)
        assert got == bitwise_kth(keys, k)
        assert got == int(np.sort(keys.astype(np.int64))[::-1][k - 1])


@pytest.mark.parametrize("vocab", [999, 1001, 32001, 50257, 128256])
@pytest.mark.parametrize("top_p", [1e-4, 0.5, 0.9, 0.9999])
def test_radix_edge_equals_bitwise_descent(vocab, top_p):
    x = _rows(vocab, 1, vocab + 1)[0]
    v = x / np.float32(0.9)
    keys = mono(v)
    q = fixed_mass(v, v.max())
    assert radix_edge(keys, q, top_p, slices(vocab, 4)) == bitwise_edge(
        keys, q, top_p)


def test_repeated_values_at_the_kth_place():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 6, size=5000).astype(np.float32)
    keys = mono(x)
    for k in (1, 40, 833, 834, 4999):
        kth = unmono(np.uint32(radix_kth(keys, k, slices(5000, 4))))
        assert kth == np.sort(x)[::-1][k - 1]
        assert (x >= kth).sum() >= k


def test_all_equal_row():
    x = np.full(4097, 0.25, np.float32)
    keys = mono(x)
    parts = slices(4097, 4)
    for k in (1, 2, 4096):
        assert unmono(np.uint32(radix_kth(keys, k, parts))) == np.float32(0.25)
    q = fixed_mass(x, x.max())
    assert q[0] == 2 ** 40
    # every entry carries the same mass: the boundary is the one key
    assert radix_edge(keys, q, 0.3, parts) == int(keys[0])


def test_fixed_point_mass_bound():
    """Z in 2^-40 fixed point is within vocab * 2^-41 of the exact sum
    of the fp32 exponentials (the bound the module documents)."""
    x = _rows(128256, 1, 7)[0]
    e = np.exp((x - x.max()).astype(np.float32)).astype(np.float64)
    z = int(fixed_mass(x, x.max()).sum()) * 2.0 ** -40
    assert abs(z - math.fsum(e)) <= x.size * 2.0 ** -41


# ------------------------------------------------------------------ #
# the model's tokens against the JAX reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("vocab", [999, 1001, 32001, 50257, 128256])
def test_model_tokens_match_jax(vocab):
    cfgs = [(0.0, 0, 0.0), (1.0, 1, 0.0), (1.0, 2, 0.0),
            (1.0, vocab - 1, 0.0), (0.9, vocab, 0.0), (0.8, 0, 1e-4),
            (1.1, 0, 0.9999), (0.7, 50, 0.9), (1.0, 0, 0.0)]
    x = _rows(vocab, len(cfgs), vocab + 2)
    _tokens_vs_jax(x, cfgs, vocab)


@pytest.mark.parametrize("vocab", [1001, 32001])
def test_model_tokens_match_jax_bf16_logits(vocab):
    cfgs = [(0.8, 40, 0.0), (1.0, 0, 0.5), (0.6, 10, 0.95), (0.0, 0, 0.0)]
    x = _rows(vocab, len(cfgs), vocab + 3, bf16=True)
    _tokens_vs_jax(x, cfgs, vocab + 1, itemsize=2)


def test_model_tokens_match_jax_on_ties_and_flat_rows():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 6, size=(5, 5000)).astype(np.float32)
    x[1] = 0.5
    x[2] = np.round(2 * rng.normal(size=5000) * 8) / 8
    cfgs = [(1.0, 40, 0.0), (1.0, 7, 0.5), (0.9, 100, 0.9),
            (1.0, 4999, 0.0), (1.0, 0, 0.7)]
    _tokens_vs_jax(x, cfgs, 5)


# ------------------------------------------------------------------ #
# host-side arithmetic: the plan and the softmax's magic divisors
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("itemsize", [2, 4])
def test_sample_plan_covers_every_vocab(itemsize):
    for vocab in [1, 7, 15, 16, 17, 999, 1001, 1024, 1025, 32000, 32001,
                  50257, 128256, 152064, 256000, 10 ** 6]:
        for rows in (1, 4, 8, 16, 40, 200):
            c, sl, res = fs.sample_plan(rows, vocab, itemsize, CAPACITY)
            assert c in fs.CLUSTER_SIZES and sl % 16 == 0
            assert sl == -(-(-(-vocab // c)) // 16) * 16
            assert c * sl >= vocab and (c - 1) * sl < vocab
            assert res == (sl * (4 + itemsize) + 16 <= fs.SMEM_CAP)

            def fits(n):
                per = -(-(-(-vocab // n)) // 16) * 16
                return per * (4 + itemsize) + 16 <= fs.SMEM_CAP
            # the fewest CTAs that keep the slice on chip (16 if none do),
            # grown to the most that keep one wave and slices >= MIN_SLICE
            least = min([n for n in CAPACITY if fits(n)], default=16)
            grown = [n for n in CAPACITY if n > least and rows <= CAPACITY[n]
                     and -(-vocab // n) > fs.MIN_SLICE - 16
                     and -(-(-(-vocab // n)) // 16) * 16 >= fs.MIN_SLICE]
            assert c == max(grown, default=least)


def test_sample_plan_main_shapes():
    assert fs.sample_plan(4, 32000, 2, CAPACITY) == (16, 2000, True)
    assert fs.sample_plan(8, 128256, 4, CAPACITY) == (16, 8016, True)
    assert fs.sample_plan(16, 32000, 2, CAPACITY) == (8, 4000, True)
    assert fs.sample_plan(40, 128256, 4, CAPACITY) == (8, 16032, True)
    assert fs.sample_plan(1, 999, 4, CAPACITY) == (1, 1008, True)
    assert fs.sample_plan(1, 10 ** 6, 4, CAPACITY)[2] is False
    # a card without clusters of 16 (or of any size) still gets a plan
    assert fs.sample_plan(8, 128256, 4, {1: 132, 2: 66, 4: 33, 8: 16}) == (
        8, 16032, True)
    assert fs.sample_plan(8, 128256, 4, {}) == (1, 128256, False)


def test_softmax_magic_division_matches_python():
    rng = np.random.default_rng(0)
    divisors = list(range(1, 2049)) + [2 ** j + e for j in range(11, 31)
                                       for e in (-1, 0, 1)]
    xs = np.concatenate([np.arange(0, 5000),
                         rng.integers(0, 2 ** 31, 2000),
                         [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30]]).tolist()
    for d in divisors:
        mg = S._magic(d)
        assert 0 < mg[0] < 2 ** 32
        for x in xs:
            q = S._magic_div(x, mg)
            assert q == x // d and x - q * d == x % d
    with pytest.raises(ValueError):
        S._magic(0)
