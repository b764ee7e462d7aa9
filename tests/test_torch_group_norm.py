"""The port's fused GroupNorm(+SiLU) held against the JAX package's.

- ``group_norm`` on the CPU (the reference composition, torch autograd)
  against JAX's ``group_norm_reference`` and ``jax.vjp`` of it: values and
  the gradients of x, γ and β, fp32 and bf16, with and without SiLU and
  the affine, ragged C (cg = 10) and spatial (7 × 9, three groups), the
  2-D ``(N, C)`` case.
- The plain versions of the two kernels (``group_norm_fwd_reference``,
  ``group_norm_bwd_reference``, the formulas the CUDA kernels compute)
  against ``group_norm(..., implementation="pallas_interpret")`` and
  ``jax.grad`` through it, as ``tests/test_ops.py`` runs the Pallas
  kernels on the CPU, where its envelope takes the shape (C % 128 == 0,
  an 8-aligned divisor of H·W), and against the torch autograd of the
  reference elsewhere.
- A mean offset of 100: the two-pass variance against float64.
- The checks, the ``GroupNorm`` module against the JAX module with its
  parameters carried over by ``group_norm_params_from_jax``.
- The route predicate ``cluster_plan``: the main shapes take the cluster
  route within a CTA's 227 KB and 16 CTAs a cluster, a VAE decoder's
  512 × 512 slab and SD-1.5's and SDXL's UNet widths (cg = 10, 20, 40) the
  three-pass route, and every C divisible by the groups gets a route
  whose geometry the cluster kernels take.

Inputs come from numpy with fixed seeds; JAX gets the values the port's
dtype rounds them to.  Tolerances: fp32 rtol 2e-5, atol 1e-5 (sums in
another order; dγ/dβ, sums over the whole batch, relative to the largest
entry); bf16 within one ulp of the JAX value (both compute in fp32 and
round once; near zero, plus 2^-20 of the largest magnitude).  Tests
marked ``cuda`` hold the kernels against the plain
versions on a GPU and skip without one.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import GroupNorm as JaxGroupNorm
from apex_tpu.ops import group_norm as jax_group_norm
from apex_tpu.ops.group_norm import group_norm_reference as jax_reference
from apex_tpu_torch import _build
from apex_tpu_torch.models import group_norm_params_from_jax
from apex_tpu_torch.ops import GroupNorm, group_norm
from apex_tpu_torch.ops.group_norm import (
    CLUSTER_SIZES,
    CLUSTER_THREADS,
    cluster_plan,
    group_norm_bwd_kernel,
    group_norm_bwd_reference,
    group_norm_fwd_kernel,
    group_norm_fwd_reference,
    rows_per_cta,
)

# the module (the package attribute ``ops.group_norm`` is the function)
_gn_ops = importlib.import_module("apex_tpu_torch.ops.group_norm")

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulp_ok(got, ref):
    """bf16: within one ulp of the reference value, plus 2^-20 of the
    largest magnitude (near zero a few fp32 ulps of the unrounded values
    outweigh a bf16 ulp of the tiny result)."""
    got = got.detach().float().numpy()
    ref = _np(ref)
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    ulp = np.maximum(np.exp2(np.floor(np.log2(mag)) - 7), 2.0 ** -133)
    ulp = ulp + 2.0 ** -20 * float(np.abs(ref).max())
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond one ulp; "
                           f"worst {np.abs(got - ref).max()}")


def _close(got, ref, dtype, *, rel_to_max=False):
    if dtype == torch.bfloat16:
        _ulp_ok(got, ref)
        return
    got = got.detach().float().numpy()
    ref = _np(ref)
    if rel_to_max:
        # a sum over the whole batch: relative to its largest entry
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * float(np.abs(ref).max()))
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def _inputs(shape, seed, dtype, offset=0.0, affine=True):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (offset + rng.normal(size=shape)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.5 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    dyt = torch.from_numpy(dy).to(dtype)
    xj = jnp.asarray(xt.float().numpy(), _JDT[dtype])
    dyj = jnp.asarray(dyt.float().numpy(), _JDT[dtype])
    if not affine:
        return xt, dyt, xj, dyj, None, None
    return xt, dyt, xj, dyj, torch.from_numpy(w), torch.from_numpy(b)


def _port(xt, dyt, w, b, g, act):
    """y and the gradients of x, γ, β (None for a missing parameter)."""
    leaves = [xt.clone().requires_grad_()]
    wt = None if w is None else w.clone().requires_grad_()
    bt = None if b is None else b.clone().requires_grad_()
    y = group_norm(leaves[0], g, wt, bt, act=act)
    args = [t for t in (leaves[0], wt, bt) if t is not None]
    grads = torch.autograd.grad(y, args, dyt)
    return y, grads


def _jax(xj, dyj, w, b, g, act, impl="xla"):
    args = [xj] + [jnp.asarray(t.numpy()) for t in (w, b) if t is not None]

    def f(a, *wb):
        ww = wb[0] if w is not None else None
        bb = wb[-1] if b is not None else None
        if impl == "xla":
            return jax_reference(a, g, ww, bb, act=act)
        return jax_group_norm(a, g, ww, bb, act=act, implementation=impl)
    y, vjp = jax.vjp(f, *args)
    return y, vjp(dyj)


_CASES = [
    # shape, groups
    ((2, 4, 4, 128), 8),
    ((2, 3, 5, 40), 4),          # cg = 10, odd spatial
    ((3, 7, 9, 96), 3),          # odd spatial, three groups
    ((4, 64), 8),                # 2-D (N, C)
]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", range(len(_CASES)))
def test_matches_the_jax_reference(ci, dtype, act, affine):
    shape, g = _CASES[ci]
    xt, dyt, xj, dyj, w, b = _inputs(shape, ci * 13 + 1, dtype,
                                     affine=affine)
    y, grads = _port(xt, dyt, w, b, g, act)
    yj, gj = _jax(xj, dyj, w, b, g, act)
    assert y.dtype == dtype and y.shape == xt.shape
    _close(y, yj, dtype)
    _close(grads[0], gj[0], dtype)
    for got, ref in zip(grads[1:], gj[1:]):
        assert got.dtype == torch.float32
        _close(got, ref, torch.float32, rel_to_max=True)


def _x3(t):
    return t.reshape(t.shape[0], -1, t.shape[-1])


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_kernel_versions_match_the_pallas_kernels(dtype, act, affine):
    """B-16 / B-17's plain versions against the Pallas kernels in
    interpret mode: y, and dx, dγ, dβ from the saved statistics."""
    shape, g = (2, 4, 4, 256), 8
    xt, dyt, xj, dyj, w, b = _inputs(shape, 7, dtype, affine=affine)
    yj, gj = _jax(xj, dyj, w, b, g, act, impl="pallas_interpret")
    y, mean, rstd = group_norm_fwd_reference(_x3(xt), w, b, g, 1e-5,
                                             act == "silu")
    dx, dw, db = group_norm_bwd_reference(_x3(dyt), _x3(xt), w, b, mean,
                                          rstd, g, act == "silu")
    _close(y.reshape(shape), yj, dtype)
    _close(dx.reshape(shape), gj[0], dtype)
    if affine:
        _close(dw, gj[1], torch.float32, rel_to_max=True)
        _close(db, gj[2], torch.float32, rel_to_max=True)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("ci", range(len(_CASES)))
def test_plain_kernel_versions_match_autograd(ci, act):
    """Where the Pallas envelope refuses the shape: the plain kernel
    versions against the torch autograd of the reference composition
    (fp32)."""
    shape, g = _CASES[ci]
    xt, dyt, _, _, w, b = _inputs(shape, ci + 40, torch.float32)
    y_ref, (dx_ref, dw_ref, db_ref) = _port(xt, dyt, w, b, g, act)
    y, mean, rstd = group_norm_fwd_reference(_x3(xt), w, b, g, 1e-5,
                                             act == "silu")
    dx, dw, db = group_norm_bwd_reference(_x3(dyt), _x3(xt), w, b, mean,
                                          rstd, g, act == "silu")
    assert torch.equal(y.reshape(shape), y_ref.detach())
    torch.testing.assert_close(dx.reshape(shape), dx_ref, rtol=2e-5,
                               atol=1e-5)
    for got, ref in ((dw, dw_ref), (db, db_ref)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=2e-5 * float(ref.abs().max()))
    # the saved statistics are the reference's, per (sample, group)
    n, c = shape[0], shape[-1]
    xf = xt.reshape(n, -1, g, c // g).double()
    np.testing.assert_allclose(mean.numpy(), xf.mean((1, 3)).numpy(),
                               rtol=1e-6, atol=1e-6)
    var = xf.var((1, 3), unbiased=False)
    np.testing.assert_allclose(rstd.numpy(),
                               (1 / np.sqrt(var.numpy() + 1e-5)), rtol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
def test_mean_offset_100_two_pass_variance(act):
    """|mean| / σ ≈ 100: the two-pass variance holds rstd within 1e-5 of
    float64 (a one-pass E[x²] − mean² loses more than 1e-4 of it here);
    the mean is an fp32 sum of values near 100, within 1e-6 of them; and
    y is the float64 normalisation by those statistics at fp32
    tolerance."""
    shape, g = (2, 8, 8, 128), 8
    xt, _, _, _, w, b = _inputs(shape, 5, torch.float32, offset=100.0)
    y3, mean, rstd = group_norm_fwd_reference(_x3(xt), w, b, g, 1e-5,
                                              act == "silu")
    assert torch.equal(y3.reshape(shape), group_norm(xt, g, w, b, act=act))
    x64 = xt.double().reshape(2, -1, g, 16)
    mean64 = x64.mean((1, 3))
    var64 = ((x64 - mean64[:, None, :, None]) ** 2).mean((1, 3))
    np.testing.assert_allclose(rstd.double(), 1 / torch.sqrt(var64 + 1e-5),
                               rtol=1e-5, atol=0)
    assert float((mean.double() - mean64).abs().max()) <= 1e-6 * 100
    xf = xt.reshape(2, -1, g, 16)
    one_pass = (xf * xf).mean((1, 3)) - xf.mean((1, 3)) ** 2
    assert float(((one_pass.double() - var64) / var64).abs().max()) > 1e-4
    m = mean.double().reshape(2, 1, g, 1)
    r = rstd.double().reshape(2, 1, g, 1)
    z = ((x64 - m) * r).reshape(shape) * w.double() + b.double()
    if act == "silu":
        z = z * torch.sigmoid(z)
    torch.testing.assert_close(y3.reshape(shape).double(), z, rtol=2e-5,
                               atol=1e-5)


def test_checks():
    x = torch.zeros(1, 2, 2, 10)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm(x, 3)
    with pytest.raises(ValueError, match="unknown act"):
        group_norm(x, 2, act="relu")
    with pytest.raises(ValueError, match="CUDA"):
        group_norm(x, 2, implementation="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_fwd_kernel(x.reshape(1, 4, 10), None, None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_bwd_kernel(x.reshape(1, 4, 10), x.reshape(1, 4, 10),
                              None, None, torch.zeros(1, 2),
                              torch.zeros(1, 2), 2)
    with pytest.raises(ValueError, match="not divisible"):
        GroupNorm(3, 10, device="cpu")
    assert _build.SOURCES["group_norm"] == "group_norm.cu"
    assert {"group_norm_fwd", "group_norm_bwd", "group_norm_fwd_3pass",
            "group_norm_bwd_3pass"} <= set(_build.launches)
    # the JAX package raises the same way
    with pytest.raises(ValueError, match="not divisible"):
        jax_group_norm(jnp.zeros((1, 2, 2, 10)), 3)


@pytest.mark.parametrize("use_scale,use_bias,act",
                         [(True, True, "silu"), (False, True, None),
                          (True, False, None)])
def test_module_matches_the_jax_module(use_scale, use_bias, act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    jm = JaxGroupNorm(num_groups=8, use_scale=use_scale, use_bias=use_bias,
                      act=act)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial parameters, carried to the port by name
    params = jax.tree.map(
        lambda a: a + jnp.asarray(0.3 * rng.normal(size=a.shape),
                                  a.dtype), params)
    m = GroupNorm(8, 64, use_scale=use_scale, use_bias=use_bias, act=act,
                  device="cpu")
    assert sorted(n for n, _ in m.named_parameters()) == sorted(
        params["params"])
    m.load_state_dict(group_norm_params_from_jax(jax.device_get(params)))
    y = m(torch.from_numpy(x))
    yj = jm.apply(params, jnp.asarray(x))
    _close(y, yj, torch.float32)
    y.sum().backward()
    for p in m.parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype


def test_module_defaults_match_jax():
    m = GroupNorm(32, 320, device="cpu")
    assert m.scale.shape == (320,) and torch.equal(m.scale, torch.ones(320))
    assert torch.equal(m.bias, torch.zeros(320))
    assert m.epsilon == JaxGroupNorm(num_groups=32).epsilon
    assert GroupNorm(4, 8, dtype=torch.bfloat16,
                     device="cpu").scale.dtype == torch.bfloat16


# ------------------------------------------------------------------ #
# the route predicate (plain Python: which kernels a call launches)
# ------------------------------------------------------------------ #
# clusters at once by size on a card that runs every size (the H100 runs
# 7 clusters of 16 CTAs that fill an SM each, 15 of 8, 30 of 4)
_CAPACITY = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def _pow2(v):
    return v > 0 and v & (v - 1) == 0


def _plan_ok(plan, batch, rows, c, g, itemsize, backward):
    """The geometry the cluster kernels take (csrc/group_norm.cu
    ``cluster_ok``): whole groups of a power-of-two count of 16-byte
    vectors, a span of whole groups dividing C, every row of a sample in
    the smallest cluster that holds it."""
    vec, cg = 16 // itemsize, c // g
    assert cg % vec == 0 and _pow2(cg // vec)
    assert plan.span % cg == 0 and c % plan.span == 0
    # a power-of-two count of vectors a row, at most a warp's; the
    # backward's per-warp sums take at most 128 channels
    assert _pow2(plan.span // vec) and plan.span // vec <= 32
    assert not backward or plan.span <= 128
    assert plan.cluster in CLUSTER_SIZES and plan.cluster <= 16
    per = rows_per_cta(plan.span, itemsize, backward)
    assert plan.cluster * per >= rows
    assert plan.cluster == 1 or plan.cluster // 2 * per < rows
    slabs = batch * (c // plan.span)
    assert slabs * plan.cluster < 2 ** 31
    assert 1 <= plan.clusters <= min(slabs, _CAPACITY[plan.cluster])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_main_shape_takes_the_cluster_route(itemsize, backward):
    """(8, 64×64, 512), 32 groups: one cluster of at most 16 CTAs a slab,
    a CTA's tile and ring within 227 KB."""
    plan = cluster_plan(8, 4096, 512, 32, itemsize, backward, _CAPACITY)
    assert plan is not None
    _plan_ok(plan, 8, 4096, 512, 32, itemsize, backward)
    # the narrowest whole groups of at least 32 (forward) or 64 (backward)
    # bytes a row: one group of 16 channels, or two in the bf16 backward
    assert plan.span == (32 if backward and itemsize == 2 else 16)
    # a CTA's ring, three stages of its rows of x (and dy), within 227 KB
    tile = rows_per_cta(plan.span, itemsize, backward) * plan.span * (
        itemsize * (2 if backward else 1))
    assert 3 * tile <= 227 * 1024


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_vae_decoder_slab_takes_the_three_pass_route(itemsize, backward):
    """(1, 512×512, 128): a slab of 262144 rows exceeds 16 CTAs."""
    assert cluster_plan(1, 512 * 512, 128, 32, itemsize, backward,
                        _CAPACITY) is None


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,g,route", [
    ((8, 32 * 32, 320), 32, None),        # SD-1.5: cg = 10, not whole vectors
    ((3, 7 * 9, 96), 3, "cluster"),
    ((64, 1, 512), 32, "cluster"),        # the 2-D (N, C) case
    ((2, 16 * 16, 512), 32, "cluster"),
    # SD-1.5's and SDXL's UNet widths (cg = 10, 20, 40): three passes
    ((2, 64 * 64, 320), 32, None),
    ((2, 32 * 32, 640), 32, None),
    ((2, 16 * 16, 1280), 32, None),
    ((2, 128 * 128, 320), 32, None),
    ((1, 64 * 64, 512), 32, "cluster"),   # an SD VAE's 512-channel level
    ((1, 256 * 256, 512), 32, None),      # and a level past 16 CTAs
])
def test_edge_shapes_get_a_route(shape, g, route, itemsize, backward):
    n, rows, c = shape
    plan = cluster_plan(n, rows, c, g, itemsize, backward, _CAPACITY)
    assert (plan is not None) == (route == "cluster")
    if plan is not None:
        _plan_ok(plan, n, rows, c, g, itemsize, backward)


def test_capacity_decides_the_cluster_size():
    """The smallest cluster the card runs that holds the slab: without
    clusters of 8 the bf16 backward at the main shape takes a narrower
    span, whose CTAs hold more rows; with no cluster at all, nothing takes
    the cluster route."""
    no8 = {k: v for k, v in _CAPACITY.items() if k != 8}
    bwd = cluster_plan(8, 4096, 512, 32, 2, True, _CAPACITY)
    assert (bwd.span, bwd.cluster) == (32, 8)
    bwd = cluster_plan(8, 4096, 512, 32, 2, True, no8)
    assert (bwd.span, bwd.cluster) == (32, 16)
    bwd = cluster_plan(8, 4096, 512, 32, 2, True, {4: 30})
    assert (bwd.span, bwd.cluster) == (16, 4)
    fwd = cluster_plan(8, 4096, 512, 32, 2, False, no8)
    assert fwd is not None and (fwd.span, fwd.cluster) == (16, 2)
    assert cluster_plan(8, 4096, 512, 32, 4, False, {}) is None
    small = cluster_plan(2, 63, 96, 3, 4, True, {1: 1})
    assert small is not None and (small.cluster, small.clusters) == (1, 1)


_SWEEP = [(c, g) for c in (8, 16, 24, 32, 40, 64, 96, 128, 192, 256, 320,
                           384, 512, 640, 768, 960, 1024, 1280, 2048, 2560)
          for g in (1, 2, 4, 8, 16, 32) if c % g == 0]


@pytest.mark.parametrize("c,g", _SWEEP)
def test_every_divisible_channel_count_gets_a_route(c, g):
    """Every C divisible by the groups: the cluster route with a geometry
    the kernels take exactly where a group is a power-of-two count of
    16-byte vectors, at most 32 (128 channels in the backward), and a
    sample's rows fit 16 CTAs at a span of one group; else the three-pass
    route (which takes any such C)."""
    for itemsize in (2, 4):
        vec, cg = 16 // itemsize, c // g
        whole = cg % vec == 0 and _pow2(cg // vec) and cg // vec <= 32
        for backward in (False, True):
            fits = whole and (not backward or cg <= 128)
            for rows in (1, 63, 4096, 512 * 512):
                plan = cluster_plan(3, rows, c, g, itemsize, backward,
                                    _CAPACITY)
                cluster = fits and rows <= 16 * rows_per_cta(
                    cg, itemsize, backward)
                assert (plan is not None) == cluster, (itemsize, backward,
                                                       rows)
                if plan is not None:
                    _plan_ok(plan, 3, rows, c, g, itemsize, backward)


@pytest.mark.parametrize("shape,g", [
    ((2, 64 * 64, 320), 32),      # SD-1.5's UNet widths
    ((2, 32 * 32, 640), 32),
    ((2, 16 * 16, 1280), 32),
    ((2, 128 * 128, 320), 32),    # SDXL's
    ((1, 512 * 512, 128), 32),    # a VAE decoder's
    ((3, 7 * 9, 96), 3),
    ((64, 1, 512), 32),
])
def test_three_pass_statistics_chunks_bound_the_fold(shape, g, monkeypatch):
    """The three-pass statistics chunks: at most 8 partials a lane of the
    one-warp fold (chunks x cg <= 256) unless a thread would then walk
    more than 32 rows, never more rows' chunks than there are rows; the
    map pass keeps filling the card (132 SMs, as an H100)."""
    monkeypatch.setattr(_gn_ops, "_sm_count", lambda index: 132)
    x3 = torch.zeros(shape, dtype=torch.bfloat16)
    n, rows, c = shape
    vec, chunks, map_chunks = _gn_ops._geometry(x3, g)
    assert vec == 8
    tx = min(c // vec, 32)
    steps = -(-rows // (256 // tx))
    floor = -(-steps // 32)
    assert 1 <= chunks <= steps and chunks >= floor
    assert chunks <= max(floor, 256 // (c // g))
    tiles = -(-(c // vec) // tx)
    assert map_chunks == max(1, min(steps, -(-8 * 132 // (tiles * n))))


# ------------------------------------------------------------------ #
# any batch (C-10) and strided inputs (C-11)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [65536, 65537, 70000])
@pytest.mark.parametrize("rows,c,g,itemsize", [
    (16, 320, 32, 2),       # cg 10: the three-pass route at any size
    (64, 640, 32, 2),
    (1, 1280, 32, 4),
    (16, 512, 32, 2),       # cg 16: the cluster route
    (4096, 512, 32, 4),
])
def test_launch_geometry_stays_in_range_at_large_batches(n, rows, c, g,
                                                         itemsize,
                                                         monkeypatch):
    """Past 65535 samples (a grid's z limit) both routes launch: the
    three-pass grids are 1-D, at most 2^31 - 1 blocks (csrc/group_norm.cu
    ``grid_of``), with chunks x C under 2^31 for the folds' 32-bit
    indices; a cluster plan's slabs x cluster stay under 2^31 and its
    grid within the card's clusters."""
    monkeypatch.setattr(_gn_ops, "_sm_count", lambda index: 132)
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    # an expanded tensor: the shape and alignment, without the bytes
    x3 = torch.zeros(1, 1, c, dtype=dtype).expand(n, rows, c)
    vec, chunks, map_chunks = _gn_ops._geometry(x3, g)
    assert vec == 16 // itemsize
    for k in (chunks, map_chunks):
        assert 1 <= k <= max(1, rows)
        assert k * c < 2 ** 31
        # csrc/group_norm.cu grid_of: one block a chunk, column tile of
        # up to 32 vectors and sample, on a 1-D grid
        blocks = n * k * -(-(c // vec) // 32)
        assert n <= blocks < 2 ** 31
    for backward in (False, True):
        plan = cluster_plan(n, rows, c, g, itemsize, backward, _CAPACITY)
        if plan is not None:
            slabs = n * (c // plan.span)
            assert slabs * plan.cluster < 2 ** 31
            assert plan.clusters <= _CAPACITY[plan.cluster]
            assert plan.clusters * plan.cluster * CLUSTER_THREADS < 2 ** 31


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_permuted_view_equals_the_contiguous_call(dtype, act):
    """``x.permute(0, 2, 3, 1)`` of an NCHW tensor, not dense in its
    shape's order: the output and the gradient that reaches the NCHW
    tensor equal the contiguous call's (fp32 within 1e-6: the plain
    composition reduces the strided tensor in another order; bf16 within
    one ulp)."""
    rng = np.random.default_rng(21)
    nchw = torch.from_numpy(rng.normal(size=(2, 40, 5, 6)).astype(
        np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(2, 5, 6, 40)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.3 * rng.normal(size=40)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=40)).astype(np.float32))
    a = nchw.clone().requires_grad_()
    view = a.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    y = group_norm(view, 4, w, b, act=act)
    (ga,) = torch.autograd.grad(y, a, dy)
    c = nchw.permute(0, 2, 3, 1).contiguous().requires_grad_()
    y2 = group_norm(c, 4, w, b, act=act)
    (gc,) = torch.autograd.grad(y2, c, dy)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2 ** -8, atol=1e-6)
    torch.testing.assert_close(y, y2, **tol)
    assert ga.shape == nchw.shape and ga.dtype == dtype
    torch.testing.assert_close(ga, gc.permute(0, 3, 1, 2), **tol)


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,g,act", [
    ((2, 16, 16, 512), 32, "silu"),
    ((2, 8, 8, 320), 32, "silu"),
    ((3, 7, 9, 96), 3, None),
    ((16, 64), 8, "silu"),
    ((8, 64, 64, 512), 32, "silu"),       # the main shape: cluster route
    ((1, 512, 512, 128), 32, "silu"),     # a VAE decoder's: three-pass
])
def test_kernels_match_plain_on_card(shape, g, act, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    c = shape[-1]
    w = 1 + 0.2 * torch.randn(c, generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
    silu = act == "silu"
    _build.reset_launches()
    y, m, r = group_norm_fwd_kernel(_x3(x), w, b, g, 1e-5, silu)
    y2, m2, r2 = group_norm_fwd_reference(_x3(x), w, b, g, 1e-5, silu)
    dx, dw, db = group_norm_bwd_kernel(_x3(dy), _x3(x), w, b, m2, r2, g,
                                       silu)
    dx2, dw2, db2 = group_norm_bwd_reference(_x3(dy), _x3(x), w, b, m2, r2,
                                             g, silu)
    # the route cluster_plan picks is the one that launched
    n, rows = _x3(x).shape[:2]
    for name, backward in (("group_norm_fwd", False),
                           ("group_norm_bwd", True)):
        cluster = _gn_ops._route(_x3(x), g, backward) is not None
        assert _build.launches[name] == int(cluster)
        assert _build.launches[name + "_3pass"] == int(not cluster)
    if shape == (8, 64, 64, 512):
        assert _build.launches["group_norm_fwd"] == 1
        assert _build.launches["group_norm_bwd"] == 1
    if shape == (1, 512, 512, 128):
        assert _build.launches["group_norm_fwd_3pass"] == 1
        assert _build.launches["group_norm_bwd_3pass"] == 1
    torch.testing.assert_close(m, m2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r, r2, rtol=1e-5, atol=0)
    for got, ref in ((y, y2), (dx, dx2)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
        else:
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=2 ** -7, atol=2 ** -7)
    for got, ref in ((dw, dw2), (db, db2)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=2e-5 * float(ref.abs().max()))
    # a rerun gives the same bits on either route
    again = group_norm_fwd_kernel(_x3(x), w, b, g, 1e-5, silu) + \
        group_norm_bwd_kernel(_x3(dy), _x3(x), w, b, m2, r2, g, silu)
    for a, ref in zip(again, (y, m, r, dx, dw, db)):
        assert torch.equal(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [320, 512])
def test_large_batch_runs_on_card(c, cuda_device):
    """65537 samples (C-10): the three-pass route (C = 320, groups of 10
    channels) and the cluster route (C = 512) launch and match the plain
    versions."""
    n, rows, g = 65537, 16, 32
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(n, rows, c, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    w = 1 + 0.2 * torch.randn(c, generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
    y, m, r = group_norm_fwd_kernel(x, w, b, g, 1e-5, True)
    y2, m2, r2 = group_norm_fwd_reference(x, w, b, g, 1e-5, True)
    torch.testing.assert_close(m, m2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), y2.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    dx, dw, db = group_norm_bwd_kernel(dy, x, w, b, m2, r2, g, True)
    dx2, dw2, db2 = group_norm_bwd_reference(dy, x, w, b, m2, r2, g, True)
    torch.testing.assert_close(dx.float(), dx2.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    for got, ref in ((dw, dw2), (db, db2)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=2e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_permuted_view_on_card_equals_the_contiguous_call(cuda_device):
    """A permuted NCHW view (C-11) runs the kernels on a dense copy: the
    output and the gradient reaching the NCHW tensor equal the contiguous
    call's bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    nchw = torch.randn(8, 320, 64, 64, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    dy = torch.randn(8, 64, 64, 320, generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    a = nchw.clone().requires_grad_()
    y = group_norm(a.permute(0, 2, 3, 1), 32, act="silu")
    (ga,) = torch.autograd.grad(y, a, dy)
    c = nchw.permute(0, 2, 3, 1).contiguous().requires_grad_()
    y2 = group_norm(c, 32, act="silu")
    (gc,) = torch.autograd.grad(y2, c, dy)
    assert torch.equal(y, y2)
    assert torch.equal(ga, gc.permute(0, 3, 1, 2))
