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

Inputs come from numpy with fixed seeds; JAX gets the values the port's
dtype rounds them to.  Tolerances: fp32 rtol 2e-5, atol 1e-5 (sums in
another order; dγ/dβ, sums over the whole batch, relative to the largest
entry); bf16 within one ulp of the JAX value (both compute in fp32 and
round once; near zero, plus 2^-20 of the largest magnitude).  Tests
marked ``cuda`` hold the kernels against the plain
versions on a GPU and skip without one.
"""

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
    group_norm_bwd_kernel,
    group_norm_bwd_reference,
    group_norm_fwd_kernel,
    group_norm_fwd_reference,
)

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
    assert {"group_norm_fwd", "group_norm_bwd"} <= set(_build.launches)
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
])
def test_kernels_match_plain_on_card(shape, g, act, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    c = shape[-1]
    w = 1 + 0.2 * torch.randn(c, generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
    silu = act == "silu"
    y, m, r = group_norm_fwd_kernel(_x3(x), w, b, g, 1e-5, silu)
    y2, m2, r2 = group_norm_fwd_reference(_x3(x), w, b, g, 1e-5, silu)
    dx, dw, db = group_norm_bwd_kernel(_x3(dy), _x3(x), w, b, m2, r2, g,
                                       silu)
    dx2, dw2, db2 = group_norm_bwd_reference(_x3(dy), _x3(x), w, b, m2, r2,
                                             g, silu)
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
