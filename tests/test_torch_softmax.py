"""The port's fused scale-mask-softmax held against the JAX package's.

The plain forward and its gradient (torch autograd through the port's
``_SoftmaxFn``) against ``apex_tpu.ops.fused_scale_mask_softmax`` and
``jax.vjp`` of it: with the Pallas kernels in interpret mode at
``sk`` in {128, 256, 512} (512: BERT's scores, the backward's 16-value
rows), and against the JAX XLA reference at ragged ``sk``
(37, 100), where the JAX dispatch itself takes the reference.  Cases:
masks of shape (b,1,1,sk), (b,1,sq,sk) and (sq,sk); causal with
``sq == sk`` and ``sq < sk``; a fully masked row (uniform ``1/sk``, not
NaN); fp32, bf16 and fp16.  ``FusedScaleMaskSoftmax`` with ``padding``
and ``causal`` masks and with fusion off; the RoPE aliases of
``transformer.functional``.  Inputs come from numpy with fixed seeds.
Tolerances: fp32 within 1e-6 (sums in another order); bf16/fp16 within
one ulp of the JAX value — for the gradient, given the same saved ``y``
(the JAX backward kernel run on JAX's ``y``); end to end, one ulp plus
what one-ulp differences of the saved half-precision ``y`` carry into
``(dy - sum(dy*y)) * y * scale``.  A fully masked row's gradient
follows the JAX dispatch: at ``sk % 128 == 0`` the Pallas kernel's
``(dy - sum(dy*y)) * y * scale``; at a ragged ``sk`` (37, and causal
``sq > sk``) ``jax.vjp`` of the XLA reference, which differentiates
through ``where`` and gives 0 at every masked position.  Tests marked
``cuda`` hold the kernels against the plain version on a GPU and skip
without one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.rope import fused_rope as jax_rope
from apex_tpu.ops.rope import rope_cos_sin as jax_cos_sin
from apex_tpu.ops.softmax import fused_scale_mask_softmax as jax_softmax
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFusedScaleMaskSoftmax,
)
from apex_tpu_torch import _build
from apex_tpu_torch.ops import fused_scale_mask_softmax
from apex_tpu_torch.ops import softmax as S
from apex_tpu_torch.transformer import (
    AttnMaskType,
    AttnType,
    FusedScaleMaskSoftmax,
    LayerType,
    ModelType,
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}
_MANT = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
# spacing of the subnormals, the ulp below the smallest normal
_SUB = {torch.float32: 2.0 ** -149, torch.bfloat16: 2.0 ** -133,
        torch.float16: 2.0 ** -24}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, dtype):
    """fp32 within 1e-6; half types within one ulp of the JAX value."""
    got = got.detach().float().numpy()
    ref = _np(ref)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        return
    bad = np.abs(got - ref) > _ulp(ref, dtype)
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond one ulp; "
                           f"worst {np.abs(got - ref).max()}")


def _ulp(a, dtype):
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.maximum(np.exp2(np.floor(np.log2(mag)) - _MANT[dtype]),
                      _SUB[dtype])


def _grad_close(dx, dxj, yj, dy, scale, dtype):
    """``dx`` against JAX's: fp32 within 1e-6; half types within one ulp
    plus the bound that one-ulp differences of the saved ``y`` carry."""
    if dtype == torch.float32:
        _close(dx, dxj, dtype)
        return
    got, ref = dx.detach().float().numpy(), _np(dxj)
    y = _np(yj).astype(np.float64)
    d = dy.float().numpy().astype(np.float64)
    uy = _ulp(y, dtype)
    inner = (d * y).sum(-1, keepdims=True)
    d_inner = (np.abs(d) * uy).sum(-1, keepdims=True)
    bound = (d_inner * np.abs(y) + np.abs(d - inner) * uy) * scale \
        + _ulp(ref, dtype)
    bad = np.abs(got - ref) > bound
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond the bound"


def _case(shape, mask_shape, seed, dtype, full_row=False):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    mask = None
    if mask_shape is not None:
        mask = rng.random(mask_shape) < 0.3
        if full_row:
            mask[(0,) * (len(mask_shape) - 1)] = True
    xt = torch.from_numpy(x).to(dtype)
    # the JAX side gets the same rounded values
    xj = jnp.asarray(xt.float().numpy(), _JDT[dtype])
    dyt = torch.from_numpy(dy).to(dtype)
    dyj = jnp.asarray(dyt.float().numpy(), _JDT[dtype])
    return xt, xj, dyt, dyj, mask


def _both(xt, xj, dyt, dyj, mask, scale, causal, impl):
    x = xt.clone().requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    y = fused_scale_mask_softmax(x, m, scale=scale, causal=causal)
    (dx,) = torch.autograd.grad(y, x, dyt)
    mj = None if mask is None else jnp.asarray(mask)
    yj, vjp = jax.vjp(lambda a: jax_softmax(
        a, mj, scale=scale, causal=causal, implementation=impl), xj)
    (dxj,) = vjp(dyj)
    return y, dx, yj, dxj


_CASES = [
    # shape, mask shape, causal
    ((2, 2, 16, None), (2, 1, 1, None), False),
    ((2, 2, 16, None), (2, 1, 16, None), False),
    ((2, 2, 16, None), (16, None), False),
    ((2, 2, None, None), None, True),                # sq == sk
    ((2, 2, 8, None), (2, 1, 1, None), True),        # sq < sk
]


def _fill(t, sk):
    return None if t is None else tuple(sk if d is None else d for d in t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sk", [128, 256, 512])
@pytest.mark.parametrize("ci", range(len(_CASES)))
def test_matches_the_pallas_kernel(ci, sk, dtype):
    shape, mshape, causal = _CASES[ci]
    shape, mshape = _fill(shape, sk), _fill(mshape, sk)
    xt, xj, dyt, dyj, mask = _case(shape, mshape, ci * 7 + sk, dtype)
    y, dx, yj, dxj = _both(xt, xj, dyt, dyj, mask, 0.125, causal,
                           "pallas_interpret")
    assert y.dtype == dtype and dx.dtype == dtype
    _close(y, yj, dtype)
    _grad_close(dx, dxj, yj, dyt, 0.125, dtype)
    # the backward alone, from the same saved y: one ulp
    from apex_tpu.ops.softmax import _run_softmax_bwd
    ref = _run_softmax_bwd(dyj.reshape(-1, sk), yj.reshape(-1, sk), 0.125,
                           True)
    got = S.softmax_bwd_reference(
        dyt, torch.from_numpy(_np(yj).copy()).to(dtype), 0.125)
    _close(got.reshape(-1, sk), ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [37, 100])
@pytest.mark.parametrize("ci", range(len(_CASES)))
def test_ragged_rows_match_the_jax_reference(ci, sk, dtype):
    shape, mshape, causal = _CASES[ci]
    shape, mshape = _fill(shape, sk), _fill(mshape, sk)
    xt, xj, dyt, dyj, mask = _case(shape, mshape, ci * 11 + sk, dtype)
    y, dx, yj, dxj = _both(xt, xj, dyt, dyj, mask, 0.5, causal, "xla")
    _close(y, yj, dtype)
    _grad_close(dx, dxj, yj, dyt, 0.5, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_fully_masked_row_is_uniform_like_the_kernel(dtype):
    xt, xj, dyt, dyj, mask = _case((2, 2, 8, 128), (2, 1, 8, 128), 3,
                                   dtype, full_row=True)
    y, dx, yj, dxj = _both(xt, xj, dyt, dyj, mask, 0.125, False,
                           "pallas_interpret")
    _close(y, yj, dtype)
    _grad_close(dx, dxj, yj, dyt, 0.125, dtype)
    row = y[0, 0, 0].float()
    assert torch.isfinite(y).all()
    torch.testing.assert_close(row, torch.full_like(row, 1 / 128),
                               rtol=0, atol=1e-3)
    # the reference's forward agrees at a ragged width as well
    xt, xj, _, _, mask = _case((1, 1, 4, 37), (4, 37), 4, dtype,
                               full_row=True)
    yr = fused_scale_mask_softmax(xt, torch.from_numpy(mask), scale=0.5)
    _close(yr, jax_softmax(xj, jnp.asarray(mask), scale=0.5,
                           implementation="xla"), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["masked_row_sk37", "causal_sq6_sk4"])
def test_ragged_masked_rows_get_the_where_gradient(case, dtype):
    """At a ragged width the JAX package differentiates the reference
    composition: dx is 0 on a fully masked row and at every causal-dead
    position; the port's gradient equals ``jax.vjp`` of it."""
    if case == "masked_row_sk37":
        xt, xj, dyt, dyj, mask = _case((2, 2, 5, 37), (2, 1, 5, 37), 21,
                                       dtype, full_row=True)
        causal = False
    else:
        xt, xj, dyt, dyj, _ = _case((2, 2, 6, 4), None, 22, dtype)
        mask, causal = None, True
    y, dx, yj, dxj = _both(xt, xj, dyt, dyj, mask, 0.5, causal, "xla")
    _close(y, yj, dtype)
    _grad_close(dx, dxj, yj, dyt, 0.5, dtype)
    dead = S._masked(tuple(xt.shape),
                     None if mask is None else torch.from_numpy(mask),
                     causal, "cpu").expand(xt.shape)
    assert bool(dead.any())
    assert bool((dx[dead] == 0).all()) and bool((_t(dxj)[dead] == 0).all())
    # fully dead rows: the whole row's gradient is 0, as in JAX
    rows = dead.all(-1)
    assert bool(rows.any()) and bool((dx[rows] == 0).all())


def test_kernel_width_keeps_the_kernel_gradient_on_a_masked_row():
    """At sk = 128 the JAX dispatch runs the Pallas kernels: the fully
    masked row keeps ``(dy - sum(dy*y)) * y * scale``, nonzero."""
    xt, _, dyt, _, mask = _case((1, 2, 4, 128), (1, 1, 4, 128), 23,
                                torch.float32, full_row=True)
    x = xt.clone().requires_grad_()
    m = torch.from_numpy(mask)
    y = fused_scale_mask_softmax(x, m, scale=0.5)
    (dx,) = torch.autograd.grad(y, x, dyt)
    assert torch.equal(dx, S.softmax_bwd_reference(dyt, y.detach(), 0.5))
    assert bool((dx[0, :, 0] != 0).any())


def _t(a):
    return torch.from_numpy(_np(a).copy())


def test_no_grad_path_and_plain_composition_agree():
    xt, _, dyt, _, mask = _case((2, 3, 8, 40), (2, 1, 1, 40), 5,
                                torch.float32)
    m = torch.from_numpy(mask)
    y = fused_scale_mask_softmax(xt, m, scale=0.3, causal=True)
    ref = S.scale_mask_softmax_reference(xt, m, 0.3, True)
    assert torch.equal(y, ref)
    dx = S.softmax_bwd_reference(dyt, y, 0.3)
    x = xt.clone().requires_grad_()
    (dx2,) = torch.autograd.grad(
        fused_scale_mask_softmax(x, m, scale=0.3, causal=True), x, dyt)
    assert torch.equal(dx, dx2)
    # an integer mask is read as a boolean; rank-2 and rank-5 scores work
    y_int = fused_scale_mask_softmax(xt, m.to(torch.int32), scale=0.3,
                                     causal=True)
    assert torch.equal(y_int, y)
    x2 = xt[0, 0]
    assert torch.equal(fused_scale_mask_softmax(x2, scale=0.3),
                       S.scale_mask_softmax_reference(x2, None, 0.3))
    x5 = xt.reshape(1, 2, 3, 8, 40)
    assert fused_scale_mask_softmax(x5, scale=0.3).shape == x5.shape


@pytest.mark.parametrize("mask_type", ["padding", "causal"])
@pytest.mark.parametrize("fusion", [True, False])
def test_fused_scale_mask_softmax_wrapper(mask_type, fusion):
    xt, xj, dyt, dyj, mask = _case((2, 2, 16, 128), (2, 1, 1, 128), 6,
                                   torch.float32)
    causal = mask_type == "causal"
    port = FusedScaleMaskSoftmax(getattr(AttnMaskType, mask_type),
                                 scale=0.125,
                                 scaled_masked_softmax_fusion=fusion)
    ref = JaxFusedScaleMaskSoftmax(getattr(JaxMaskType, mask_type),
                                   scale=0.125,
                                   scaled_masked_softmax_fusion=fusion)
    m = None if causal else mask
    x = xt.clone().requires_grad_()
    y = port(x, None if m is None else torch.from_numpy(m))
    (dx,) = torch.autograd.grad(y, x, dyt)
    yj, vjp = jax.vjp(lambda a: ref(a, None if m is None else jnp.asarray(m)),
                      xj)
    _close(y, yj, torch.float32)
    _close(dx, vjp(dyj)[0], torch.float32)
    assert port.scale == 0.125 and port.fusion is fusion
    assert FusedScaleMaskSoftmax().scale == 1.0


def test_enums_match_jax():
    from apex_tpu.transformer import enums as je
    for port, jax_enum in ((LayerType, je.LayerType), (AttnType, je.AttnType),
                           (AttnMaskType, je.AttnMaskType),
                           (ModelType, je.ModelType)):
        assert {m.name: m.value for m in port} == {
            m.name: m.value for m in jax_enum}


@pytest.mark.parametrize("cached", [False, True])
def test_rope_aliases_match_jax(cached):
    rng = np.random.default_rng(9)
    t = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    if cached:
        cj, sj = jax_cos_sin(16, 32)
        got = fused_apply_rotary_pos_emb_cached(
            torch.from_numpy(t), torch.from_numpy(np.asarray(cj)),
            torch.from_numpy(np.asarray(sj)))
        ref = jax_rope(jnp.asarray(t), cj, sj, implementation="xla")
    else:
        got = fused_apply_rotary_pos_emb(torch.from_numpy(t), base=500.0)
        cj, sj = jax_cos_sin(16, 32, base=500.0)
        ref = jax_rope(jnp.asarray(t), cj, sj, implementation="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_kernel_entries_and_cpu_refusal():
    assert _build.SOURCES["softmax"] == "softmax.cu"
    assert {"softmax_fwd", "softmax_bwd"} <= set(_build.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fused_scale_mask_softmax(torch.zeros(2, 8), implementation="kernel")


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,mshape,causal", [
    ((2, 4, 64, 512), (2, 1, 1, 512), False),
    ((2, 8, 64, 320), None, True),
    ((3, 2, 16, 77), (16, 77), False),
    ((1, 2, 8, 2000), (1, 1, 8, 2000), True),
])
def test_kernels_match_plain_on_card(shape, mshape, causal, dtype,
                                     cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (3 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    m = None if mshape is None else torch.rand(
        mshape, generator=g, device=cuda_device) < 0.3
    y = S.softmax_fwd_kernel(x, m, 0.125, causal)
    yp = S.scale_mask_softmax_reference(x, m, 0.125, causal)
    dx = S.softmax_bwd_kernel(dy, yp, 0.125)
    dxp = S.softmax_bwd_reference(dy, yp, 0.125)
    # the backward also moves by what another order of its row sum can:
    # log2(sk) roundings of sum |dy*y| per tree, two trees, times y*scale
    mag = (dy.float() * yp.float()).abs().sum(-1, keepdim=True)
    order = (2 * math.ceil(math.log2(shape[-1])) * 2.0 ** -24 * mag
             * yp.float().abs() * 0.125)
    for got, ref, extra in ((y, yp, 0.0), (dx, dxp, order)):
        if dtype == torch.float32:
            assert bool(((got - ref).abs() <= 2e-6 + extra).all())
        else:
            r = ref.float().abs().clamp_min(1e-30)
            ulp = torch.exp2(torch.floor(torch.log2(r)) - _MANT[dtype])
            ulp = ulp.clamp_min(_SUB[dtype])
            assert bool(((got.float() - ref.float()).abs()
                         <= ulp + extra).all())
