"""LayerNorm / RMSNorm gradients of the port held against the JAX package.

``fused_layer_norm`` and ``fused_rms_norm`` of the port (on the CPU: the
plain forward with statistics and the plain dx backward, dγ / dβ as
column sums) against ``jax.vjp`` of the JAX functions with their Pallas
kernels in interpret mode and with the XLA composition.  The widths are
those at which the CUDA backward picks its layout: 40 (a row of a few
16-byte vectors), 256, 1000 (not a multiple of 8 vectors a lane), 1024
(BERT: one warp a row), 4096 (a group of warps a row).  Inputs come
from numpy with fixed seeds; bf16 activations carry fp32 weights, as
under amp O2.  Tolerances: an fp32 output within rtol 1e-5 / atol 1e-5
(the two frameworks sum in different orders); a bf16 output within one
bf16 ulp of the reference plus 2^-7 of its largest magnitude (both
round the same fp32 value, whose sums differ in order).

The forward with statistics (``y`` and the fp32 per-row mean and rstd
the backward reads) is also held against the JAX forward kernel
``_run_ln_fwd`` in interpret mode and, for ``y``, the XLA composition, at
those widths and at 100 and 10000, where the CUDA forward falls back to
one block a row (a bf16 row not a whole number of 16-byte vectors; past
the register-resident limit of 8192): ``y`` at the tolerances above,
mean and rstd within rtol 1e-5 / atol 1e-6 (fp32 sums in another order).

Tests marked ``cuda`` hold the forward and backward kernels against
their plain versions on a GPU, and their reruns bitwise, and skip
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.layer_norm import _run_ln_fwd as jax_ln_fwd
from apex_tpu.ops.layer_norm import fused_layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import fused_rms_norm as jax_rms_norm
from apex_tpu_torch.ops import fused_layer_norm, fused_rms_norm
from apex_tpu_torch.ops import layer_norm as L

WIDTHS = (40, 256, 1000, 1024, 4096)
FWD_WIDTHS = WIDTHS + (100, 10000)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(ref):
    r = np.abs(ref)
    return np.where(r > 0, np.exp2(np.floor(np.log2(np.maximum(
        r, 1e-30))) - 7), 0.0)


def _check(got, ref):
    """``got`` (a torch tensor) against ``ref`` (a JAX array) at the
    tolerance of ``got``'s dtype."""
    g = got.detach().float().numpy()
    r = np.asarray(ref, dtype=np.float32)
    assert str(got.dtype) == f"torch.{ref.dtype}"
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    else:
        bound = _bf16_ulp(r) + 2.0 ** -7 * np.abs(r).max()
        assert np.all(np.abs(g - r) <= bound), float(np.abs(g - r).max())


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("affine", [True, False], ids=["fp32w", "noweight"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_norm_gradients_match_jax(rms, impl, dtype, affine, h):
    """dx, dγ, dβ (and y) against ``jax.vjp`` of the JAX norm."""
    rng = np.random.default_rng(h + 7 * rms)
    jdt, tdt = DTYPES[dtype]
    # activations and the cotangent made representable in their dtype,
    # so both frameworks start from the same values
    x = np.array(jnp.asarray(
        (1.5 + rng.normal(size=(2, 3, h))).astype(np.float32), jdt))
    dy = np.array(jnp.asarray(
        rng.normal(size=(2, 3, h)).astype(np.float32), jdt))
    w = (1 + 0.1 * rng.normal(size=h)).astype(np.float32) if affine else None
    b = (0.1 * rng.normal(size=h)).astype(np.float32) \
        if affine and not rms else None

    def jfn(*args):
        xx, ww, bb = (list(args) + [None, None])[:3]
        if rms:
            return jax_rms_norm(xx, ww, eps=1e-5, implementation=impl)
        return jax_layer_norm(xx, ww, bb, eps=1e-5, implementation=impl)
    jargs = [jnp.asarray(x)] + [jnp.asarray(a) for a in (w, b)
                                if a is not None]
    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(dy))

    targs = [torch.from_numpy(x.astype(np.float32)).to(tdt)
             .requires_grad_()]
    targs += [torch.from_numpy(a).requires_grad_() for a in (w, b)
              if a is not None]
    tw = targs[1] if affine else None
    tb = targs[2] if affine and not rms else None
    y = (fused_rms_norm(targs[0], tw, eps=1e-5) if rms
         else fused_layer_norm(targs[0], tw, tb, eps=1e-5))
    tgrads = torch.autograd.grad(
        y, targs, torch.from_numpy(dy.astype(np.float32)).to(tdt))
    _check(y, jy)
    assert len(tgrads) == len(jgrads)
    for got, ref in zip(tgrads, jgrads):
        _check(got, ref)


@pytest.mark.parametrize("h", FWD_WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_forward_with_statistics_matches_jax(rms, dtype, h):
    """``y``, mean and rstd of the plain forward against the JAX forward
    kernel in interpret mode (fp32 weight and bias), and ``y`` against
    the XLA composition."""
    rng = np.random.default_rng(h + 3 * rms)
    jdt, tdt = DTYPES[dtype]
    x = np.array(jnp.asarray(
        (1.5 + rng.normal(size=(6, h))).astype(np.float32), jdt))
    w = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    b = None if rms else (0.1 * rng.normal(size=h)).astype(np.float32)
    jy, jmu, jrs = jax_ln_fwd(
        jnp.asarray(x), jnp.asarray(w).reshape(1, h),
        None if b is None else jnp.asarray(b).reshape(1, h), 1e-5, rms, True)
    y, mu, rs = L.layer_norm_stats_reference(
        torch.from_numpy(x.astype(np.float32)).to(tdt), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5, rms)
    _check(y, jy)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs)[:, 0],
                               rtol=1e-5, atol=1e-6)
    xla = (jax_rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                        implementation="xla") if rms else
           jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          eps=1e-5, implementation="xla"))
    _check(y, xla)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h", WIDTHS + (100, 10000))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_backward_kernel_matches_plain_and_reruns_bitwise_on_card(
        rms, dtype, h, cuda_device):
    """The dx kernel against its plain version from the same statistics
    (fp32 within 1e-4, bf16 within 2^-7 of the largest |dx|, the
    tolerances of ``chip_smoke.py``), and a rerun bit for bit; h = 100
    (bf16 rows not a whole number of 16-byte vectors) and 10000 (past the
    register-resident limit) take the two-sweep kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(h)
    x = (1 + torch.randn(300, h, generator=g, device=cuda_device)).to(dtype)
    w = 1 + 0.1 * torch.randn(h, generator=g, device=cuda_device)
    dy = torch.randn(300, h, generator=g, device=cuda_device).to(dtype)
    _, mu, rs = L.layer_norm_stats_reference(x, w, None, 1e-5, rms)
    for weight in (w, None):
        dx = L.layer_norm_bwd_dx_kernel(dy, x, weight, mu, rs, rms)
        ref = L.layer_norm_bwd_dx_reference(dy, x, weight, mu, rs, rms)
        if dtype == torch.float32:
            torch.testing.assert_close(dx, ref, rtol=1e-4, atol=1e-4)
        else:
            err = (dx.float() - ref.float()).abs().max()
            assert err <= 2 ** -7 * ref.float().abs().max()
        assert torch.equal(
            dx, L.layer_norm_bwd_dx_kernel(dy, x, weight, mu, rs, rms))


@pytest.mark.cuda
@pytest.mark.parametrize("h", FWD_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_forward_kernel_matches_plain_and_reruns_bitwise_on_card(
        rms, dtype, h, cuda_device):
    """The forward kernel with statistics against its plain version (y
    fp32 within rtol 1e-5 / atol 1e-5, bf16 within one bf16 ulp plus
    2^-16 of the largest |y|; mean and rstd within 1e-5: the tolerances
    of ``chip_smoke.py``), with and without affine parameters, and a
    rerun bit for bit; h = 100 and 10000 take the one-block-a-row
    kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(h)
    x = (1 + torch.randn(300, h, generator=g, device=cuda_device)).to(dtype)
    w = 1 + 0.1 * torch.randn(h, generator=g, device=cuda_device)
    b = None if rms else 0.1 * torch.randn(h, generator=g,
                                           device=cuda_device)
    for weight, bias in ((w, b), (None, None)):
        got = L.layer_norm_fwd_kernel(x, weight, bias, 1e-5, rms, True)
        y, mu, rs = L.layer_norm_stats_reference(x, weight, bias, 1e-5, rms)
        if dtype == torch.float32:
            torch.testing.assert_close(got[0], y, rtol=1e-5, atol=1e-5)
        else:
            ref = y.float().abs()
            ulp = torch.exp2(torch.floor(torch.log2(ref.clamp(
                min=1e-30))) - 7)
            assert bool(((got[0].float() - y.float()).abs() <= ulp
                         + 2 ** -16 * ref.max()).all())
        assert float((got[1] - mu).abs().max()) <= 1e-5
        assert float(((got[2] - rs) / rs).abs().max()) <= 1e-5
        again = L.layer_norm_fwd_kernel(x, weight, bias, 1e-5, rms, True)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
