"""The port's training-side ops held against the JAX package's.

LayerNorm / RMSNorm forward statistics and gradients (dx, dγ, dβ)
against ``jax.grad`` of the JAX ``fused_layer_norm`` with its Pallas
forward and backward kernels in interpret mode; the RoPE gradient
against ``jax.grad`` of the JAX ``fused_rope`` in interpret mode; the
memory-saving cross-entropy with label smoothing and ``ignore_index``.
Inputs come from numpy with fixed seeds.  Tolerance: fp32 within 1e-5
(sums in another order).  Tests marked ``cuda`` hold the kernels
against their plain versions on a GPU and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.layer_norm import fused_layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import fused_rms_norm as jax_rms_norm
from apex_tpu.ops.rope import fused_rope as jax_rope
from apex_tpu.ops.rope import rope_cos_sin as jax_cos_sin
from apex_tpu.ops.xentropy import mean_cross_entropy as jax_mean_xent
from apex_tpu.ops.xentropy import softmax_cross_entropy as jax_xent
from apex_tpu_torch.ops import layer_norm as L
from apex_tpu_torch.ops import (
    fused_layer_norm,
    fused_rms_norm,
    fused_rope,
    mean_cross_entropy,
    softmax_cross_entropy,
    softmax_cross_entropy_reference,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(kw or TOL))


class TestNormGradients:
    @pytest.mark.parametrize("rms", [False, True])
    @pytest.mark.parametrize("shape", [(6, 256), (2, 3, 128)])
    def test_forward_and_grads_match_pallas_interpret(self, rms, shape):
        rng = np.random.default_rng(1)
        x = (2 + rng.normal(size=shape)).astype(np.float32)
        w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        b = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        dy = rng.normal(size=shape).astype(np.float32)

        def jfn(x_, w_, b_):
            if rms:
                return jax_rms_norm(x_, w_, eps=1e-5,
                                    implementation="pallas_interpret")
            return jax_layer_norm(x_, w_, b_, eps=1e-5,
                                  implementation="pallas_interpret")
        args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        jy = jfn(*args)
        jg = jax.grad(lambda *a: (jfn(*a) * jnp.asarray(dy)).sum(),
                      argnums=(0, 1, 2))(*args)
        tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
        y = (fused_rms_norm(tx, tw, eps=1e-5) if rms
             else fused_layer_norm(tx, tw, tb, eps=1e-5))
        (y * _t(dy)).sum().backward()
        _close(y, jy)
        _close(tx.grad, jg[0])
        _close(tw.grad, jg[1])
        if not rms:
            _close(tb.grad, jg[2])

    @pytest.mark.parametrize("rms", [False, True])
    def test_statistics_match_the_fp32_definition(self, rms):
        rng = np.random.default_rng(2)
        x = (3 + rng.normal(size=(5, 384))).astype(np.float64)
        _, mu, rs = L.layer_norm_stats_reference(
            _t(x.astype(np.float32)), rms=rms)
        want_mu = np.zeros(5) if rms else x.mean(-1)
        var = ((x - want_mu[:, None]) ** 2).mean(-1)
        np.testing.assert_allclose(mu.numpy(), want_mu, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rs.numpy(), 1 / np.sqrt(var + 1e-5),
                                   rtol=1e-5)

    def test_half_activations_with_fp32_weights(self):
        """amp O2: bf16 x, fp32 norm weights; dx in bf16, dw/db fp32."""
        rng = np.random.default_rng(3)
        x = _t(rng.normal(size=(4, 128)).astype(np.float32)).to(
            torch.bfloat16).requires_grad_()
        w = _t((1 + 0.1 * rng.normal(size=128)).astype(np.float32), True)
        b = _t(np.zeros(128, np.float32), True)
        y = fused_layer_norm(x, w, b)
        y.float().sum().backward()
        assert y.dtype == x.grad.dtype == torch.bfloat16
        assert w.grad.dtype == b.grad.dtype == torch.float32

    def test_no_grad_takes_the_statsless_path(self):
        x = torch.randn(3, 64)
        with torch.no_grad():
            y = fused_layer_norm(x, torch.ones(64), torch.zeros(64))
        assert y.grad_fn is None
        torch.testing.assert_close(
            y, torch.nn.functional.layer_norm(x, (64,)), **TOL)


class TestRopeGradient:
    def test_grad_matches_pallas_interpret(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(2, 8, 2, 256)).astype(np.float32)
        dy = rng.normal(size=x.shape).astype(np.float32)
        jc, js = jax_cos_sin(8, 256)
        ref = jax.grad(lambda a: (jax_rope(
            a, jc, js, implementation="pallas_interpret")
            * jnp.asarray(dy)).sum())(jnp.asarray(x))
        tx = _t(x, True)
        (fused_rope(tx, _t(jc), _t(js)) * _t(dy)).sum().backward()
        _close(tx.grad, ref)

    def test_partial_rotary_grad_passes_the_tail_through(self):
        rng = np.random.default_rng(5)
        x = _t(rng.normal(size=(1, 4, 2, 64)).astype(np.float32), True)
        c, s = (_t(a) for a in jax_cos_sin(4, 32))
        dy = torch.randn(x.shape)
        (fused_rope(x, c, s) * dy).sum().backward()
        torch.testing.assert_close(x.grad[..., 32:], dy[..., 32:])


class TestCrossEntropy:
    @pytest.mark.parametrize("smoothing", [0.0, 0.1])
    @pytest.mark.parametrize("ignore_index", [None, 3])
    def test_loss_and_grad_match_jax(self, smoothing, ignore_index):
        rng = np.random.default_rng(6)
        logits = (3 * rng.normal(size=(12, 50))).astype(np.float32)
        labels = rng.integers(0, 50, size=12).astype(np.int32)
        labels[[2, 7]] = 3
        g = rng.normal(size=12).astype(np.float32)
        jl = jax_xent(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                      ignore_index)
        jg = jax.grad(lambda a: (jax_xent(a, jnp.asarray(labels), smoothing,
                                          ignore_index)
                                 * jnp.asarray(g)).sum())(
            jnp.asarray(logits))
        tl = _t(logits, True)
        loss = softmax_cross_entropy(tl, _t(labels).long(), smoothing,
                                     ignore_index)
        (loss * _t(g)).sum().backward()
        _close(loss, jl)
        _close(tl.grad, jg)
        _close(softmax_cross_entropy_reference(
            _t(logits), _t(labels).long(), smoothing=smoothing,
            ignore_index=ignore_index), jl)

    def test_mean_over_valid_tokens_matches_jax(self):
        rng = np.random.default_rng(7)
        logits = rng.normal(size=(2, 5, 40)).astype(np.float32)
        labels = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
        labels[0, :3] = -100
        ref = jax_mean_xent(jnp.asarray(logits), jnp.asarray(labels))
        jg = jax.grad(lambda a: jax_mean_xent(a, jnp.asarray(labels)))(
            jnp.asarray(logits))
        tl = _t(logits, True)
        loss = mean_cross_entropy(tl, _t(labels).long())
        loss.backward()
        _close(loss, ref)
        _close(tl.grad, jg)

    def test_half_logits_give_fp32_loss_and_half_grads(self):
        logits = torch.randn(4, 30).to(torch.bfloat16).requires_grad_()
        loss = softmax_cross_entropy(logits, torch.tensor([1, 2, 3, 4]))
        loss.sum().backward()
        assert loss.dtype == torch.float32
        assert logits.grad.dtype == torch.bfloat16


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rms", [False, True])
def test_norm_kernels_match_plain_on_card(rms, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(256, 1024, generator=g, device=cuda_device)
    w = torch.randn(1024, generator=g, device=cuda_device)
    b = None if rms else torch.randn(1024, generator=g, device=cuda_device)
    dy = torch.randn(256, 1024, generator=g, device=cuda_device)
    y, mu, rs = L.layer_norm_fwd_kernel(x, w, b, 1e-5, rms, True)
    y2, mu2, rs2 = L.layer_norm_stats_reference(x, w, b, 1e-5, rms)
    torch.testing.assert_close(y, y2, **TOL)
    torch.testing.assert_close(rs, rs2, **TOL)
    torch.testing.assert_close(
        L.layer_norm_bwd_dx_kernel(dy, x, w, mu, rs, rms),
        L.layer_norm_bwd_dx_reference(dy, x, w, mu2, rs2, rms),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_rope_backward_kernel_matches_plain_on_card(cuda_device):
    x = torch.randn(2, 16, 4, 128, device=cuda_device, requires_grad=True)
    c = torch.rand(16, 48, device=cuda_device)
    s = torch.rand(16, 48, device=cuda_device)
    dy = torch.randn(x.shape, device=cuda_device)
    got = torch.autograd.grad(fused_rope(x, c, s), x, dy)[0]
    ref = torch.autograd.grad(fused_rope(x, c, s, implementation="torch"),
                              x, dy)[0]
    torch.testing.assert_close(got, ref, **TOL)
