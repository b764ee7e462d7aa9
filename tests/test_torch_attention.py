"""The port's attention (``apex_tpu_torch.ops.attention``) held against
the JAX package's.

Inputs are made with numpy from fixed seeds.  ``attention_reference``
is held against the JAX composition, forward and gradients, over the
bias, mask, window, GQA and dropout cases; ``fused_attention`` (the
plain versions of the three kernels behind its autograd function, the
CPU path) against the JAX ``fused_attention`` with its Pallas kernels in
interpret mode.  Tolerances: fp32 within 1e-5 (sums in another order);
the dropout keep-mask exactly equal.  Tests marked ``cuda`` hold the
CUDA kernels against their plain versions on a GPU and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as JA
from apex_tpu_torch.ops import attention as A

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _inputs(seed, b, sq, sk, h, hk, d, bias_shape=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    bias = None
    if bias_shape is not None:
        bias = np.where(rng.random(bias_shape) < 0.25, -1e30,
                        rng.normal(size=bias_shape)).astype(np.float32)
    return q, k, v, do, bias


def _jax_value_and_grads(fn, q, k, v, do):
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda a, b, c: (fn(a, b, c) * jnp.asarray(do)).sum(),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    return out, grads


def _port_value_and_grads(fn, q, k, v, do):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fn(tq, tk, tv)
    (out * _t(do)).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


def _assert_same(port, ref):
    out, grads = port
    jout, jgrads = ref
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


# (b, sq, sk, h, hk, d, bias shape, causal, window, dropout rate)
REFERENCE_CASES = {
    "plain": (2, 24, 24, 4, 4, 16, None, False, None, 0.0),
    "key_padding": (2, 24, 24, 4, 4, 16, (2, 1, 1, 24), False, None, 0.0),
    "per_head": (2, 24, 24, 4, 4, 16, (1, 4, 1, 24), False, None, 0.0),
    "per_query": (2, 24, 24, 4, 4, 16, (2, 1, 24, 24), False, None, 0.0),
    "causal_sq_lt_sk": (1, 16, 40, 4, 4, 16, None, True, None, 0.0),
    "causal_sq_gt_sk": (1, 40, 16, 4, 4, 16, None, True, None, 0.0),
    "window": (1, 48, 48, 4, 4, 16, None, True, 7, 0.0),
    "gqa": (2, 24, 24, 8, 2, 16, None, True, None, 0.0),
    "dropout": (2, 24, 24, 4, 4, 16, (2, 1, 1, 24), False, None, 0.2),
}


class TestReference:
    @pytest.mark.parametrize("case", list(REFERENCE_CASES))
    def test_reference_matches_jax(self, case):
        b, sq, sk, h, hk, d, bs, causal, window, rate = REFERENCE_CASES[case]
        q, k, v, do, bias = _inputs(1, b, sq, sk, h, hk, d, bs)
        kw = dict(causal=causal, window=window, dropout_rate=rate,
                  dropout_seed=-77 if rate else None)
        ref = _jax_value_and_grads(
            lambda a, bb, c: JA.attention_reference(
                a, bb, c, bias=None if bias is None else jnp.asarray(bias),
                **kw), q, k, v, do)
        port = _port_value_and_grads(
            lambda a, bb, c: A.attention_reference(
                a, bb, c, bias=None if bias is None else _t(bias), **kw),
            q, k, v, do)
        _assert_same(port, ref)

    @pytest.mark.parametrize("case", list(REFERENCE_CASES))
    def test_kernel_twins_match_the_reference(self, case):
        """The plain versions of the three kernels (fused_attention's CPU
        path) against the differentiable composition."""
        b, sq, sk, h, hk, d, bs, causal, window, rate = REFERENCE_CASES[case]
        q, k, v, do, bias = _inputs(2, b, sq, sk, h, hk, d, bs)
        kw = dict(causal=causal, window=window, dropout_rate=rate,
                  dropout_seed=5 if rate else None,
                  bias=None if bias is None else _t(bias))
        ref = _port_value_and_grads(
            lambda a, bb, c: A.attention_reference(a, bb, c, **kw),
            q, k, v, do)
        port = _port_value_and_grads(
            lambda a, bb, c: A.fused_attention(a, bb, c, **kw), q, k, v, do)
        _assert_same(port, (ref[0].detach().numpy(),
                            [g.numpy() for g in ref[1]]))
        for g in port[1]:
            assert torch.isfinite(g).all()


class TestFusedAttentionAgainstPallas:
    @pytest.mark.parametrize("case", [
        (2, 128, 128, 2, 2, 32, (2, 1, 1, 128), False),
        (1, 128, 128, 4, 2, 32, None, True),
    ], ids=["key_padding", "causal_gqa"])
    def test_forward_and_grads_match_pallas_interpret(self, case):
        b, sq, sk, h, hk, d, bs, causal = case
        q, k, v, do, bias = _inputs(3, b, sq, sk, h, hk, d, bs)
        ref = _jax_value_and_grads(
            lambda a, bb, c: JA.fused_attention(
                a, bb, c, causal=causal,
                bias=None if bias is None else jnp.asarray(bias),
                implementation="pallas_interpret"), q, k, v, do)
        port = _port_value_and_grads(
            lambda a, bb, c: A.fused_attention(
                a, bb, c, causal=causal,
                bias=None if bias is None else _t(bias)), q, k, v, do)
        _assert_same(port, ref)


class TestDropoutMask:
    @pytest.mark.parametrize("seed", [0, 1, -12345, 2 ** 31 - 1])
    def test_keep_mask_equals_jax(self, seed):
        ref = JA.dropout_keep_mask(jnp.asarray(seed, jnp.int32), 2, 3, 33,
                                   65, 0.3)
        got = A.dropout_keep_mask(seed, 2, 3, 33, 65, 0.3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_rate_is_the_drop_share(self):
        keep = A.dropout_keep_mask(9, 4, 4, 128, 128, 0.1)
        assert abs(1 - keep.float().mean().item() - 0.1) < 0.01


class TestValidation:
    def test_dropout_needs_a_seed(self):
        x = torch.zeros(1, 8, 2, 8)
        with pytest.raises(ValueError, match="dropout_seed"):
            A.fused_attention(x, x, x, dropout_rate=0.1)

    def test_window_needs_causal(self):
        x = torch.zeros(1, 8, 2, 8)
        with pytest.raises(ValueError, match="causal"):
            A.fused_attention(x, x, x, window=4)

    def test_tile_is_fixed(self):
        x = torch.zeros(1, 8, 2, 8)
        with pytest.raises(ValueError, match="64"):
            A.fused_attention(x, x, x, block_q=128)

    def test_kernel_on_cpu_tensor_raises(self):
        x = torch.zeros(1, 8, 2, 8)
        with pytest.raises(ValueError, match="CUDA tensor"):
            A.fused_attention(x, x, x, implementation="kernel")

    def test_learned_bias_gets_its_gradient(self):
        q, k, v, do, bias = _inputs(4, 1, 8, 8, 2, 2, 8, (1, 2, 8, 8))
        tb = _t(np.where(bias < -1e29, 0.0, bias).astype(np.float32), True)
        out = A.fused_attention(_t(q), _t(k), _t(v), bias=tb,
                                bias_requires_grad=True)
        (out * _t(do)).sum().backward()
        assert tb.grad is not None and float(tb.grad.abs().max()) > 0

    def test_mask_to_bias_matches_jax(self):
        m = np.random.default_rng(0).random((2, 1, 1, 9)) < 0.5
        np.testing.assert_array_equal(
            A.mask_to_bias(torch.from_numpy(m)).numpy(),
            np.asarray(JA.mask_to_bias(jnp.asarray(m))))


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_close(got, ref, dtype):
    """fp32: within 1e-5 (sums in another order); bf16: within 2^-7 of
    the largest entry (outputs round to 8 bits)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, **TOL)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -7 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_kernels_match_plain_on_card(case, dtype, cuda_device):
    """fp32 runs the FMA kernels; bf16 with head_dim 64 (the BERT case
    below) or 128 runs the tensor-core ones."""
    b, sq, sk, h, hk, d, bs, causal, window, rate = REFERENCE_CASES[case]
    d = 64 if dtype == torch.bfloat16 else d
    q, k, v, do, bias = (None if a is None else _t(a).to(cuda_device)
                         for a in _inputs(5, b, sq, sk, h, hk, d, bs))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (bias, d ** -0.5, causal, window, rate, 11)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
    delta = A.attention_delta(do, o2)
    bw = (q, k, v, bias, do, lse2, delta) + args[1:]
    _card_close(o, o2, dtype)
    _card_close(A.flash_bwd_dq_kernel(*bw), A.flash_bwd_dq_reference(*bw),
                dtype)
    for got, ref in zip(A.flash_bwd_dkv_kernel(*bw),
                        A.flash_bwd_dkv_reference(*bw)):
        _card_close(got, ref, dtype)
