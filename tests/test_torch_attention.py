"""The port's attention (``apex_tpu_torch.ops.attention``) held against
the JAX package's.

Inputs are made with numpy from fixed seeds.  ``attention_reference``
is held against the JAX composition, forward and gradients, over the
bias, mask, window, GQA and dropout cases; ``fused_attention`` (the
plain versions of the three kernels behind its autograd function, the
CPU path) against the JAX ``fused_attention`` with its Pallas kernels in
interpret mode.  Tolerances: fp32 within 1e-5 (sums in another order);
the dropout keep-mask exactly equal.  ``TestEnvelope`` holds
``flash_kernel_ok`` (ROADMAP C-8) against the JAX ``fused_attention``'s
own ``pallas_ok`` (its call of ``resolve_impl`` intercepted) at head dims
36-264, GQA groups 1-16, batch x heads across 65535 and mixed dtypes,
the route's log line, and the CPU path at head dims 36-264 against the
JAX composition.  Tests marked ``cuda`` hold the CUDA kernels against
their plain versions on a GPU and skip without one (among them head dim
256 and 70400 batch x heads).
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


# shapes that cross the card kernels' 128-wide tiles: ragged tails, the
# causal sk - sq offset crossing a tile, GQA with a window and dropout
TILE_EDGE_CASES = {
    "ragged_key_padding": (2, 130, 257, 4, 4, 16, (2, 1, 1, 257), False,
                           None, 0.0),
    "causal_192x320": (2, 192, 320, 4, 4, 16, None, True, None, 0.0),
    "gqa_window_dropout": (1, 200, 200, 8, 2, 16, None, True, 50, 0.1),
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


class TestTileEdges:
    @pytest.mark.parametrize("case", list(TILE_EDGE_CASES))
    def test_fused_attention_matches_jax(self, case):
        """``fused_attention`` (the plain versions of the kernels, the CPU
        path) against the JAX composition — what the JAX
        ``fused_attention`` runs at shapes its Pallas tiles do not
        divide — forward and gradients."""
        b, sq, sk, h, hk, d, bs, causal, window, rate = TILE_EDGE_CASES[case]
        q, k, v, do, bias = _inputs(6, b, sq, sk, h, hk, d, bs)
        kw = dict(causal=causal, window=window, dropout_rate=rate,
                  dropout_seed=321 if rate else None)
        ref = _jax_value_and_grads(
            lambda a, bb, c: JA.attention_reference(
                a, bb, c, bias=None if bias is None else jnp.asarray(bias),
                **kw), q, k, v, do)
        port = _port_value_and_grads(
            lambda a, bb, c: A.fused_attention(
                a, bb, c, bias=None if bias is None else _t(bias), **kw),
            q, k, v, do)
        _assert_same(port, ref)
        for g in port[1]:
            assert torch.isfinite(g).all()


class TestFusedAttentionAgainstPallas:
    @pytest.mark.parametrize("case", [
        (2, 128, 128, 2, 2, 32, (2, 1, 1, 128), False),
        (1, 128, 128, 4, 2, 32, None, True),
        # head dim 80 (ViT-Huge's), at a length no 128-row tile divides
        (2, 72, 72, 2, 2, 80, (2, 1, 1, 72), False),
        (1, 72, 72, 4, 2, 80, None, True),
    ], ids=["key_padding", "causal_gqa", "key_padding_d80",
            "causal_gqa_d80"])
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
        # block_q / block_k are tile hints, as in the JAX package: any
        # positive value is taken, the kernels' tiles stay as they are,
        # the output is the same; a non-positive hint raises
        q, k, v, _, _ = _inputs(11, 2, 40, 72, 2, 2, 16, None)
        ref = A.fused_attention(_t(q), _t(k), _t(v), causal=True)
        for bq, bk in ((128, None), (512, 512), (1, 7)):
            got = A.fused_attention(_t(q), _t(k), _t(v), causal=True,
                                    block_q=bq, block_k=bk)
            assert torch.equal(got, ref)
        x = torch.zeros(1, 8, 2, 8)
        with pytest.raises(ValueError, match="positive"):
            A.fused_attention(x, x, x, block_q=0)

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


# the Hopper kernels' tile edges, as chip_smoke.py's edge checks:
# (b, sq, sk, h, hk, d, bias shape, causal, window, dropout rate)
CARD_EDGE_CASES = {
    "causal_192x320": (2, 192, 320, 4, 4, 64, None, True, None, 0.0),
    "ragged_257_key_padding": (2, 257, 257, 4, 4, 64, (2, 1, 1, 257),
                               False, None, 0.0),
    "ragged_257_d128": (2, 257, 257, 2, 2, 128, (2, 1, 1, 257), False,
                        None, 0.0),
    "gqa_8_2_window_dropout": (2, 200, 200, 8, 2, 128, None, True, 50, 0.1),
    "per_query_bias_dropout": (2, 130, 200, 4, 4, 64, (2, 4, 130, 200),
                               False, None, 0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", list(CARD_EDGE_CASES))
def test_hopper_kernels_at_tile_edges_on_card(case, dtype, cuda_device):
    """The wgmma/TMA forward, dq and dk/dv against their plain versions
    where tiles are ragged; dead rows keep the -1e30 logsumexp."""
    b, sq, sk, h, hk, d, bs, causal, window, rate = CARD_EDGE_CASES[case]
    q, k, v, do, bias = (None if a is None else _t(a).to(cuda_device)
                         for a in _inputs(7, b, sq, sk, h, hk, d, bs))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (bias, d ** -0.5, causal, window, rate, 99)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
    live = lse2 > -1e29
    _card_close(o, o2, torch.bfloat16)
    torch.testing.assert_close(lse[live], lse2[live], rtol=1e-5, atol=1e-5)
    assert bool((lse[~live] < -1e29).all())
    delta = A.attention_delta(do, o2)
    bw = (q, k, v, bias, do, lse2, delta) + args[1:]
    _card_close(A.flash_bwd_dq_kernel(*bw), A.flash_bwd_dq_reference(*bw),
                torch.bfloat16)
    # the kernel sums a GQA group in fp32 registers, the plain version
    # per head and then over the group: an fp32 order difference
    for got, ref in zip(A.flash_bwd_dkv_kernel(*bw),
                        A.flash_bwd_dkv_reference(*bw)):
        assert torch.isfinite(got).all()
        _card_close(got, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_d80_backward_takes_wgmma_and_reruns_bitwise_on_card(dtype,
                                                             cuda_device):
    """At ViT-Huge's shape (32, 257, 16 heads, d 80) dq and dk/dv run
    the wgmma kernels (the forward and fp32 the FMA ones), agree with
    their plain versions and give the same bits on a rerun."""
    assert [A.flash_route(k, dtype, 80) for k in ("fwd", "dq", "dkv")] \
        == ["fma", "wgmma", "wgmma"]
    assert A.flash_route("dq", torch.float32, 80) == "fma"
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(32, 257, 16, 80, generator=g,
                               device=cuda_device).to(dtype)
                   for _ in range(4))
    args = (None, 80 ** -0.5, False, None, 0.0, 0)
    o, lse = A.flash_fwd_reference(q, k, v, *args)
    bw = (q, k, v, None, do, lse, A.attention_delta(do, o)) + args[1:]
    dq = A.flash_bwd_dq_kernel(*bw)
    dk, dv = A.flash_bwd_dkv_kernel(*bw)
    _card_close(dq, A.flash_bwd_dq_reference(*bw), torch.bfloat16)
    for got, ref in zip((dk, dv), A.flash_bwd_dkv_reference(*bw)):
        _card_close(got, ref, torch.bfloat16)
    dq2 = A.flash_bwd_dq_kernel(*bw)
    dk2, dv2 = A.flash_bwd_dkv_kernel(*bw)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hopper_kernels_rerun_bitwise_on_card(cuda_device):
    """At the BERT-Large shape in bf16 the forward, dq and dk/dv give
    the same bits on a rerun (no atomics, sums in a fixed order)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(16, 512, 16, 64, generator=g,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    args = (None, 0.125, False, None, 0.0, 0)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    bw = (q, k, v, None, do, lse, A.attention_delta(do, o)) + args[1:]
    dq = A.flash_bwd_dq_kernel(*bw)
    dk, dv = A.flash_bwd_dkv_kernel(*bw)
    o2, lse2 = A.flash_fwd_kernel(q, k, v, *args)
    dq2 = A.flash_bwd_dq_kernel(*bw)
    dk2, dv2 = A.flash_bwd_dkv_kernel(*bw)
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# the kernels' envelope (ROADMAP C-8) and the widened shapes
# ------------------------------------------------------------------ #
ENVELOPE_DIMS = [36, 64, 80, 96, 128, 256, 264]


class _Stop(Exception):
    pass


def _reference_pallas_ok(monkeypatch, q, k, v, **kw):
    """The JAX ``fused_attention``'s ``pallas_ok`` for these inputs: its
    call of ``resolve_impl`` is intercepted, and the call ends there."""
    seen = {}

    def spy(implementation, *, pallas_ok=True, auto_default="pallas"):
        seen["ok"] = pallas_ok
        raise _Stop

    monkeypatch.setattr(JA, "resolve_impl", spy)
    with pytest.raises(_Stop):
        JA.fused_attention(q, k, v, **kw)
    return seen["ok"]


class TestEnvelope:
    """``flash_kernel_ok`` routes as the JAX package's ``pallas_ok`` for
    head dims up to 256 (above it the port routes to its plain versions
    and says so), any GQA group and any batch x heads: the kernels take
    ragged sequences, so the JAX tile conditions do not enter."""

    @pytest.mark.parametrize("group", [1, 4, 8, 16])
    @pytest.mark.parametrize("d", ENVELOPE_DIMS)
    def test_predicate_routes_as_reference(self, monkeypatch, d, group):
        q = jnp.zeros((1, 8, 2 * group, d), jnp.bfloat16)
        k = jnp.zeros((1, 8, 2, d), jnp.bfloat16)
        ref = _reference_pallas_ok(monkeypatch, q, k, k, causal=True)
        got = A.flash_kernel_ok(d)
        assert ref == (d % 8 == 0)
        assert got == (ref and d <= A.MAX_HEAD_DIM)

    @pytest.mark.parametrize("b,h", [(4095, 16), (4096, 16), (1100, 64)])
    def test_batch_heads_across_65535(self, monkeypatch, b, h):
        q = jnp.zeros((b, 1, h, 64), jnp.bfloat16)
        ref = _reference_pallas_ok(monkeypatch, q, q, q)
        assert ref and A.flash_kernel_ok(64)

    def test_mixed_dtypes_route_as_reference(self, monkeypatch):
        q = jnp.zeros((1, 8, 2, 64), jnp.bfloat16)
        k = jnp.zeros((1, 8, 2, 64), jnp.float32)
        assert not _reference_pallas_ok(monkeypatch, q, k, k)
        assert not A.flash_kernel_ok(64, same_dtype=False)

    def test_route_logs_once_and_an_explicit_kernel_raises(self, caplog):
        import types

        from apex_tpu_torch.ops._dispatch import resolve_impl

        q = types.SimpleNamespace(is_cuda=True, device="cuda:0")
        kw = dict(inside=A.flash_kernel_ok(264), op="fused_attention",
                  shape=((2, 8, 4, 264),), why="head_dim 264")
        with caplog.at_level("INFO", logger="apex_tpu_torch.ops"):
            assert resolve_impl(None, q, **kw) == "torch"
            assert resolve_impl("auto", q, **kw) == "torch"
        lines = [r.getMessage() for r in caplog.records]
        assert len(lines) == 1 and lines[0].startswith(
            "fused_attention: falling back to the plain composition")
        with pytest.raises(ValueError, match="no kernel takes"):
            resolve_impl("kernel", q, **kw)
        assert resolve_impl(None, q, inside=True) == "kernel"

    @pytest.mark.parametrize("d", [36, 80, 96, 256, 264])
    def test_wide_and_odd_heads_match_jax(self, d):
        """The CPU path (the plain kernels' twins) at the new head dims,
        forward and gradients, against the JAX composition."""
        q, k, v, do, _ = _inputs(21, 1, 24, 40, 4, 2, d)

        def jfn(a, b, c):
            return JA.fused_attention(a, b, c, causal=True,
                                      implementation="xla")

        def tfn(a, b, c):
            return A.fused_attention(a, b, c, causal=True)
        _assert_same(_port_value_and_grads(tfn, q, k, v, do),
                     _jax_value_and_grads(jfn, q, k, v, do))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    (2, 130, 200, 4, 2, 256, None, True, None, 0.0),
    (2, 96, 160, 4, 4, 256, (2, 1, 1, 160), False, None, 0.1),
    (2, 72, 136, 4, 4, 96, None, True, 40, 0.0),
    (1100, 3, 5, 64, 64, 64, None, False, None, 0.0),
    (1100, 3, 5, 64, 16, 128, None, True, None, 0.1),
    (2, 257, 257, 4, 4, 80, None, False, None, 0.0),
    (2, 257, 257, 4, 4, 80, (2, 1, 1, 257), False, None, 0.1),
    (2, 200, 200, 8, 2, 80, None, True, 50, 0.0),
    (1100, 3, 5, 64, 64, 80, None, False, None, 0.0)],
    ids=["d256-causal-gqa", "d256-pad-drop", "d96-window",
         "bh70400-d64", "bh70400-d128-gqa-drop", "d80-vit",
         "d80-pad-drop", "d80-causal-gqa-window", "bh70400-d80"])
def test_widened_kernels_match_plain_on_card(case, dtype, cuda_device):
    """Head dim 256 (the FMA kernels' 32-row tiles), 96, 80 (the wgmma
    backward's 16-column panels in half types), and 70400 batch x heads
    (grid.x numbering; the wgmma kernels' items) against the plain
    versions."""
    b, sq, sk, h, hk, d, bs, causal, window, rate = case
    q, k, v, do, bias = (None if a is None else _t(a).to(cuda_device)
                         for a in _inputs(9, b, sq, sk, h, hk, d, bs))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (bias, d ** -0.5, causal, window, rate, 5)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
    live = lse2 > -1e29
    ref_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    _card_close(o, o2, ref_dtype)
    torch.testing.assert_close(lse[live], lse2[live], rtol=1e-5, atol=1e-5)
    delta = A.attention_delta(do, o2)
    bw = (q, k, v, bias, do, lse2, delta) + args[1:]
    _card_close(A.flash_bwd_dq_kernel(*bw), A.flash_bwd_dq_reference(*bw),
                ref_dtype)
    for got, ref in zip(A.flash_bwd_dkv_kernel(*bw),
                        A.flash_bwd_dkv_reference(*bw)):
        _card_close(got, ref, ref_dtype)
