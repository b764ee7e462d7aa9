"""RoPE on q and k read from the packed qkv projection (``_rope_qk``),
held against the JAX package's ``fused_rope``.

The model rotates q and k with one call that reads them through their
strides from ``qkv_proj``'s output, in both layouts of
``ParallelAttention._qkv``: the grouped one, where q is the ``(b, s, kv
heads, rep, d)`` view, and the flat one.  Inputs are made with numpy from
fixed seeds; the JAX side runs its Pallas kernel in interpret mode or its
XLA composition, as ``tests/test_torch_ops.py`` runs it, on the CPU where
the port runs its plain version.  The JAX function takes shared tables
only, so per-row tables are held against it row by row.  Tolerances:
rtol 1e-5, atol 1e-6 (fp32 in both); the port against its own
``fused_rope`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.rope import fused_rope as jax_rope
from apex_tpu.ops.rope import rope_cos_sin as jax_cos_sin
from apex_tpu_torch.models.transformer import (
    ParallelAttention,
    TransformerConfig,
)
from apex_tpu_torch.ops.rope import _rope_qk, fused_rope

JAX_IMPLS = ("pallas_interpret", "xla")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def _views(qkv, h, hk, d, grouped):
    """q and k of a packed ``(b, s, (h + 2 hk) d)`` projection, as
    ``ParallelAttention._qkv`` views them before RoPE; and the same
    q and k as numpy ``(b, s, heads, d)`` arrays."""
    b, s, _ = qkv.shape
    arr = qkv.detach().numpy()
    if grouped:
        rep = h // hk
        gv = qkv.view(b, s, hk, rep + 2, d)
        ga = arr.reshape(b, s, hk, rep + 2, d)
        return (gv[..., :rep, :], gv[..., rep, :],
                ga[..., :rep, :].reshape(b, s, h, d), ga[..., rep, :])
    return (qkv[..., :h * d].view(b, s, h, d),
            qkv[..., h * d:(h + hk) * d].view(b, s, hk, d),
            arr[..., :h * d].reshape(b, s, h, d),
            arr[..., h * d:(h + hk) * d].reshape(b, s, hk, d))


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("h,hk,d,rot", [(4, 4, 128, 128), (4, 2, 128, 64),
                                        (6, 2, 256, 256)])
def test_views_of_the_projection_match_jax(impl, grouped, h, hk, d, rot):
    rng = np.random.default_rng(11)
    b, s = 2, 8
    qkv = _t(rng.normal(size=(b, s, (h + 2 * hk) * d)).astype(np.float32))
    q, k, qa, ka = _views(qkv, h, hk, d, grouped)
    jc, js = jax_cos_sin(32, rot)
    jc, js = jc[3:3 + s], js[3:3 + s]
    yq, yk = _rope_qk(q, k, _t(jc), _t(js))
    assert yq.shape == (b, s, h, d) and yk.shape == (b, s, hk, d)
    _close(yq, jax_rope(jnp.asarray(qa), jc, js, implementation=impl))
    _close(yk, jax_rope(jnp.asarray(ka), jc, js, implementation=impl))


@pytest.mark.parametrize("grouped", [True, False])
def test_per_row_tables_match_jax_row_by_row(grouped):
    rng = np.random.default_rng(12)
    b, s, h, hk, d = 3, 4, 4, 2, 128
    qkv = _t(rng.normal(size=(b, s, (h + 2 * hk) * d)).astype(np.float32))
    q, k, qa, ka = _views(qkv, h, hk, d, grouped)
    start = np.array([0, 9, 40])
    jc, js = jax_cos_sin(64, d)
    pos = start[:, None] + np.arange(s)
    yq, yk = _rope_qk(q, k, _t(jc)[pos], _t(js)[pos])
    for i, p in enumerate(start):
        c, sn = jc[p:p + s], js[p:p + s]
        _close(yq[i], jax_rope(jnp.asarray(qa[i]), c, sn,
                               implementation="xla"))
        _close(yk[i], jax_rope(jnp.asarray(ka[i]), c, sn,
                               implementation="xla"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("per_row", [True, False])
def test_equals_two_fused_rope_calls(dtype, grouped, per_row):
    g = torch.Generator().manual_seed(13)
    b, s, h, hk, d = 2, 5, 8, 2, 64
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=g).to(dtype)
    q, k, _, _ = _views(qkv.float(), h, hk, d, grouped)
    q, k = (t.to(dtype) for t in (q, k))
    c, sn = (_t(a) for a in jax_cos_sin(64, 48))
    if per_row:
        pos = torch.tensor([[3], [30]]) + torch.arange(s)
        c, sn = c[pos], sn[pos]
    else:
        c, sn = c[:s], sn[:s]
    yq, yk = _rope_qk(q, k, c, sn)
    assert torch.equal(yq, fused_rope(q.reshape(b, s, h, d), c, sn))
    assert torch.equal(yk, fused_rope(k, c, sn))
    assert yq.dtype == yk.dtype == dtype


@pytest.mark.parametrize("grouped", [True, False])
def test_gradient_into_the_projection_matches_jax(grouped):
    rng = np.random.default_rng(14)
    b, s, h, hk, d = 2, 8, 4, 2, 128
    qkv_np = rng.normal(size=(b, s, (h + 2 * hk) * d)).astype(np.float32)
    dq = rng.normal(size=(b, s, h, d)).astype(np.float32)
    dk = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    jc, js = jax_cos_sin(8, d)

    def jax_loss(a):
        if grouped:
            ga = a.reshape(b, s, hk, h // hk + 2, d)
            qa = ga[..., :h // hk, :].reshape(b, s, h, d)
            ka = ga[..., h // hk, :]
        else:
            qa = a[..., :h * d].reshape(b, s, h, d)
            ka = a[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
        rq = jax_rope(qa, jc, js, implementation="pallas_interpret")
        rk = jax_rope(ka, jc, js, implementation="pallas_interpret")
        return (rq * dq).sum() + (rk * dk).sum()
    ref = jax.grad(jax_loss)(jnp.asarray(qkv_np))
    qkv = _t(qkv_np).requires_grad_()
    q, k, _, _ = _views(qkv, h, hk, d, grouped)
    yq, yk = _rope_qk(q, k, _t(jc), _t(js))
    ((yq * _t(dq)).sum() + (yk * _t(dk)).sum()).backward()
    _close(qkv.grad, ref)


def test_tables_that_do_not_match_raise():
    q = torch.zeros(2, 3, 4, 64)
    with pytest.raises(ValueError, match="do not match"):
        _rope_qk(q, q, torch.zeros(4, 32), torch.zeros(4, 32))
    with pytest.raises(ValueError, match="one \\(b, s, d\\)"):
        _rope_qk(q, torch.zeros(2, 3, 4, 32), torch.zeros(3, 16),
                 torch.zeros(3, 16))


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_attention_qkv_rotates_what_it_slices(grouped, heads):
    """``ParallelAttention._qkv`` with tables returns q and k rotated as
    the same layer's unrotated q and k would be; v is untouched."""
    h, hk = heads
    cfg = TransformerConfig(hidden_size=64, num_layers=1, num_heads=h,
                            num_kv_heads=hk, qkv_grouped=grouped)
    g = torch.Generator().manual_seed(15)
    attn = ParallelAttention(cfg, device="cpu")
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn(2, 6, 64, generator=g)
    c, sn = (_t(a) for a in jax_cos_sin(6, cfg.head_dim))
    with torch.no_grad():
        q0, k0, v0 = attn._qkv(x)
        q, k, v = attn._qkv(x, (c, sn))
    assert torch.equal(q, fused_rope(q0, c, sn))
    assert torch.equal(k, fused_rope(k0, c, sn))
    assert torch.equal(v, v0)
