"""The port's multi-head-attention and fused-dense modules, the contrib
aliases and a diffusion-style spatial block, held against the JAX
package's.

- ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn``: the JAX module's
  parameters carried over by ``mha_params_from_jax``; outputs and the
  gradients of the input(s) and of every parameter (the JAX gradient tree
  carried over the same way) from ``jax.vjp``.  Cases: bool and float
  masks, 2-D ``(sq, sk)`` and 3-D ``(b, sq, sk)``, key padding, causal,
  ``include_norm_add``, bias on and off, encdec with ``sq != sk``.
- Dropout: the JAX module draws its seed from the key flax's
  ``make_rng("dropout")`` hands it (``_derive_seed``, captured here); the
  port, given that integer, drops the same probabilities — the outputs
  agree at fp32 tolerance, which a single differing keep bit would break.
- ``fused_dense`` against the JAX function (every activation, with and
  without bias, fp32 and bf16), ``FusedDense``, ``FusedDenseGeluDense``
  and ``MLP`` against the JAX modules (``mlp_params_from_jax``), outputs
  and gradients.
- The contrib aliases resolve onto the ported ops;
  ``SoftmaxCrossEntropyLoss`` against the JAX class.
- The spatial block: GroupNorm+SiLU, then ``SelfMultiheadAttn(
  include_norm_add)`` over the H·W tokens, then ``FusedDenseGeluDense``;
  output and every gradient against JAX.
- ``TransformerConfig(attention_block_q=512)`` runs in the port (tile
  hints).

All on the CPU (the flash attention's and LayerNorm's plain paths),
inputs from numpy with fixed seeds.  Tolerances: fp32 rtol 2e-5, atol
1e-5 on outputs and input gradients; parameter gradients (sums over the
batch) within 2e-5 of their largest entry; bf16 within one ulp of the
JAX value, plus 2^-20 of the largest magnitude near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops.multihead_attn as jax_mha_module
from apex_tpu.ops import MLP as JaxMLP
from apex_tpu.ops import EncdecMultiheadAttn as JaxEncdec
from apex_tpu.ops import FusedDense as JaxFusedDense
from apex_tpu.ops import FusedDenseGeluDense as JaxFDGD
from apex_tpu.ops import GroupNorm as JaxGroupNorm
from apex_tpu.ops import SelfMultiheadAttn as JaxSelf
from apex_tpu.ops import fused_dense as jax_fused_dense
from apex_tpu.ops.attention import _derive_seed
from apex_tpu_torch import contrib
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    group_norm_params_from_jax,
    mha_params_from_jax,
    mlp_params_from_jax,
)
from apex_tpu_torch.ops import (
    MLP,
    EncdecMultiheadAttn,
    FusedDense,
    FusedDenseGeluDense,
    GroupNorm,
    SelfMultiheadAttn,
    fused_dense,
)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, dtype=torch.float32, *, rel_to_max=False):
    got = got.detach().float().numpy()
    ref = _np(ref)
    if dtype == torch.bfloat16:
        mag = np.maximum(np.abs(ref), 2.0 ** -126)
        ulp = np.maximum(np.exp2(np.floor(np.log2(mag)) - 7), 2.0 ** -133)
        ulp = ulp + 2.0 ** -20 * float(np.abs(ref).max())
        bad = np.abs(got - ref) > ulp
        assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond one ulp; "
                               f"worst {np.abs(got - ref).max()}")
    elif rel_to_max:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * float(np.abs(ref).max()))
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)


def _perturb(params, seed):
    """Non-trivial parameters (LayerNorm scale 1 ± 0.1, biases nonzero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(0.1 * rng.normal(size=a.shape), a.dtype),
        params)


def _port_grads(module, outputs, cotangent, inputs):
    names = [n for n, _ in module.named_parameters()]
    leaves = list(inputs) + [p for _, p in module.named_parameters()]
    grads = torch.autograd.grad(outputs, leaves, cotangent)
    return grads[:len(inputs)], dict(zip(names, grads[len(inputs):]))


def _check_param_grads(port_grads, jax_grads, to_port):
    ref = to_port(jax.device_get(jax_grads))
    assert set(ref) == set(port_grads)
    for name, g in port_grads.items():
        _close(g, ref[name].numpy(), rel_to_max=True)


def _masks(kind, b, sq, sk, rng):
    """``(mask, key_padding_mask)`` as numpy, for a mask kind."""
    mask = kp = None
    if kind.startswith("bool"):
        shape = (sq, sk) if kind.endswith("2d") else (b, sq, sk)
        mask = rng.random(shape) < 0.3
        mask[..., 0] = False                 # no row fully masked
    elif kind.startswith("float"):
        shape = (sq, sk) if kind.endswith("2d") else (b, sq, sk)
        mask = rng.normal(size=shape).astype(np.float32)
    elif kind == "key_padding":
        kp = np.zeros((b, sk), bool)
        kp[1, sk // 2:] = True
    return mask, kp


def _both_masks(mask, kp):
    jm = None if mask is None else jnp.asarray(mask)
    jk = None if kp is None else jnp.asarray(kp)
    tm = None if mask is None else torch.from_numpy(mask)
    tk = None if kp is None else torch.from_numpy(kp)
    return jm, jk, tm, tk


_SELF = [
    # mask kind, causal, bias, include_norm_add
    ("none", False, True, True),
    ("bool2d", False, True, False),
    ("bool3d", False, False, True),
    ("float2d", False, True, True),
    ("float3d", False, False, False),
    ("key_padding", False, True, True),
    ("none", True, False, True),
    ("key_padding", True, True, False),
]


@pytest.mark.parametrize("ci", range(len(_SELF)))
def test_self_attention_matches_jax(ci):
    kind, causal, bias, norm_add = _SELF[ci]
    rng = np.random.default_rng(100 + ci)
    b, s, e, h = 2, 12, 32, 4
    x = rng.normal(size=(b, s, e)).astype(np.float32)
    dy = rng.normal(size=(b, s, e)).astype(np.float32)
    mask, kp = _masks(kind, b, s, s, rng)
    jm, jk, tm, tk = _both_masks(mask, kp)
    jmod = JaxSelf(embed_dim=e, num_heads=h, bias=bias,
                   include_norm_add=norm_add, causal=causal)
    params = _perturb(jmod.init(jax.random.PRNGKey(ci), jnp.asarray(x)), ci)
    yj, vjp = jax.vjp(lambda p, a: jmod.apply(
        p, a, mask=jm, key_padding_mask=jk), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    mod = SelfMultiheadAttn(e, h, bias=bias, include_norm_add=norm_add,
                            causal=causal, device="cpu")
    mod.load_state_dict(mha_params_from_jax(jax.device_get(params)))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt, mask=tm, key_padding_mask=tk)
    (dx,), pg = _port_grads(mod, y, torch.from_numpy(dy), [xt])
    _close(y, yj)
    _close(dx, gx)
    _check_param_grads(pg, gp, mha_params_from_jax)


_ENCDEC = [
    # mask kind, bias, include_norm_add
    ("none", True, True),
    ("bool3d", True, False),
    ("float2d", False, True),
    ("key_padding", True, True),
]


@pytest.mark.parametrize("ci", range(len(_ENCDEC)))
def test_encdec_attention_matches_jax(ci):
    kind, bias, norm_add = _ENCDEC[ci]
    rng = np.random.default_rng(200 + ci)
    b, sq, sk, e, h = 2, 6, 10, 32, 2
    q = rng.normal(size=(b, sq, e)).astype(np.float32)
    kv = rng.normal(size=(b, sk, e)).astype(np.float32)
    dy = rng.normal(size=(b, sq, e)).astype(np.float32)
    mask, kp = _masks(kind, b, sq, sk, rng)
    jm, jk, tm, tk = _both_masks(mask, kp)
    jmod = JaxEncdec(embed_dim=e, num_heads=h, bias=bias,
                     include_norm_add=norm_add)
    params = _perturb(jmod.init(jax.random.PRNGKey(ci), jnp.asarray(q),
                                jnp.asarray(kv)), ci)
    yj, vjp = jax.vjp(lambda p, a, c: jmod.apply(
        p, a, c, mask=jm, key_padding_mask=jk), params, jnp.asarray(q),
        jnp.asarray(kv))
    gp, gq, gkv = vjp(jnp.asarray(dy))
    mod = EncdecMultiheadAttn(e, h, bias=bias, include_norm_add=norm_add,
                              device="cpu")
    mod.load_state_dict(mha_params_from_jax(jax.device_get(params)))
    qt = torch.from_numpy(q).requires_grad_()
    kvt = torch.from_numpy(kv).requires_grad_()
    y = mod(qt, kvt, mask=tm, key_padding_mask=tk)
    (dq, dkv), pg = _port_grads(mod, y, torch.from_numpy(dy), [qt, kvt])
    assert y.shape == (b, sq, e)
    _close(y, yj)
    _close(dq, gq)
    _close(dkv, gkv)
    _check_param_grads(pg, gp, mha_params_from_jax)


@pytest.mark.parametrize("encdec", [False, True])
def test_dropout_keeps_the_jax_probabilities(encdec, monkeypatch):
    """The seed JAX derives from flax's dropout key, handed to the port,
    gives the same keep mask: outputs and input gradients agree."""
    rng = np.random.default_rng(7)
    b, s, e, h = 2, 16, 32, 4
    x = rng.normal(size=(b, s, e)).astype(np.float32)
    kv = rng.normal(size=(b, s + 4, e)).astype(np.float32)
    dy = rng.normal(size=(b, s, e)).astype(np.float32)
    seeds = []
    real = jax_mha_module.fused_attention

    def spy(*a, dropout_rng=None, **kw):
        if dropout_rng is not None:
            seeds.append(int(_derive_seed(dropout_rng)[0]))
        return real(*a, dropout_rng=dropout_rng, **kw)
    monkeypatch.setattr(jax_mha_module, "fused_attention", spy)
    if encdec:
        jmod = JaxEncdec(embed_dim=e, num_heads=h, bias=True, dropout=0.3)
        args = (jnp.asarray(x), jnp.asarray(kv))
        mod = EncdecMultiheadAttn(e, h, bias=True, dropout=0.3, device="cpu")
    else:
        jmod = JaxSelf(embed_dim=e, num_heads=h, bias=True,
                       include_norm_add=True, dropout=0.3)
        args = (jnp.asarray(x),)
        mod = SelfMultiheadAttn(e, h, bias=True, include_norm_add=True,
                                dropout=0.3, device="cpu")
    params = _perturb(jmod.init(jax.random.PRNGKey(1), *args), 3)
    rngs = {"dropout": jax.random.PRNGKey(42)}
    yj, vjp = jax.vjp(lambda *a: jmod.apply(
        params, *a, deterministic=False, rngs=rngs), *args)
    gj = vjp(jnp.asarray(dy))
    assert len(set(seeds)) == 1
    mod.load_state_dict(mha_params_from_jax(jax.device_get(params)))
    ins = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    y = mod(*ins, deterministic=False, dropout_seed=seeds[0])
    grads = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    _close(y, yj)
    for g, r in zip(grads, gj):
        _close(g, r)
    # dropout is really on: deterministic differs, and a seed is required
    assert not torch.allclose(mod(*ins), y)
    with pytest.raises(ValueError, match="dropout_seed"):
        mod(*ins, deterministic=False)


def test_mha_checks():
    with pytest.raises(ValueError, match="must divide"):
        SelfMultiheadAttn(30, 4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        EncdecMultiheadAttn(30, 4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        JaxSelf(embed_dim=30, num_heads=4).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 2, 30)))


# ------------------------------------------------------------------ #
# fused dense / MLP
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", [None, "gelu", "relu", "silu",
                                        "sigmoid"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_fused_dense_matches_jax(use_bias, activation, dtype):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, 5, 24)).astype(np.float32)).to(
        dtype)
    k = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32)).to(
        dtype)
    bias = torch.from_numpy(rng.normal(size=40).astype(np.float32)).to(
        dtype) if use_bias else None
    j = [None if t is None else jnp.asarray(t.float().numpy(), _JDT[dtype])
         for t in (x, k, bias)]
    y = fused_dense(x, k, bias, activation)
    yj = jax_fused_dense(*j, activation)
    assert y.dtype == dtype
    _close(y, yj, dtype)


def _module_case(kind):
    if kind == "dense":
        return (JaxFusedDense(features=24),
                FusedDense(24, in_features=16, device="cpu"))
    if kind == "dense_gelu_dense":
        return (JaxFDGD(intermediate_features=48, out_features=16),
                FusedDenseGeluDense(48, 16, device="cpu"))
    return (JaxMLP(mlp_sizes=(32, 8, 12), activation="silu"),
            MLP((32, 8, 12), in_features=16, activation="silu",
                device="cpu"))


@pytest.mark.parametrize("kind", ["dense", "dense_gelu_dense", "mlp"])
def test_dense_modules_match_jax(kind):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    jmod, mod = _module_case(kind)
    params = _perturb(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)), 4)
    yj, vjp = jax.vjp(lambda p, a: jmod.apply(p, a), params, jnp.asarray(x))
    dy = rng.normal(size=yj.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(dy))
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(
        params["params"])
    mod.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    (dx,), pg = _port_grads(mod, y, torch.from_numpy(dy), [xt])
    _close(y, yj)
    _close(dx, gx)
    _check_param_grads(pg, gp, mlp_params_from_jax)


def test_dense_modules_in_bf16_match_jax():
    """``dtype=bfloat16`` modules with fp32 parameters, as amp runs them:
    one rounding of the fp32 epilogue, as in JAX."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jmod = JaxFDGD(intermediate_features=32, out_features=16,
                   dtype=jnp.bfloat16)
    params = _perturb(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x)), 5)
    mod = FusedDenseGeluDense(32, 16, dtype=torch.bfloat16, device="cpu")
    mod.load_state_dict(mlp_params_from_jax(jax.device_get(params)))
    # the hidden activation is bf16 in both: compare it, then the output
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    h = fused_dense(xb, mod.kernel1.to(torch.bfloat16).t(),
                    mod.bias1.to(torch.bfloat16), "gelu")
    hj = jax_fused_dense(xj, params["params"]["kernel1"].astype(jnp.bfloat16),
                         params["params"]["bias1"].astype(jnp.bfloat16),
                         "gelu")
    _close(h, hj, torch.bfloat16)
    y = mod(xb)
    assert y.dtype == torch.bfloat16
    _close(y, jmod.apply(params, xj), torch.bfloat16)


def test_mlp_checks():
    with pytest.raises(ValueError, match="unknown activation"):
        MLP((4,), in_features=2, activation="swish", device="cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        fused_dense(torch.zeros(2, 2), torch.zeros(2, 2), None, "tanh")
    m = MLP((4, 3), in_features=2, use_bias=False, device="cpu")
    assert sorted(n for n, _ in m.named_parameters()) == ["kernel_0",
                                                          "kernel_1"]
    assert m.kernel_0.shape == (4, 2)        # (out, in), PyTorch's layout


# ------------------------------------------------------------------ #
# contrib aliases
# ------------------------------------------------------------------ #
def test_contrib_aliases_resolve_onto_ported_ops():
    import apex_tpu.contrib as jc
    from apex_tpu_torch.ops import (
        fused_attention,
        fused_layer_norm,
        softmax_cross_entropy,
    )
    assert contrib.fused_attention is fused_attention
    assert contrib.fast_layer_norm is fused_layer_norm
    assert contrib.softmax_cross_entropy is softmax_cross_entropy
    assert contrib.SelfMultiheadAttn is SelfMultiheadAttn
    assert contrib.EncdecMultiheadAttn is EncdecMultiheadAttn
    # every alias is one the JAX contrib has; it has no group_norm alias
    assert set(contrib.__all__) <= set(jc.__all__)
    assert "group_norm" not in jc.__all__ and "group_norm" not in dir(contrib)


@pytest.mark.parametrize("smoothing,ignore", [(0.0, -100), (0.1, 2)])
def test_softmax_cross_entropy_loss_matches_jax(smoothing, ignore):
    import apex_tpu.contrib as jc
    rng = np.random.default_rng(14)
    logits = rng.normal(size=(6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=6).astype(np.int32)
    labels[0] = 2
    ref = jc.SoftmaxCrossEntropyLoss(smoothing, ignore)(
        jnp.asarray(logits), jnp.asarray(labels))
    got = contrib.SoftmaxCrossEntropyLoss(smoothing, ignore)(
        torch.from_numpy(logits), torch.from_numpy(labels).long())
    _close(got, ref)


# ------------------------------------------------------------------ #
# the spatial block as a whole
# ------------------------------------------------------------------ #
class _JaxBlock:
    def __init__(self, c, groups, heads):
        self.gn = JaxGroupNorm(num_groups=groups, act="silu")
        self.attn = JaxSelf(embed_dim=c, num_heads=heads, bias=True,
                            include_norm_add=True)
        self.mlp = JaxFDGD(intermediate_features=2 * c, out_features=c)

    def init(self, x):
        b, hh, ww, c = x.shape
        t = x.reshape(b, hh * ww, c)
        return {"gn": self.gn.init(jax.random.PRNGKey(0), x),
                "attn": self.attn.init(jax.random.PRNGKey(1), t),
                "mlp": self.mlp.init(jax.random.PRNGKey(2), t)}

    def apply(self, p, x):
        b, hh, ww, c = x.shape
        t = self.gn.apply(p["gn"], x).reshape(b, hh * ww, c)
        t = self.attn.apply(p["attn"], t)
        return self.mlp.apply(p["mlp"], t).reshape(x.shape)


class _Block(torch.nn.Module):
    def __init__(self, c, groups, heads, device):
        super().__init__()
        self.gn = GroupNorm(groups, c, act="silu", device=device)
        self.attn = SelfMultiheadAttn(c, heads, bias=True,
                                      include_norm_add=True, device=device)
        self.mlp = FusedDenseGeluDense(2 * c, c, device=device)

    def forward(self, x):
        b, hh, ww, c = x.shape
        t = self.gn(x).reshape(b, hh * ww, c)
        return self.mlp(self.attn(t)).reshape(x.shape)


def test_spatial_block_matches_jax():
    """GroupNorm+SiLU → self-attention with norm-add over the H·W tokens →
    dense-GELU-dense: output and every gradient."""
    rng = np.random.default_rng(15)
    b, hh, ww, c, groups, heads = 2, 4, 4, 64, 8, 4
    x = rng.normal(size=(b, hh, ww, c)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jb = _JaxBlock(c, groups, heads)
    params = _perturb(jb.init(jnp.asarray(x)), 6)
    yj, vjp = jax.vjp(jb.apply, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    block = _Block(c, groups, heads, "cpu")
    p = jax.device_get(params)
    for name, fn in (("gn", group_norm_params_from_jax),
                     ("attn", mha_params_from_jax),
                     ("mlp", mlp_params_from_jax)):
        getattr(block, name).load_state_dict(fn(p[name]))
    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt)
    (dx,), pg = _port_grads(block, y, torch.from_numpy(dy), [xt])
    _close(y, yj)
    _close(dx, gx)
    gpn = jax.device_get(gp)
    for name, fn in (("gn", group_norm_params_from_jax),
                     ("attn", mha_params_from_jax),
                     ("mlp", mlp_params_from_jax)):
        ref = fn(gpn[name])
        for k, v in ref.items():
            _close(pg[f"{name}.{k}"], v.numpy(), rel_to_max=True)


def test_attention_block_hints_run_in_the_port():
    """``TransformerConfig(attention_block_q=512)`` builds and runs; the
    hint changes nothing."""
    cfg = GPTConfig.tiny(num_layers=1, vocab_size=64, hidden_size=32,
                         max_seq_len=16)
    hinted = GPTConfig.tiny(num_layers=1, vocab_size=64, hidden_size=32,
                            max_seq_len=16, attention_block_q=512,
                            attention_block_k=256)
    m = GPTModel(cfg, device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    mh = GPTModel(hinted, device="cpu")
    mh.load_state_dict(m.state_dict())
    ids = torch.randint(0, 64, (2, 16))
    y = m(ids)
    assert bool(torch.isfinite(y).all()) and torch.equal(y, mh(ids))
