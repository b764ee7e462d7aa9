"""The port's mixture-of-experts layer held against the JAX package's.

``top_k_gating`` on numpy-made logits: dispatch masks exactly equal,
combine weights and the aux term within 1e-6 (fp32), with drops at
capacity factor 1.25 and none at the drop-free factor; ``MoEMLP``'s
output and every gradient within 1e-5 with the JAX module's weights; a
tiny Mixtral-style model's logits and ``moe_aux_loss`` against the JAX
model applied with ``mutable=["losses"]``; ``moe_aux_loss`` is 0 for a
model without MoE layers and counts each layer once under remat.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import moe_aux_loss as jax_moe_aux_loss
from apex_tpu.transformer import moe as jmoe
from apex_tpu_torch.models import (
    GPTModel,
    LlamaConfig,
    gpt_loss_fn,
    moe_aux_loss,
    params_from_jax,
)
from apex_tpu_torch.transformer import MoEConfig, MoEMLP, moe

TOL = 1e-5


def _logits(seed, shape, ties=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if ties:
        x[..., 1] = x[..., 0]       # first-argmax ties to the lower index
    return x


@pytest.mark.parametrize("t,e,k,cf", [
    (16, 4, 1, 1.25), (16, 4, 2, 1.25), (24, 8, 2, 4.0), (12, 3, 3, 1.0)])
@pytest.mark.parametrize("ties", [False, True])
def test_top_k_gating_matches_jax(t, e, k, cf, ties):
    lg = _logits(t * e + k, (t, e), ties)
    cap = max(1, int(np.ceil(cf * t * k / e)))
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(lg), k, cap)
    d, c, a = moe.top_k_gating(torch.from_numpy(lg), k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    if cf * k / e * t >= t * k / e * (e / k):
        assert float(d.sum()) == t * k          # drop-free: every route
    # each token takes at most k slots, each slot at most one token
    assert float(d.sum(dim=(1, 2)).max()) <= k
    assert float(d.sum(dim=0).max()) <= 1


def test_capacity_drops_at_1p25():
    """Skewed routing at the training default drops assignments; the
    dropped tokens have no slot in either implementation."""
    lg = _logits(3, (32, 4))
    lg[:, 0] += 3.0
    cap = int(np.ceil(1.25 * 32 * 2 / 4))
    jd, _, _ = jmoe.top_k_gating(jnp.asarray(lg), 2, cap)
    d, _, _ = moe.top_k_gating(torch.from_numpy(lg), 2, cap)
    assert float(d.sum()) < 64
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_grouped_routing_equals_vmap():
    lg = _logits(5, (3, 10, 4))
    jd, jc, ja = jax.vmap(lambda x: jmoe.top_k_gating(x, 2, 6))(
        jnp.asarray(lg))
    d, c, a = moe.top_k_gating(torch.from_numpy(lg), 2, 6)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)


def test_top_k_above_experts_raises():
    with pytest.raises(ValueError, match="top_k"):
        moe.top_k_gating(torch.zeros(4, 2), 3, 4)


@pytest.mark.parametrize("gated,bias,act,cf", [
    (True, False, "silu", 4.0), (False, True, "gelu", 1.25)])
def test_moe_mlp_forward_and_grads_match_jax(gated, bias, act, cf):
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf, hidden_size=32,
              ffn_hidden_size=48, activation=act, gated=gated,
              use_bias=bias, aux_loss_weight=0.01)
    jm = jmoe.MoEMLP(jmoe.MoEConfig(expert_axis=None, **kw))
    x = np.random.default_rng(7).normal(size=(2, 12, 32)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))[
        "params"]
    if bias:     # non-zero biases, so their gradients say something
        params = {**params, "b1": params["b1"] + 0.1,
                  "b2": params["b2"] - 0.2}

    def jloss(p, xx):
        y, aux = jm.apply({"params": p}, xx)
        return jnp.sum(y * y) + aux, (y, aux)
    (jl, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    m = MoEMLP(MoEConfig(**kw), device="cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = m(xt)
    loss = (y * y).sum() + aux
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   rtol=1e-4, atol=TOL, err_msg=name)


KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
          num_kv_heads=2, ffn_hidden_size=48, max_seq_len=32,
          num_moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)


def _pair(**extra):
    jm = JaxGPTModel(JaxLlamaConfig(**KW, **extra))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4), jnp.int32))
    variables = {"params": variables["params"]}
    tree = jax.tree.map(np.asarray, flax.core.meta.unbox(variables))
    cfg = LlamaConfig(**KW, **extra)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return jm, variables, model


def test_model_logits_and_aux_match_jax():
    jm, variables, model = _pair()
    ids = np.random.default_rng(2).integers(0, 128, (2, 16)).astype(np.int32)
    jl, mut = jax.jit(lambda v, i: jm.apply(v, i, mutable=["losses"]))(
        variables, jnp.asarray(ids))
    logits = model(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(moe_aux_loss(model)),
                               float(jax_moe_aux_loss(mut)), rtol=1e-6)
    assert all(layer.moe_aux is not None
               for layer in model.transformer.layers)


def test_aux_is_zero_without_moe():
    model = GPTModel(LlamaConfig.tiny(num_layers=1), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    model(torch.zeros((1, 4), dtype=torch.int32))
    aux = moe_aux_loss(model)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_aux_counted_once_under_remat():
    """The recomputation of a checkpointed MoE layer neither adds a
    second term nor replaces the tensor the loss was built from; loss
    and gradients equal the run without remat."""
    plain = GPTModel(LlamaConfig(**KW), device="cpu")
    plain.init_weights(torch.Generator().manual_seed(3))
    remat = GPTModel(LlamaConfig(**KW, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 16)).astype(np.int32))
    labels = torch.roll(ids, -1, dims=1).long()
    out = {}
    for name, model in (("plain", plain), ("remat", remat)):
        loss = gpt_loss_fn(model(ids), labels) + moe_aux_loss(model)
        held = [layer.moe_aux for layer in model.transformer.layers]
        loss.backward()
        assert all(a is layer.moe_aux for a, layer in
                   zip(held, model.transformer.layers))
        out[name] = (loss.detach(), float(moe_aux_loss(model)),
                     {n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(out["plain"][0], out["remat"][0])
    assert out["plain"][1] == out["remat"][1]
    for n, g in out["plain"][2].items():
        assert torch.equal(g, out["remat"][2][n]), n
