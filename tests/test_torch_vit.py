"""The port's ViT held against the JAX package's.

``ViTConfig.tiny`` at hidden 64 (2 layers, 16×16 NHWC images, patches of
4, 17 tokens) in fp32 with the JAX model's weights carried by
``params_from_jax`` (conv HWIO → OIHW, class token, positions, head):
logits and every gradient within 1e-5 (gradients relative to each
tensor's largest entry), under remat too; two amp O0 + FusedLAMB steps
leave the parameters within 1e-5 of the JAX state's; two O2 bf16 steps
keep the loss within 0.05 of JAX's.  The config's encoder contract
(``causal`` and ``position_embedding`` validated, ``max_seq_len``
derived) is the JAX config's.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jax_amp
from apex_tpu.models import ViTConfig as JaxViTConfig
from apex_tpu.models import ViTModel as JaxViTModel
from apex_tpu.optim import fused_lamb as jax_fused_lamb
from apex_tpu_torch import amp
from apex_tpu_torch.models import ViTConfig, ViTModel, params_from_jax
from apex_tpu_torch.optim import fused_lamb

TOL = 1e-5
KW = dict(hidden_size=64, num_heads=2, image_size=16, patch_size=4)


def _pair(half=False, **extra):
    jkw = dict(KW, scan_layers=False, **extra)
    if half:
        jkw["dtype"] = jnp.bfloat16
    jm = JaxViTModel(JaxViTConfig.tiny(**jkw))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 16, 3), jnp.float32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": variables["params"]}))
    cfg = ViTConfig.tiny(**KW, **extra,
                         **({"dtype": torch.bfloat16} if half else {}))
    model = ViTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jm, params, model


def _data(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    return x, rng.integers(0, 10, size=(n,)).astype(np.int32)


def _jax_loss(jm, p, x, y):
    logits = jm.apply(p, x)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, y).mean()


@pytest.mark.parametrize("remat", [False, True])
def test_logits_and_gradients_match_jax(remat):
    jm, params, model = _pair(remat=remat)
    x, y = _data()
    jl = jax.jit(jm.apply)(params, jnp.asarray(x))
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, jnp.asarray(x), jnp.asarray(y))))(params)
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    ref = params_from_jax(jax.tree.map(np.asarray, jg), model.cfg)
    names = dict(model.named_parameters())
    assert set(ref) == set(names)
    for name, g in ref.items():
        err = float((names[name].grad - g).abs().max())
        assert err <= TOL * max(float(g.abs().max()), 1e-6), (name, err)


def _jax_steps(jm, params, level, half, data, steps=2):
    state = jax_amp.initialize(jm.apply, params, jax_fused_lamb(1e-3),
                               opt_level=level, half_dtype=half)
    x, y = (jnp.asarray(a) for a in data)

    @jax.jit
    def step(state):
        def loss_of(p):
            logits = state.apply_fn(state.policy.cast_to_compute(p), x)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), y).mean()
            return state.scale_loss(loss), loss
        grads, loss = jax.grad(loss_of, has_aux=True)(state.params)
        state, finite = state.apply_gradients(grads=grads)
        return state, loss, finite
    losses = []
    for _ in range(steps):
        state, loss, finite = step(state)
        assert bool(finite)
        losses.append(float(loss))
    return state, losses


def _port_steps(model, level, half, data, steps=2):
    state = amp.initialize(model, fused_lamb(1e-3), level, half_dtype=half)
    x, y = (torch.from_numpy(a) for a in data)
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(x).float(), y.long())
        state.scale_loss(loss).backward()
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    return state, losses


def test_o0_fused_lamb_steps_match_jax():
    jm, params, model = _pair()
    data = _data(1)
    jstate, jlosses = _jax_steps(jm, params, "O0", None, data)
    state, losses = _port_steps(model, "O0", None, data)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          model.cfg)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_o2_bf16_fused_lamb_loss_within_band():
    jm, params, model = _pair(half=True, remat=True)
    data = _data(2)
    _, jlosses = _jax_steps(jm, params, "O2", jnp.bfloat16, data, steps=3)
    state, losses = _port_steps(model, "O2", torch.bfloat16, data, steps=3)
    np.testing.assert_allclose(losses, jlosses, atol=0.05)
    assert losses[-1] < losses[0]
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name


def test_config_contract_matches_jax():
    for kw in (dict(), dict(patch_size=8), dict(image_size=224,
                                                patch_size=14)):
        assert (ViTConfig.tiny(**kw).max_seq_len
                == JaxViTConfig.tiny(**kw).max_seq_len)
    huge = ViTConfig.vit_huge()
    assert (huge.hidden_size, huge.num_layers, huge.num_heads,
            huge.head_dim, huge.max_seq_len) == (1280, 32, 16, 80, 257)
    cfg = dataclasses.replace(ViTConfig.tiny(), patch_size=4)
    assert cfg.max_seq_len == 65
    with pytest.raises(ValueError, match="bidirectional"):
        ViTConfig.tiny(causal=True)
    with pytest.raises(ValueError, match="learned"):
        ViTConfig.tiny(position_embedding="rope")
    with pytest.raises(TypeError):
        ViTConfig.tiny(max_seq_len=10)


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTModel(ViTConfig.tiny())
