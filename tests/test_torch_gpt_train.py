"""The port's full-sequence (training) forward of the decoders held
against the JAX package's.

``GPTConfig.tiny`` (LayerNorm, learned positions or RoPE) and a tiny
Llama (RMSNorm, RoPE, GQA) in fp32: JAX parameters carried over with
``params_from_jax``, the same numpy-made ids through both models on the
CPU without a cache (causal flash attention over the whole sequence).
Tolerances: logits within 1e-4; gradients of the next-token loss within
1e-4 of each tensor's largest entry (fp32 sums in another order).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    LlamaConfig,
    gpt_loss_fn,
    params_from_jax,
)

CONFIGS = {
    "gpt_learned": (JaxGPTConfig, GPTConfig,
                    {"position_embedding": "learned"}),
    "gpt_rope": (JaxGPTConfig, GPTConfig, {}),
    "llama_gqa": (JaxLlamaConfig, LlamaConfig, {}),
}


def build(name):
    jcls, cls, kw = CONFIGS[name]
    jm = JaxGPTModel(jcls.tiny(scan_layers=False, **kw))
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": variables["params"]}))
    cfg = cls.tiny(**kw)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jm, params, model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_sequence_logits_and_grads_match_jax(name):
    jm, params, model = build(name)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, size=(2, 33)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(ids))
        return jax_gpt_loss(logits.astype(jnp.float32),
                            jnp.asarray(labels)), logits
    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    logits = model(torch.from_numpy(ids))
    loss = gpt_loss_fn(logits.float(), torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    names = dict(model.named_parameters())
    assert set(ref) == set(names)
    for n, g in ref.items():
        err = (names[n].grad - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), 1e-6), n


def test_full_sequence_equals_decode_prefill():
    """The training forward and the cache path agree on a prompt."""
    from apex_tpu_torch.models import init_cache

    _, _, model = build("llama_gqa")
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1024, size=(1, 20)).astype(np.int32))
    with torch.no_grad():
        full = model(ids)
        cached = model(ids, cache=init_cache(model, 1), kv_len=20)
    torch.testing.assert_close(full, cached, rtol=1e-4, atol=1e-4)


def test_remat_and_dropout_on_the_decoder():
    cfg = GPTConfig.tiny(num_layers=2, hidden_dropout=0.1,
                         attention_dropout=0.1)
    a = GPTModel(cfg, device="cpu")
    a.init_weights(torch.Generator().manual_seed(4))
    b = GPTModel(GPTConfig.tiny(num_layers=2, hidden_dropout=0.1,
                                attention_dropout=0.1, remat=True),
                 device="cpu")
    b.load_state_dict(a.state_dict())
    ids = torch.randint(0, 1024, (2, 16), generator=torch.Generator()
                        .manual_seed(5))
    grads = []
    for m in (a, b):
        m(ids, deterministic=False, dropout_seed=9).float().pow(2).mean()\
            .backward()
        grads.append([p.grad for p in m.parameters()])
    for ga, gb in zip(*grads):
        assert torch.equal(ga, gb)
