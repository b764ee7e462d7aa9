"""The port's decoder models held against the JAX package's.

Tiny Llama and GPT configurations in fp32: the JAX model is initialised
from a fixed key, its parameters are carried over with
``params_from_jax`` (scanned and unrolled layer layouts), and both
models run the same numpy-made prompts on the CPU.  Logits of prefill
and decode agree within 1e-4 (the frameworks sum in different orders);
greedy and sampled continuations of ``generate`` are token-identical.
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
from apex_tpu.models import generate as jax_generate
from apex_tpu.models.generate import apply_decode as jax_apply_decode
from apex_tpu.models.generate import init_cache as jax_init_cache
from apex_tpu.models.generate import prefill_tokens as jax_prefill
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    LlamaConfig,
    apply_decode,
    generate,
    init_cache,
    params_from_jax,
    prefill_tokens,
)
from apex_tpu_torch.ops import prng_key

CONFIGS = {
    "llama": (JaxLlamaConfig, LlamaConfig, {}),
    "gpt_learned": (JaxGPTConfig, GPTConfig,
                    {"position_embedding": "learned"}),
    "gpt_rope": (JaxGPTConfig, GPTConfig, {}),
}


def build(name, scan_layers=True, **extra):
    """(jax model, jax variables, port model) with the same weights."""
    jcls, cls, kw = CONFIGS[name]
    kw = {**kw, **extra}
    jm = JaxGPTModel(jcls.tiny(scan_layers=scan_layers, **kw))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    variables = {"params": variables["params"]}
    tree = jax.tree.map(np.asarray, flax.core.meta.unbox(variables))
    cfg = cls.tiny(**kw)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return jm, variables, model


@pytest.fixture(scope="module")
def llama():
    return build("llama")


def _ids(seed, shape, vocab=1024):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _close(port, ref, tol=1e-4):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name,scan_layers", [
    ("llama", True), ("llama", False), ("gpt_learned", True),
    ("gpt_rope", False)])
def test_prefill_and_decode_logits_match_jax(name, scan_layers):
    jm, variables, model = build(name, scan_layers)
    ids = _ids(1, (2, 11))
    jcache = jax_init_cache(jm, 2)
    jl, jcache = jax_prefill(jm, variables, jcache, jnp.asarray(ids))
    cache = init_cache(model, 2)
    tl, cache = prefill_tokens(model, cache, torch.from_numpy(ids))
    _close(tl, jl)
    for step in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = jax_apply_decode(jm, variables, jcache,
                                      jnp.asarray(nxt))
        jl = jl[:, -1]
        tl, cache = apply_decode(model, cache, torch.from_numpy(nxt),
                                 kv_len=12 + step)
        _close(tl[:, -1], jl)
    assert cache["index"].tolist() == [13, 13]


def test_params_from_jax_layouts_and_shapes(llama):
    jm, variables, model = llama
    tree = jax.tree.map(np.asarray, flax.core.meta.unbox(variables))
    sd = params_from_jax(tree, model.cfg)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    qkv = tree["params"]["transformer"]["layers"]["layer"]["attention"][
        "qkv_proj"]["kernel"]
    np.testing.assert_array_equal(
        sd["transformer.layers.1.attention.qkv_proj.weight"].numpy(),
        qkv[1].T)


def test_rows_at_different_positions_match_one_row_runs(llama):
    """The per-row cache index: a batch of rows at their own positions
    computes what each row computes alone."""
    _, _, model = llama
    prompts = [_ids(2, (1, 5)), _ids(3, (1, 9))]
    solo = []
    for p in prompts:
        cache = init_cache(model, 1)
        prefill_tokens(model, cache, torch.from_numpy(p))
        logits, _ = apply_decode(model, cache, torch.tensor([[7]]))
        solo.append(logits[0, -1])
    cache = init_cache(model, 2)
    for row, p in enumerate(prompts):
        one = init_cache(model, 1)
        prefill_tokens(model, one, torch.from_numpy(p))
        for key in ("key", "value"):
            cache[key][:, row] = one[key][:, 0]
        cache["index"][row] = one["index"][0]
    logits, _ = apply_decode(model, cache, torch.tensor([[7], [7]]),
                             kv_len=10)
    for row in range(2):
        torch.testing.assert_close(logits[row, -1], solo[row], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["einsum", "blocked"])
def test_decode_attention_modes_agree(mode):
    jm, variables, model = build("llama", decode_attn=mode)
    ids = _ids(4, (1, 6))
    jcache = jax_init_cache(jm, 1)
    _, jcache = jax_prefill(jm, variables, jcache, jnp.asarray(ids))
    jl, _ = jax_apply_decode(jm, variables, jcache, jnp.asarray([[3]]))
    cache = init_cache(model, 1)
    prefill_tokens(model, cache, torch.from_numpy(ids))
    tl, _ = apply_decode(model, cache, torch.tensor([[3]]))
    _close(tl, jl)


def test_chunked_prefill_matches_jax(llama):
    jm, variables, model = llama
    ids = _ids(5, (1, 13))
    jl, _ = jax_prefill(jm, variables, jax_init_cache(jm, 1),
                        jnp.asarray(ids), 4)
    tl, _ = prefill_tokens(model, init_cache(model, 1),
                           torch.from_numpy(ids), 4)
    _close(tl, jl)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(temperature=0.9, top_k=20),
    dict(temperature=1.1, top_p=0.8),
    dict(temperature=0.7, top_k=50, top_p=0.9, eos_id=5),
])
def test_generate_matches_jax(llama, kw):
    jm, variables, model = llama
    ids = _ids(6, (2, 7))
    ref = jax_generate(jm, variables, jnp.asarray(ids), max_new_tokens=6,
                       rng=jax.random.PRNGKey(9), **kw)
    got = generate(model, torch.from_numpy(ids), max_new_tokens=6,
                   rng=prng_key(9), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_validation(llama):
    _, _, model = llama
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, ids, max_new_tokens=300)
    with pytest.raises(ValueError, match="rng"):
        generate(model, ids, max_new_tokens=2, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        generate(model, ids, max_new_tokens=2, top_k=0)


def test_slice_boundaries_raise_not_implemented(llama):
    _, _, model = llama
    with pytest.raises(NotImplementedError, match="A-6"):
        GPTConfig.tiny(remat=True, remat_policy="dots_saveable")
    with pytest.raises(ValueError, match="causal"):
        enc = GPTModel(GPTConfig.tiny(causal=False), device="cpu")
        enc(torch.zeros((1, 3), dtype=torch.int32),
            cache=init_cache(enc, 1))
    with pytest.raises(NotImplementedError, match="A-3"):
        LlamaConfig.tiny(kv_cache="paged")
    with pytest.raises(NotImplementedError, match="A-4"):
        LlamaConfig.tiny(sliding_window=16)
    with pytest.raises(NotImplementedError, match="A-4"):
        LlamaConfig.tiny(num_moe_experts=4)


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(GPTConfig.tiny())


def test_init_weights_is_seeded():
    cfg = LlamaConfig.tiny(num_layers=1)
    a, b = GPTModel(cfg, device="cpu"), GPTModel(cfg, device="cpu")
    a.init_weights(torch.Generator().manual_seed(0))
    b.init_weights(torch.Generator().manual_seed(0))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(a.final_norm.weight, torch.ones(256))
