"""The sliding-window ring-cache decode of the port held against the JAX
package's.

A tiny Mistral (window 8, max_seq_len 64, GQA 4/2, fp32) with the JAX
model's weights: prompts of 20 tokens run single-call and in chunks of
5; per-step logits agree within 1e-5, greedy and sampled ``generate``
continuations (12 new tokens, the same threefry key) are
token-identical, and the ring's decode logits equal a full-sequence
windowed forward over the same ids within 1e-5.  The card test holds
the ring chunk path's banded flash kernel against its plain version.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import generate as jax_generate
from apex_tpu.models.generate import apply_decode as jax_apply_decode
from apex_tpu.models.generate import init_cache as jax_init_cache
from apex_tpu.models.generate import prefill_tokens as jax_prefill
from apex_tpu_torch.models import (
    GPTModel,
    LlamaConfig,
    apply_decode,
    generate,
    init_cache,
    params_from_jax,
    prefill_tokens,
)
from apex_tpu_torch.ops import attention as A
from apex_tpu_torch.ops import prng_key

TOL = 1e-5
KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, ffn_hidden_size=128, max_seq_len=64,
          sliding_window=8)


@pytest.fixture(scope="module")
def mistral():
    jm = JaxGPTModel(JaxLlamaConfig(**KW))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    variables = {"params": variables["params"]}
    tree = jax.tree.map(np.asarray, flax.core.meta.unbox(variables))
    cfg = LlamaConfig(**KW)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return jm, variables, model


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=shape).astype(np.int32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_ring_cache_layout(mistral):
    _, _, model = mistral
    cache = init_cache(model, 3)
    assert tuple(cache["key"].shape) == (2, 3, 8, 2, 16)
    assert tuple(cache["slot_positions"].shape) == (3, 8)
    prefill_tokens(model, cache, torch.from_numpy(_ids(0, (3, 11))))
    # the last 8 tokens sit in their slots, position + 1
    want = [(p + 1) for p in range(3, 11)]
    got = cache["slot_positions"][0].tolist()
    assert sorted(got) == want
    assert got[11 % 8 - 1] == 11


@pytest.mark.parametrize("chunk", [0, 5])
def test_prefill_and_decode_logits_match_jax(mistral, chunk):
    jm, variables, model = mistral
    ids = _ids(1, (2, 20))
    jdecode = jax.jit(lambda c, i: jax_apply_decode(jm, variables, c, i))
    jl, jcache = jax_prefill(jm, variables, jax_init_cache(jm, 2),
                             jnp.asarray(ids), chunk)
    cache = init_cache(model, 2)
    tl, cache = prefill_tokens(model, cache, torch.from_numpy(ids), chunk)
    _close(tl, jl)
    for step in range(12):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = jdecode(jcache, jnp.asarray(nxt))
        jl = jl[:, -1]
        tl, cache = apply_decode(model, cache, torch.from_numpy(nxt))
        _close(tl[:, -1], jl)


@pytest.mark.parametrize("chunk", [0, 5])
@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.9, top_k=20)])
def test_generate_matches_jax(mistral, chunk, kw):
    jm, variables, model = mistral
    ids = _ids(2, (2, 20))
    ref = jax_generate(jm, variables, jnp.asarray(ids), max_new_tokens=12,
                       rng=jax.random.PRNGKey(4), prefill_chunk=chunk, **kw)
    got = generate(model, torch.from_numpy(ids), max_new_tokens=12,
                   rng=prng_key(4), prefill_chunk=chunk, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ring_equals_full_windowed_forward(mistral):
    """Every decode step's logits equal the full-sequence forward's
    (flash attention with the window) at that position."""
    _, _, model = mistral
    ids = torch.from_numpy(_ids(3, (2, 20)))
    out = generate(model, ids, max_new_tokens=12)
    with torch.no_grad():
        full = model(out[:, :-1])
        cache = init_cache(model, 2)
        last, cache = prefill_tokens(model, cache, out[:, :20], 5)
        steps = [last]
        for i in range(20, out.shape[1] - 1):
            lg, cache = apply_decode(model, cache, out[:, i:i + 1])
            steps.append(lg[:, -1])
    got = torch.stack(steps, dim=1)
    torch.testing.assert_close(got, full[:, 19:], rtol=TOL, atol=TOL)


def test_window_at_or_above_max_seq_len_keeps_the_dense_cache():
    cfg = LlamaConfig(**{**KW, "sliding_window": 64})
    assert cfg.ring_window is None
    model = GPTModel(cfg, device="cpu")
    cache = init_cache(model, 1)
    assert "slot_positions" not in cache
    assert cache["key"].shape[2] == 64


@pytest.mark.cuda
def test_ring_chunk_banded_kernel_matches_plain():
    """The ring chunk path's rows past the window: the banded flash
    forward (q rows after the ring head against the whole chunk) equals
    its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    s, W = 700, 256
    q = torch.randn(2, s, 32, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, s, 8, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    args = (None, 128 ** -0.5, True, W, 0.0, 0)
    o, lse = A.flash_fwd_kernel(q[:, W:], k, v, *args)
    o2, lse2 = A.flash_fwd_reference(q[:, W:], k, v, *args)
    err = (o.float() - o2.float()).abs().max().item()
    assert err <= 2 ** -7 * o2.float().abs().max().item(), err
    torch.testing.assert_close(lse, lse2, rtol=1e-5, atol=1e-4)
