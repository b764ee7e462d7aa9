"""The port's remat policies held against ``nothing_saveable`` and the
JAX package.

A tiny BERT (3 layers, hidden 64, fp32) with the JAX model's weights
(unrolled layers, so ``remat_skip_every`` applies on both sides): under
every policy, and with ``remat_skip_every=2``, the port's loss and
every gradient equal its ``nothing_saveable`` run bit for bit and the
JAX model's under the same policy within 1e-5 (the loss relative, each
gradient relative to its largest entry).  A counter on the plain flash
forward shows ``save_only:attn_out,attn_lse`` keeping the forward's
outputs: one call a layer instead of two.  The policies compose with
``o1_intercept``: the recomputation reruns under it, so the O1 gradients
equal the O1 run without remat bit for bit.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import bert_mlm_loss_fn as jax_bert_loss
from apex_tpu_torch.amp.o1 import o1_intercept
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    GPTConfig,
    LlamaConfig,
    bert_mlm_loss_fn,
    params_from_jax,
)
from apex_tpu_torch.ops import attention as A

TOL = 1e-5
B, S, P = 2, 32, 6
KW = dict(hidden_size=64, num_heads=2, num_layers=3, max_seq_len=32)
POLICIES = {
    "nothing": dict(remat_policy="nothing_saveable"),
    "everything": dict(remat_policy="everything_saveable"),
    "dots": dict(remat_policy="dots_with_no_batch_dims_saveable"),
    "attn": dict(remat_policy="save_only:attn_out,attn_lse"),
    "attn_out": dict(remat_policy="save_only:attn_out"),
    "skip2": dict(remat_policy="nothing_saveable", remat_skip_every=2),
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    pos = np.stack([rng.permutation(S)[:P] for _ in range(B)]).astype(
        np.int32)
    return ids, mask, pos, np.take_along_axis(ids, pos, axis=1)


@pytest.fixture(scope="module")
def weights():
    jm = JaxBertModel(JaxBertConfig.tiny(scan_layers=False, **KW))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": variables["params"]}))


def _port_run(weights, data, dtype=torch.float32, **kw):
    cfg = BertConfig.tiny(remat=True, dtype=dtype, **KW, **kw)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(weights, cfg))
    ids, mask, pos, labels = (torch.from_numpy(a) for a in data)
    logits, _ = model(ids, attention_mask=mask, mlm_positions=pos)
    loss = bert_mlm_loss_fn(logits.float(), labels.long())
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}


def _jax_run(weights, data, **kw):
    jm = JaxBertModel(JaxBertConfig.tiny(scan_layers=False, remat=True,
                                         **KW, **kw))
    ids, mask, pos, labels = (jnp.asarray(a) for a in data)

    def loss_fn(p):
        logits, _ = jm.apply(p, ids, attention_mask=mask, mlm_positions=pos)
        return jax_bert_loss(logits.astype(jnp.float32), labels)
    return jax.jit(jax.value_and_grad(loss_fn))(weights)


@pytest.fixture(scope="module")
def reference(weights):
    return _port_run(weights, _batch(), **POLICIES["nothing"])


@pytest.mark.parametrize("policy", list(POLICIES))
def test_policy_equals_nothing_saveable_and_jax(policy, weights, reference):
    data = _batch()
    loss, grads = _port_run(weights, data, **POLICIES[policy])
    ref_loss, ref_grads = reference
    assert torch.equal(loss, ref_loss)
    assert set(grads) == set(ref_grads)
    for n, g in grads.items():
        assert torch.equal(g, ref_grads[n]), n
    jloss, jgrads = _jax_run(weights, data, **POLICIES[policy])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    cfg = BertConfig.tiny(**KW)
    for n, g in params_from_jax(jax.tree.map(np.asarray, jgrads),
                                cfg).items():
        if n not in grads:            # the pooler: not in the MLM loss
            assert float(g.abs().max()) == 0.0, n
            continue
        err = float((grads[n] - g).abs().max())
        assert err <= TOL * max(float(g.abs().max()), 1e-6), (n, err)


@pytest.mark.parametrize("policy,calls", [
    ("nothing", 6), ("attn", 3), ("attn_out", 6), ("skip2", 4),
    ("everything", 3)])
def test_flash_forward_calls_per_step(policy, calls, weights, monkeypatch):
    """Forward calls of the flash op over one step of 3 layers: the
    recomputation reruns it unless the policy keeps both residuals (or
    the layer is not recomputed)."""
    count = [0]
    plain = A.flash_fwd_reference

    def counted(*args):
        count[0] += 1
        return plain(*args)
    monkeypatch.setattr(A, "flash_fwd_reference", counted)
    _port_run(weights, _batch(1), **POLICIES[policy])
    assert count[0] == calls


@pytest.mark.parametrize("policy", ["dots", "attn", "skip2"])
def test_policies_compose_with_o1(policy, weights):
    """Under ``o1_intercept(bfloat16)`` the recomputation reruns with
    the intercept on: gradients equal the O1 run without remat."""
    data = _batch(2)
    out = []
    for kw in (dict(remat_skip_every=1), POLICIES[policy]):
        with o1_intercept(torch.bfloat16):
            out.append(_port_run(weights, data, dtype=None, **kw))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n


@pytest.mark.parametrize("policy", [
    "dots_saveable", "save_only:attn_probs", "save_only:", "checkpoint_dots"])
def test_unknown_policy_raises_listing_the_accepted(policy):
    with pytest.raises(ValueError, match="nothing_saveable|attn_out"):
        GPTConfig.tiny(remat=True, remat_policy=policy)


def test_config_fields_of_the_jax_package():
    cfg = LlamaConfig.tiny(remat=True, remat_skip_every=3,
                           remat_policy="save_only:attn_lse,attn_out")
    assert cfg.remat_skip_every == 3
    with pytest.raises(ValueError, match="remat_skip_every"):
        LlamaConfig.tiny(remat_skip_every=-1)
