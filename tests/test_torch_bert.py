"""The port's BERT training path held against the JAX package's.

``BertConfig.tiny`` in fp32: the JAX model is initialised from a fixed
key, its parameters are carried over with ``params_from_jax`` (scanned
and unrolled layouts), and both run the same numpy-made batch on the
CPU — the port through its plain compositions, the JAX package through
its Pallas kernels in interpret mode.  Tolerances: logits and pooled
output within 1e-4 and gradients within 1e-4 relative to each tensor's
largest entry (fp32 sums in different orders through 2 layers); three
O0 train steps leave the parameters within 1e-5 (Adam's eps is 1e-5
there: Adam normalises the update, so with the default 1e-8 a gradient
entry at fp32 noise level, ~1e-8, moves its parameter by up to lr in
either framework's direction);
three O2 bf16 steps keep the loss within 0.05 of the JAX loss (bf16
rounds at different places in the two frameworks).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import bert_mlm_loss_fn as jax_bert_loss
from apex_tpu.optim import fused_adam as jax_fused_adam
from apex_tpu_torch import amp
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    bert_mlm_loss_fn,
    params_from_jax,
)
from apex_tpu_torch.optim import fused_adam

B, S, P = 2, 64, 8


def build(scan_layers=True, half=False, **kw):
    """(jax model, jax params, port model) with the same weights;
    ``half``: both compute in bf16."""
    jkw = dict(kw, dtype=jnp.bfloat16) if half else kw
    jm = JaxBertModel(JaxBertConfig.tiny(scan_layers=scan_layers, **jkw))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": variables["params"]}))
    cfg = BertConfig.tiny(**(dict(kw, dtype=torch.bfloat16) if half
                             else kw))
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jm, params, model


def batch(seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    types = rng.integers(0, 2, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    pos = np.stack([rng.permutation(S)[:P] for _ in range(B)]).astype(
        np.int32)
    labels = np.take_along_axis(ids, pos, axis=1)
    return ids, types, mask, pos, labels


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(port, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-6), err


@pytest.fixture(scope="module")
def unrolled():
    return build(scan_layers=False)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_logits_and_pooled_match_jax(scan_layers, masked):
    jm, params, model = build(scan_layers)
    ids, types, mask, pos, _ = batch()
    am = mask if masked else None
    for positions in (None, pos):
        jl, jp = jm.apply(params, jnp.asarray(ids),
                          token_type_ids=jnp.asarray(types),
                          attention_mask=None if am is None
                          else jnp.asarray(am),
                          mlm_positions=None if positions is None
                          else jnp.asarray(positions))
        tl, tp = model(_t(ids), token_type_ids=_t(types),
                       attention_mask=None if am is None else _t(am),
                       mlm_positions=None if positions is None
                       else _t(positions))
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-4, atol=1e-4)


def _jax_grads(jm, params, ids, types, mask, pos, labels):
    def loss_fn(p):
        logits, _ = jm.apply(p, jnp.asarray(ids),
                             token_type_ids=jnp.asarray(types),
                             attention_mask=jnp.asarray(mask),
                             mlm_positions=jnp.asarray(pos))
        return jax_bert_loss(logits.astype(jnp.float32),
                             jnp.asarray(labels))
    return jax.value_and_grad(loss_fn)(params)


def test_mlm_loss_gradients_match_jax_for_every_parameter(unrolled):
    jm, params, model = unrolled
    cfg = model.cfg
    ids, types, mask, pos, labels = batch(1)
    jloss, jgrads = _jax_grads(jm, params, ids, types, mask, pos, labels)
    logits, _ = model(_t(ids), token_type_ids=_t(types),
                      attention_mask=_t(mask), mlm_positions=_t(pos))
    loss = bert_mlm_loss_fn(logits.float(), _t(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    names = dict(model.named_parameters())
    assert set(ref) == set(names)
    for name, g in ref.items():
        p = names[name]
        if name.startswith("pooler"):          # the loss does not use it
            assert p.grad is None and float(g.abs().max()) == 0.0
            continue
        _rel_close(p.grad, g.numpy(), 1e-4)


def test_remat_gradients_equal_no_remat_with_dropout():
    torch.manual_seed(0)
    cfg = dict(hidden_dropout=0.1, attention_dropout=0.1)
    a = BertModel(BertConfig.tiny(**cfg), device="cpu")
    a.init_weights(torch.Generator().manual_seed(3))
    b = BertModel(BertConfig.tiny(remat=True, **cfg), device="cpu")
    b.load_state_dict(a.state_dict())
    ids, types, mask, pos, labels = batch(2)
    grads = []
    for model in (a, b):
        logits, _ = model(_t(ids), attention_mask=_t(mask),
                          mlm_positions=_t(pos), deterministic=False,
                          dropout_seed=1234)
        bert_mlm_loss_fn(logits.float(), _t(labels).long()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        if g is None:
            assert grads[1][n] is None
            continue
        assert torch.equal(g, grads[1][n]), n
    # the dropout is live: another seed gives another loss
    l1 = bert_mlm_loss_fn(a(_t(ids), mlm_positions=_t(pos),
                            deterministic=False, dropout_seed=1)[0],
                          _t(labels).long())
    l2 = bert_mlm_loss_fn(a(_t(ids), mlm_positions=_t(pos),
                            deterministic=False, dropout_seed=2)[0],
                          _t(labels).long())
    assert l1.item() != l2.item()
    with pytest.raises(ValueError, match="dropout_seed"):
        a(_t(ids), deterministic=False)


def _jax_train(jm, params, opt_level, half, steps, data, eps=1e-8):
    tx = jax_fused_adam(1e-3, eps=eps)
    state = jax_amp.initialize(jm.apply, params, tx, opt_level=opt_level,
                               half_dtype=half)
    ids, types, mask, pos, labels = (jnp.asarray(a) for a in data)

    def step(state):
        def loss_of(p):
            cp = state.policy.cast_to_compute(p)
            logits, _ = state.apply_fn(cp, ids, token_type_ids=types,
                                       attention_mask=mask,
                                       mlm_positions=pos)
            loss = jax_bert_loss(logits.astype(jnp.float32), labels)
            return state.scale_loss(loss), loss
        grads, loss = jax.grad(loss_of, has_aux=True)(state.params)
        state, finite = state.apply_gradients(grads=grads)
        return state, float(loss), bool(finite)
    losses = []
    for _ in range(steps):
        state, loss, finite = step(state)
        assert finite
        losses.append(loss)
    return state, losses


def _port_train(model, opt_level, half, steps, data, eps=1e-8):
    state = amp.initialize(model, fused_adam(1e-3, eps=eps), opt_level,
                           half_dtype=half)
    ids, types, mask, pos, labels = (_t(a) for a in data)
    losses = []
    for _ in range(steps):
        logits, _ = model(ids, token_type_ids=types, attention_mask=mask,
                          mlm_positions=pos)
        loss = bert_mlm_loss_fn(logits.float(), labels.long())
        state.scale_loss(loss).backward()
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    return state, losses


def test_o0_train_steps_match_jax(unrolled):
    jm, params, _ = unrolled
    _, _, model = build(scan_layers=False)
    data = batch(3)
    jstate, jlosses = _jax_train(jm, params, "O0", None, 3, data, 1e-5)
    state, losses = _port_train(model, "O0", None, 3, data, 1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          model.cfg)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_o2_bf16_loss_trajectory_within_band():
    jm, params, model = build(scan_layers=False, half=True)
    data = batch(4)
    jstate, jlosses = _jax_train(jm, params, "O2", jnp.bfloat16, 3, data)
    state, losses = _port_train(model, "O2", torch.bfloat16, 3, data)
    np.testing.assert_allclose(losses, jlosses, atol=0.05)
    assert losses[-1] < losses[0]
    # masters fp32, the forward's copy bf16 but for the norm params
    assert all(p.dtype == torch.float32 for p in state.params.values())
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("mixed", [False, True], ids=["all_zero", "mixed"])
def test_token_type_lookup_equals_embedding(mixed, ids_dtype):
    """The token-type lookup (fault C-12's repair): its rows are
    ``F.embedding``'s bit for bit and its table gradient, one product
    ``one_hot(ids)^T dy``, equals the embedding backward's within fp32
    rounding of another summation order."""
    from apex_tpu_torch.models.bert import _TypeRows

    rng = np.random.default_rng(12)
    ids = rng.integers(0, 2, (4, 33)) if mixed else np.zeros((4, 33))
    ids = torch.from_numpy(ids).to(ids_dtype)
    table = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(4, 33, 24)).astype(np.float32))
    t1, t2 = table.clone().requires_grad_(), table.clone().requires_grad_()
    got = _TypeRows.apply(ids, t1)
    ref = torch.nn.functional.embedding(ids, t2)
    assert torch.equal(got, ref)
    got.backward(dy)
    ref.backward(dy)
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-6, atol=1e-6)
