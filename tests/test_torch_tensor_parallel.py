"""The port's tensor parallelism on gloo ranks against the JAX package.

Each check spawns 2 or 4 CPU processes (``commons.run_on_ranks``; the
rank functions are in ``torch_parallel_workers.py``) and holds what
they return against the JAX function on the 8-device CPU mesh
(``shard_map`` over 2 devices), from the same numpy-seeded inputs:

- the seven mappings, forward and input gradients: bitwise;
- column → ReLU → row, plain and sequence-parallel, against the JAX
  shard_map functions and the dense product (1e-5 of the largest
  magnitude; the products add in another order);
- vocab-parallel embedding (bitwise) and cross entropy with its
  gradients, smoothing 0 and 0.1 (1e-6);
- ``model_parallel_rng_key``: the exact words of ``jax.random.fold_in``;
- a tiny GPT at tp = 2 with sequence parallelism, and at tp = 2 × dp = 2:
  the loss and the gathered gradients against the JAX GPT run on a mesh
  of the same shape (2e-5, fp32); with attention and hidden dropout on,
  tp = 2 against the unsharded port model (2e-5: the row layers' partial
  sums add in another order), whose masks are bitwise equal (checked
  without processes: the dropout lanes and the hidden mask's chunk);
  a tiny BERT (key padding, masked positions, dropout) at tp = 2 with
  sequence parallelism against the unsharded port BERT, likewise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_workers as W
from apex_tpu.core import mesh as jax_mesh
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel
from apex_tpu.models.gpt import gpt_loss_fn as j_gpt_loss
from apex_tpu.ops import softmax_cross_entropy
from apex_tpu.transformer import (
    column_parallel_linear,
    mappings as JM,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)
from apex_tpu_torch.models.jax_import import params_from_jax, shard_state_dict
from apex_tpu_torch.models.transformer import _dropout
from apex_tpu_torch.ops.attention import dropout_keep_mask
from apex_tpu_torch.transformer.testing.commons import run_on_ranks

TP = 2
MESH = Mesh(np.array(jax.devices()[:TP]), ("tensor",))


def _per_rank(fn, *stacked):
    """``fn`` on each of the 2 devices, its arguments the rows of the
    ``stacked`` inputs, its outputs stacked back: row ``r`` is rank
    ``r``'s."""
    def body(*a):
        outs = fn(*[t[0] for t in a])
        return jax.tree.map(lambda o: o[None], outs)
    f = jax.shard_map(body, mesh=MESH, in_specs=(P("tensor"),) * len(stacked),
                      out_specs=P("tensor"), check_vma=False)
    return jax.tree.map(np.asarray, f(*[jnp.asarray(s) for s in stacked]))


def _near(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _chunk(a, dim, r, n=TP):
    k = a.shape[dim] // n
    return np.take(a, np.arange(r * k, (r + 1) * k), axis=dim)


@pytest.fixture(scope="module")
def tp_data():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.normal(size=(8, 16)).astype(np.float32),
        w_out=rng.normal(size=(8, 16)).astype(np.float32),
        w1=rng.normal(size=(32, 16)).astype(np.float32),   # torch (out, in)
        w2=rng.normal(size=(16, 32)).astype(np.float32),
        table=rng.normal(size=(64, 8)).astype(np.float32),
        ids=rng.integers(0, 64, size=(4, 6)),
        logits=(rng.normal(size=(8, 64)) * 3).astype(np.float32),
        labels=rng.integers(0, 64, size=(8,)),
        seed=20)


@pytest.fixture(scope="module")
def tp_ranks(tp_data):
    return run_on_ranks(W.tensor_parallel_checks, TP, tp_data)


def _fwd_bwd(fn):
    def run(x, w):
        return fn(x), jax.grad(lambda t: jnp.sum(fn(t) * w))(x)
    return run


def test_mesh_bookkeeping(tp_ranks):
    assert [r["tp_size"] for r in tp_ranks] == [2, 2]
    assert [r["tp_rank"] for r in tp_ranks] == [0, 1]
    assert [r["dp_size"] for r in tp_ranks] == [1, 1]


@pytest.mark.parametrize("name", ["copy", "reduce", "scatter", "gather",
                                  "rs_seq", "gather_seq", "scatter_seq"])
def test_mappings_bitwise(tp_ranks, tp_data, name):
    x, w = tp_data["x"], tp_data["w_out"]
    per = {
        "copy": (JM.copy_to_tensor_parallel_region,
                 [x, x], [w, w]),
        "reduce": (JM.reduce_from_tensor_parallel_region,
                   [x * 1, x * 2], [w, w]),
        "scatter": (JM.scatter_to_tensor_parallel_region,
                    [x, x], [_chunk(w, 1, r) for r in range(TP)]),
        "gather": (JM.gather_from_tensor_parallel_region,
                   [_chunk(x, 1, r) for r in range(TP)], [w, w]),
        "rs_seq": (functools.partial(
            JM.reduce_scatter_to_sequence_parallel_region, dim=0),
            [x * 1, x * 2], [_chunk(w, 0, r) for r in range(TP)]),
        "gather_seq": (functools.partial(
            JM.gather_from_sequence_parallel_region, dim=0),
            [_chunk(x, 0, r) for r in range(TP)], [w, w]),
        "scatter_seq": (functools.partial(
            JM.scatter_to_sequence_parallel_region, dim=0),
            [x, x], [_chunk(w, 0, r) for r in range(TP)]),
    }[name]
    fn, xs, ws = per
    want_y, want_g = _per_rank(_fwd_bwd(fn), np.stack(xs), np.stack(ws))
    for r in range(TP):
        got_y, got_g = tp_ranks[r][name]
        np.testing.assert_array_equal(got_y, want_y[r])
        np.testing.assert_array_equal(got_g, want_g[r])


@pytest.mark.parametrize("sp", [0, 1])
def test_column_row_block(tp_ranks, tp_data, sp):
    x, w1, w2 = tp_data["x"], tp_data["w1"], tp_data["w2"]

    def block(xs, w1s, w2s):            # JAX kernels are (in, out)
        def loss(w1s, w2s):
            h = jax.nn.relu(column_parallel_linear(
                xs, w1s, sequence_parallel=bool(sp), seq_dim=0))
            y = row_parallel_linear(h, w2s, sequence_parallel=bool(sp),
                                    seq_dim=0)
            return jnp.sum(y ** 2), y
        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            w1s, w2s)
        return y, g[0], g[1]
    xs = [(_chunk(x, 0, r) if sp else x) for r in range(TP)]
    w1s = [_chunk(w1, 0, r).T for r in range(TP)]
    w2s = [_chunk(w2, 1, r).T for r in range(TP)]
    y, g1, g2 = _per_rank(block, np.stack(xs), np.stack(w1s), np.stack(w2s))
    dense = np.maximum(x @ w1.T, 0) @ w2.T
    for r in range(TP):
        got_y, got_g1, got_g2 = tp_ranks[r][f"col_row_sp{sp}"]
        # the products add in another order than XLA's: fp32 rounding,
        # 1e-5 of each tensor's largest magnitude
        _near(got_y, y[r])
        _near(got_g1, g1[r].T)
        _near(got_g2, g2[r].T)
        _near(got_y, _chunk(dense, 0, r) if sp else dense)


def test_vocab_parallel_embedding(tp_ranks, tp_data):
    table, ids = tp_data["table"], tp_data["ids"]
    want = _per_rank(lambda i, t: vocab_parallel_embedding(i, t),
                     np.stack([ids, ids]),
                     np.stack([_chunk(table, 0, r) for r in range(TP)]))
    for r in range(TP):
        np.testing.assert_array_equal(tp_ranks[r]["embedding"], want[r])
        np.testing.assert_array_equal(tp_ranks[r]["embedding"], table[ids])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy(tp_ranks, tp_data, smoothing):
    logits, labels = tp_data["logits"], tp_data["labels"]

    def ce(ls, t):
        nll = vocab_parallel_cross_entropy(ls, t, smoothing=smoothing)
        g = jax.grad(lambda ls: jnp.mean(vocab_parallel_cross_entropy(
            ls, t, smoothing=smoothing)))(ls)
        return nll, g
    nll, g = _per_rank(ce, np.stack([_chunk(logits, 1, r)
                                     for r in range(TP)]),
                       np.stack([labels, labels]))
    full = np.asarray(softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels), smoothing))
    for r in range(TP):
        got_nll, got_g = tp_ranks[r][f"xent_{smoothing}"]
        np.testing.assert_allclose(got_nll, nll[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_nll, full, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_g, g[r], rtol=1e-6, atol=1e-6)


def test_model_parallel_rng_key_words(tp_ranks, tp_data):
    key = jax.random.PRNGKey(tp_data["seed"])
    for r in range(TP):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, r))
                          if hasattr(jax.random, "key_data")
                          else jax.random.fold_in(key, r)).astype(np.int64)
        np.testing.assert_array_equal(tp_ranks[r]["key"], want)


# --------------------------------------------------------------------- #
# dropout: the sharded masks are the unsharded masks' parts
# --------------------------------------------------------------------- #
def test_attention_dropout_lanes_are_the_unsharded_lanes():
    b, h, s = 3, 8, 40
    whole = dropout_keep_mask(77, b, h, s, s, 0.2)
    for tp in (2, 4):
        hl = h // tp
        for r in range(tp):
            part = dropout_keep_mask(77, b, hl, s, s, 0.2,
                                     lanes=(h, r * hl))
            assert torch.equal(part, whole[:, r * hl:(r + 1) * hl])


def test_hidden_dropout_chunk_is_the_whole_masks_part():
    x = torch.randn(2, 12, 5)
    whole = _dropout(x, 0.3, 99)
    for r in range(3):
        part = _dropout(x[:, 4 * r:4 * r + 4], 0.3, 99, (r, 3))
        assert torch.equal(part, whole[:, 4 * r:4 * r + 4])


# --------------------------------------------------------------------- #
# the tiny GPT
# --------------------------------------------------------------------- #
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=32)


@pytest.fixture(scope="module")
def gpt_case():
    jcfg = JGPTConfig.tiny(**GPT_CFG)
    model = JGPTModel(jcfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, size=(4, 17))
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(ids[:, :-1]))[
        "params"]
    sd = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(params), jcfg).items()}
    return jcfg, model, params, sd, ids[:, :-1], ids[:, 1:]


def _jax_loss_grads(gpt_case, tp, dp):
    jcfg, model, params, _, ids, labels = gpt_case

    def loss_fn(p):
        return j_gpt_loss(model.apply({"params": p}, jnp.asarray(ids)),
                          jnp.asarray(labels))
    jax_mesh.initialize_mesh(tensor_model_parallel_size=tp,
                             data_parallel_size=dp,
                             devices=jax.devices()[:tp * dp])
    try:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        jax_mesh.destroy_mesh()
    return float(loss), {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(grads), jcfg).items()}


def _gathered(ranks, key, tp):
    """Whole gradients from the tensor ranks' shards (ranks ``0..tp-1``
    hold the tensor shards of data rank 0)."""
    out = {}
    for n in ranks[0][key]:
        parts = [ranks[r][key][n] for r in range(tp)]
        if parts[0] is None:            # a parameter the loss does not use
            out[n] = None
            continue
        # the dim shard_state_dict cuts: the one a probe of tp times the
        # part's shape comes back from with the part's size
        probe = shard_state_dict({n: torch.zeros(
            [tp * k for k in parts[0].shape])}, 0, tp)[n]
        cut = [i for i, (a, b) in enumerate(zip(probe.shape,
                                                parts[0].shape)) if a == b]
        out[n] = parts[0] if not cut else np.concatenate(parts, cut[0])
    return out


def _close(got, want, tol=2e-5):
    assert set(got) == set(want)
    for n in want:
        if want[n] is None or got[n] is None:
            assert got[n] is None and want[n] is None, n
            continue
        np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol,
                                   err_msg=n)


def test_gpt_tp2_sequence_parallel_matches_jax(gpt_case):
    _, _, _, sd, ids, labels = gpt_case
    ranks = run_on_ranks(W.gpt_tp_checks, 2, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG, dropout=True,
        bert=True), 2, True)
    loss, grads = _jax_loss_grads(gpt_case, 2, 1)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close(_gathered(ranks, "grads", 2), grads)
    # dropout on: the sharded run against the unsharded port model
    for r in ranks:
        np.testing.assert_allclose(r["drop_loss"], r["drop_loss_tp1"],
                                   rtol=2e-5)
        assert abs(float(r["drop_loss"]) - loss) > 1e-4   # dropout ran
    _close(_gathered(ranks, "drop_grads", 2), ranks[0]["drop_grads_tp1"])
    # BERT (key padding, masked positions, dropout) at tp = 2 with SP
    # against the unsharded port BERT, which test_torch_bert.py holds to
    # the JAX one
    for r in ranks:
        for k in ("logits", "pooled", "loss"):
            np.testing.assert_allclose(r["bert"][k], r["bert_tp1"][k],
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    _close(_gathered([{"g": r["bert"]["grads"]} for r in ranks], "g", 2),
           ranks[0]["bert_tp1"]["grads"])


def test_gpt_tp2_dp2_matches_jax(gpt_case):
    _, _, _, sd, ids, labels = gpt_case
    ranks = run_on_ranks(W.gpt_tp_checks, 4, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG), 2, False)
    loss, grads = _jax_loss_grads(gpt_case, 2, 2)
    assert [r["tp_rank"] for r in ranks] == [0, 1, 0, 1]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close(_gathered(ranks, "grads", 2), grads)
    _close(_gathered(ranks[2:], "grads", 2), grads)
