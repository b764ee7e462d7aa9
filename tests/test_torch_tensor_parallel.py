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
from apex_tpu.models.gpt import moe_aux_loss as j_moe_aux_loss
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
        seed=20,
        mha_q=rng.normal(size=(2, 16, 64)).astype(np.float32),
        mha_kv=rng.normal(size=(2, 12, 64)).astype(np.float32),
        mha_w=rng.normal(size=(2, 16, 64)).astype(np.float32))


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


@pytest.mark.parametrize("name", ["self", "encdec"])
def test_multihead_attn_on_a_tp2_mesh_equals_the_call_without_one(
        tp_ranks, name):
    # C-14: whole projections (not split over the tensor group), as the
    # JAX modules' Dense weights: the same ops as without a mesh, bitwise
    for r in range(TP):
        got, want = (tp_ranks[r]["mha"][f"{name}_{t}"]
                     for t in ("mesh", "whole"))
        np.testing.assert_array_equal(got["y"], want["y"])
        for a, b in zip(got["dx"], want["dx"]):
            np.testing.assert_array_equal(a, b)
        assert set(got["grads"]) == set(want["grads"])
        for n in want["grads"]:
            np.testing.assert_array_equal(got["grads"][n], want["grads"][n],
                                          err_msg=n)


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


@pytest.fixture(scope="module")
def gpt_tp2(gpt_case, moe_case, pipe_case):
    """The 2-rank spawn: the tiny GPT at tp 2 with SP (dropout, BERT,
    the MoE configs), then the pipe-2 checks on a pipe mesh."""
    _, _, _, sd, ids, labels = gpt_case
    return run_on_ranks(W.gpt_tp_checks, 2, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG, dropout=True,
        bert=True, moe={cf: moe_case[1] for cf in MOE_CFS},
        pipe=pipe_case[2]), 2, True)


@pytest.fixture(scope="module")
def gpt_tp2_dp2(gpt_case, pipe_case):
    """The 4-rank spawn: the tiny GPT at tp 2 x dp 2, then the pipe-4
    schedules, the GPT closure at pipe 2 x tensor 2 and the ZeRO-2
    step at pipe 2 x data 2."""
    _, _, _, sd, ids, labels = gpt_case
    return run_on_ranks(W.gpt_tp_checks, 4, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG, pipe=pipe_case[4]),
        2, False)


def test_gpt_tp2_sequence_parallel_matches_jax(gpt_case, gpt_tp2):
    _, _, _, sd, ids, labels = gpt_case
    ranks = gpt_tp2
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


def test_gpt_tp2_dp2_matches_jax(gpt_case, gpt_tp2_dp2):
    ranks = gpt_tp2_dp2
    loss, grads = _jax_loss_grads(gpt_case, 2, 2)
    assert [r["tp_rank"] for r in ranks] == [0, 1, 0, 1]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
    _close(_gathered(ranks, "grads", 2), grads)
    _close(_gathered(ranks[2:], "grads", 2), grads)


# --------------------------------------------------------------------- #
# C-13: MoE layers at tp 2 with sequence parallelism
# --------------------------------------------------------------------- #
MOE_CFS = (4.0, 1.25)


@pytest.fixture(scope="module")
def moe_case(gpt_case):
    """The tiny GPT with MoE layers (4 experts, top 2), its whole
    weights as a port state dict."""
    _, _, _, _, ids, _ = gpt_case
    jcfg = JGPTConfig.tiny(**GPT_CFG, num_moe_experts=4, moe_top_k=2,
                           sequence_parallel=True)
    params = JGPTModel(jcfg).init(jax.random.PRNGKey(11),
                                  jnp.asarray(ids))["params"]
    sd = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(params), jcfg).items()}
    return params, sd


def _jax_moe_loss_grads(gpt_case, moe_case, cf):
    """CE, aux term and gradients of the JAX MoE GPT on a tp 2 mesh with
    sequence parallelism."""
    _, _, _, _, ids, labels = gpt_case
    jcfg = JGPTConfig.tiny(**GPT_CFG, num_moe_experts=4, moe_top_k=2,
                           moe_capacity_factor=cf, sequence_parallel=True)
    model = JGPTModel(jcfg)

    def loss_fn(p):
        logits, mut = model.apply({"params": p}, jnp.asarray(ids),
                                  mutable=["losses"])
        ce = j_gpt_loss(logits, jnp.asarray(labels))
        aux = j_moe_aux_loss(mut)
        return ce + aux, (ce, aux)
    jax_mesh.initialize_mesh(tensor_model_parallel_size=2,
                             devices=jax.devices()[:2])
    try:
        (_, (ce, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(moe_case[0])
    finally:
        jax_mesh.destroy_mesh()
    return float(ce), float(aux), {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(grads), jcfg).items()}


@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_gpt_tp2_sequence_parallel_matches_unsharded_and_jax(
        gpt_case, moe_case, gpt_tp2, cf):
    ce, aux, grads = _jax_moe_loss_grads(gpt_case, moe_case, cf)
    ranks = [r[f"moe_{cf}"] for r in gpt_tp2]
    whole = ranks[0]["whole"]
    # fp32, 2e-5: the loss, the aux term and every gradient, MoE ones
    # included, against the unsharded port model and the JAX GPT
    for r in ranks:
        for k in ("loss", "aux"):
            np.testing.assert_allclose(r[k], whole[k], rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(r["loss"], ce, rtol=2e-5)
        np.testing.assert_allclose(r["aux"], aux, rtol=2e-5)
    got = _gathered(ranks, "grads", 2)
    assert any(".moe_mlp." in n for n in got)
    _close(got, whole["grads"])
    _close(got, grads)


# --------------------------------------------------------------------- #
# pipeline parallelism (the spawns above, on a pipe mesh)
# --------------------------------------------------------------------- #
HID, MB, SEQ = 16, 2, 4
PIPE_MS = {2: (2, 5), 4: (4, 9)}       # M = pp and 2·pp + 1
GPT_PIPE = dict(vocab_size=128, hidden_size=64, num_heads=4, max_seq_len=16,
                position_embedding="learned")
GPT_PIPE_LAYERS, GPT_PIPE_M = 4, 4


def _toy_stage(params, x):
    w1, b1, w2 = params
    return x + jnp.tanh(x @ w1 + b1) @ w2


def _toy_stack(rng, *lead):
    return [(rng.normal(size=lead + s) * sc).astype(np.float32)
            for s, sc in (((HID, HID), 0.3), ((HID,), 0.1), ((HID, HID), 0.3))]


def _pipe_mesh(pp):
    return Mesh(np.array(jax.devices()[:pp]), ("pipe",))


@pytest.fixture(scope="module")
def pipe_case():
    """Inputs of the pipe checks, per spawn size: the toy stacks and
    batch, the GPT closure's JAX stack and closure parameters, the ZeRO
    step's layers and data."""
    from apex_tpu.models import ParallelTransformerLayer as JLayer
    from apex_tpu.models import TransformerConfig as JTCfg
    from apex_tpu.transformer.pipeline_parallel import build_model as jbuild

    rng = np.random.default_rng(21)
    batch = rng.normal(size=(2 * 4 * MB + MB, SEQ, HID)).astype(np.float32)
    jcfg = JTCfg(num_layers=1, causal=True, dtype=jnp.float32,
                 **GPT_PIPE)
    s = GPT_PIPE["max_seq_len"]
    _, stacked, _ = jbuild(
        JLayer(jcfg), GPT_PIPE_LAYERS, 2, rng=jax.random.PRNGKey(4),
        sample_input=jnp.zeros((1, s, GPT_PIPE["hidden_size"])))
    h, v = GPT_PIPE["hidden_size"], GPT_PIPE["vocab_size"]
    closure = dict(
        embed=(rng.normal(size=(v, h)) * 0.5).astype(np.float32),
        pos=(rng.normal(size=(s, h)) * 0.1).astype(np.float32),
        head=(rng.normal(size=(h, v)) * 0.2).astype(np.float32),
        fln_scale=(1 + 0.1 * rng.normal(size=(h,))).astype(np.float32),
        fln_bias=(0.1 * rng.normal(size=(h,))).astype(np.float32))
    tokens = rng.integers(0, v, size=(GPT_PIPE_M * 2, s + 1))
    gpt = dict(cfg=GPT_PIPE, layers=GPT_PIPE_LAYERS, m=GPT_PIPE_M,
               stacked=jax.tree.map(np.asarray, jax.device_get(stacked)),
               closure=closure, ids=tokens[:, :-1], labels=tokens[:, 1:])
    zr = np.random.default_rng(8)
    zero = dict(params=_toy_stack(zr, 4),
                x=zr.normal(size=(2 * 4, MB, HID)).astype(np.float32),
                y=zr.normal(size=(2 * 4, MB, HID)).astype(np.float32))
    return {2: dict(toy=_toy_stack(rng, 2), toy_v=_toy_stack(rng, 2, 2),
                    toy_batch=batch, mb=MB, ms=PIPE_MS[2], gpt=gpt),
            4: dict(toy=_toy_stack(rng, 4), toy_batch=batch, mb=MB,
                    ms=PIPE_MS[4], gpt=gpt, tp=True, zero=zero)}


def _pipe_ranks(pp, gpt_tp2, gpt_tp2_dp2):
    return [r["pipe"] for r in (gpt_tp2 if pp == 2 else gpt_tp2_dp2)]


def _jax_1f1b(schedule, stacked, batch, m, pp):
    loss, grads = jax.jit(lambda p, b: schedule(
        _toy_stage, lambda y, i: jnp.mean(y ** 2), p, b,
        mesh=_pipe_mesh(pp), num_microbatches=m))(
            tuple(jnp.asarray(a) for a in stacked), jnp.asarray(batch))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("pp,m", [(pp, m) for pp in PIPE_MS
                                  for m in PIPE_MS[pp]])
def test_1f1b_matches_the_jax_schedule(pipe_case, gpt_tp2, gpt_tp2_dp2, pp,
                                     m):
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as jsched)

    case = pipe_case[pp]
    loss, grads = _jax_1f1b(jsched, case["toy"],
                            case["toy_batch"][:m * MB], m, pp)
    # fp32; loss 1e-6, gradients 2e-5 of their largest magnitude (the
    # stage products add in another order than XLA's)
    for r, got in enumerate(_pipe_ranks(pp, gpt_tp2, gpt_tp2_dp2)):
        np.testing.assert_allclose(got[f"1f1b_{m}"]["loss"], loss,
                                   rtol=1e-6)
        for g, w in zip(got[f"1f1b_{m}"]["grads"], grads):
            _near(g, w[r], 2e-5)


@pytest.mark.parametrize("pp", sorted(PIPE_MS))
def test_1f1b_live_microbatches_stay_within_pp(gpt_tp2, gpt_tp2_dp2, pp):
    # the 1F1B memory shape: at most pp - rank microbatch graphs held at
    # once, the same at M = pp and 2·pp + 1
    for r, got in enumerate(_pipe_ranks(pp, gpt_tp2, gpt_tp2_dp2)):
        peaks = [got[f"1f1b_{m}"]["peak"] for m in PIPE_MS[pp]]
        assert peaks == [pp - r] * len(peaks), (r, peaks)


def test_interleaved_pp2_v2_matches_the_jax_schedule(pipe_case, gpt_tp2):
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving as jsched)

    case, m = pipe_case[2], 4
    loss, grads = _jax_1f1b(jsched, case["toy_v"],
                            case["toy_batch"][:m * MB], m, 2)
    for r, got in enumerate(_pipe_ranks(2, gpt_tp2, None)):
        np.testing.assert_allclose(got["interleaved"]["loss"], loss,
                                   rtol=1e-6)
        for c in range(2):
            for g, w in zip(got["interleaved"]["grads"][c], grads):
                _near(g, w[c, r], 2e-5)


@pytest.mark.parametrize("interleaved", [False, True])
def test_spmd_pipeline_forward_and_autograd_match_jax(pipe_case, gpt_tp2,
                                                      interleaved):
    from apex_tpu.transformer.pipeline_parallel import (
        spmd_pipeline,
        spmd_pipeline_interleaved,
    )

    case = pipe_case[2]
    m, key, spec = ((4, "toy_v", P(None, "pipe")) if interleaved
                    else (3, "toy", P("pipe")))
    fn = spmd_pipeline_interleaved if interleaved else spmd_pipeline
    mbs = jnp.asarray(case["toy_batch"][:m * MB].reshape(m, MB, SEQ, HID))
    run = jax.shard_map(lambda p, x: fn(_toy_stage, p, x),
                        mesh=_pipe_mesh(2), in_specs=(spec, P()),
                        out_specs=P(), axis_names={"pipe"})
    stacked = tuple(jnp.asarray(a) for a in case[key])

    def loss(p):
        outs = run(p, mbs)
        return jnp.mean(outs ** 2), outs
    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        stacked)
    # the outputs 1e-6 and the gradients 2e-5 of their largest magnitude
    for r, got in enumerate(_pipe_ranks(2, gpt_tp2, None)):
        got = got["spmd_interleaved" if interleaved else "spmd"]
        _near(got["outs"], outs, 1e-6)
        rows = ([[np.asarray(w)[c, r] for w in grads] for c in range(2)]
                if interleaved else [[np.asarray(w)[r] for w in grads]])
        for g_chunk, w_chunk in zip(got["grads"] if interleaved
                                    else [got["grads"]], rows):
            for g, w in zip(g_chunk, w_chunk):
                _near(g, w, 2e-5)


def test_sync_grad_overflow_skips_on_every_rank(gpt_tp2):
    # rank 1's inf turns every rank's gradients NaN; finite ones pass
    for r, got in enumerate(_pipe_ranks(2, gpt_tp2, None)):
        np.testing.assert_array_equal(got["overflow"]["finite"],
                                      np.arange(4.0) + r)
        assert np.isnan(got["overflow"]["poisoned"]).all()


def test_p2p_send_and_recv_move_the_sent_values(gpt_tp2):
    # pipe 2, gloo: rank 0's activation reaches rank 1 and rank 1's
    # gradient rank 0, bit for bit; the ends without a neighbour get
    # None; a receive with no device named wants CUDA, and raises here
    first, last = (got["p2p"] for got in _pipe_ranks(2, gpt_tp2, None))
    np.testing.assert_array_equal(last["recv_forward"], W.P2P_ACT.numpy())
    np.testing.assert_array_equal(first["recv_backward"],
                                  W.P2P_GRAD.numpy())
    assert first["recv_forward"] is None and last["recv_backward"] is None
    assert first["default_device_raises"] and last["default_device_raises"]


def test_broadcast_data_hands_every_tensor_rank_the_first_ones_batch(
        gpt_tp2, gpt_tp2_dp2):
    # tensor groups {0, 1} at tp 2, and {0, 1}, {2, 3} at tp 2 x dp 2:
    # every rank ends with its group's first rank's batch, exactly
    for ranks in (gpt_tp2, gpt_tp2_dp2):
        for r, got in enumerate(ranks):
            want = W._broadcast_data_of(r - r % 2)
            assert set(got["broadcast"]) == {"text", "mask"}
            for k in want:
                np.testing.assert_array_equal(got["broadcast"][k],
                                              want[k].numpy(), err_msg=k)


def _jax_gpt_closure(case):
    """The JAX 1F1B schedule with the embedding / head closure of
    ``bench_configs.bench_gpt2_3d_full_step`` (fp32, pipe 2): loss,
    stage gradients and closure gradients."""
    from apex_tpu.models import ParallelTransformerLayer as JLayer
    from apex_tpu.models import TransformerConfig as JTCfg
    from apex_tpu.transformer.pipeline_parallel import (
        build_model as jbuild,
        forward_backward_pipelining_without_interleaving as jsched,
    )

    g = case["gpt"]
    m, s = g["m"], GPT_PIPE["max_seq_len"]
    jcfg = JTCfg(num_layers=1, causal=True, dtype=jnp.float32, **GPT_PIPE)
    stage_fn, _, _ = jbuild(JLayer(jcfg), g["layers"], 2,
                            rng=jax.random.PRNGKey(4),
                            sample_input=jnp.zeros((1, s, jcfg.hidden_size)))
    ids, labels = jnp.asarray(g["ids"]), jnp.asarray(g["labels"])
    lab_mb = labels.reshape(m, -1, s)
    mesh = jax_mesh.initialize_mesh(pipeline_model_parallel_size=2,
                                    devices=jax.devices()[:2])

    def loss_fn(lp, y, i):
        hd, sc, bi = lp
        mu = jnp.mean(y, axis=-1, keepdims=True)
        var = jnp.var(y, axis=-1, keepdims=True)
        yn = (y - mu) * jax.lax.rsqrt(var + 1e-5) * sc + bi
        logp = jax.nn.log_softmax(yn @ hd)
        lab = jax.lax.dynamic_index_in_dim(lab_mb, i, 0, keepdims=False)
        return -jnp.mean(jnp.take_along_axis(logp, lab[..., None], -1))

    def step(stacked, cl):
        h = jnp.take(cl["embed"], ids, axis=0) + cl["pos"][None]
        loss, sg, aux = jsched(
            stage_fn, loss_fn, stacked, h, mesh=mesh, num_microbatches=m,
            loss_params=(cl["head"], cl["fln_scale"], cl["fln_bias"]),
            return_input_cotangents=True, distribute_inputs=False)
        cts = aux["input_cotangents"].reshape(h.shape)
        dh, ds, db = aux["loss_params_grads"]
        return loss, sg, dict(embed=jnp.zeros_like(cl["embed"]).at[ids].add(
            cts), pos=cts.sum(0), head=dh, fln_scale=ds, fln_bias=db)
    try:
        with jax.set_mesh(mesh):
            loss, sg, cg = jax.jit(step)(g["stacked"], g["closure"])
    finally:
        jax_mesh.destroy_mesh()
    return float(loss), jax.device_get(sg), jax.device_get(cg)


@pytest.fixture(scope="module")
def jax_gpt_closure(pipe_case):
    return _jax_gpt_closure(pipe_case[2])


@pytest.mark.parametrize("tp", [1, 2])
def test_gpt_closure_pipeline_matches_jax(jax_gpt_closure, gpt_tp2,
                                          gpt_tp2_dp2, tp):
    from apex_tpu_torch.models.jax_import import (
        closure_params_from_jax,
        stage_params_from_jax,
    )

    loss, sg, cg = jax_gpt_closure
    ranks = [r["pipe"]["gpt"] for r in (gpt_tp2 if tp == 1
                                       else gpt_tp2_dp2)]
    # fp32, 2e-5 (the tiny GPT's tolerance above): the loss, each rank's stage
    # gradients (its tensor shard at tp 2) and the closure's gradients
    # through the input cotangents and loss_params
    for got in ranks:
        stage, tp_rank = got["coords"]
        np.testing.assert_allclose(got["loss"], loss, rtol=2e-5)
        want = {k: v.numpy() for k, v in stage_params_from_jax(
            sg, stage=stage, tp_rank=tp_rank, tp=tp).items()}
        _close(got["stage"], want)
        want = {k: v.numpy() for k, v in closure_params_from_jax(
            cg, tp_rank=tp_rank, tp=tp).items()}
        _close(got["closure"], want)


def _jax_zero_pipeline(case):
    """Two steps of the JAX ``wrap_pipeline_step`` at data 2 x pipe 2
    with stage-local ZeRO-2 FusedAdam (``tests/test_pipeline.py``'s
    composed step): the losses and the staged parameters after."""
    from apex_tpu import amp
    from apex_tpu.optim import fused_adam
    from apex_tpu.parallel import ZeroConfig
    from apex_tpu.parallel import pipeline as pl

    z = case["zero"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    staged = {"stages": pl.stage_split(
        tuple(jnp.asarray(a) for a in z["params"]), 2)}
    state = amp.initialize(None, staged, fused_adam(1e-2), opt_level="O0",
                           zero=ZeroConfig(axis="data", axis_size=2, stage=2))
    state = pl.stage_local_zero(state, num_stages=2)
    state = jax.device_put(state,
                           pl.pipeline_state_shardings(state, mesh=mesh))

    def layers(x, p):
        w1, b1, w2 = p
        return x + jnp.tanh(x @ w1 + b1) @ w2, None

    def body(state, mbs, labels):
        def loss_fn(out, i):
            yl = jax.lax.dynamic_index_in_dim(labels, i, 0, keepdims=False)
            return jnp.mean((out - yl) ** 2)
        loss, grads = pl.run_1f1b(
            lambda p, x: jax.lax.scan(layers, x, p)[0], loss_fn,
            state.params["stages"], mbs)
        grads = pl.sync_grad_overflow({"stages": grads})
        new_state, _ = state.apply_gradients(grads=grads)
        return new_state, jax.lax.pmean(loss, "data")

    step = pl.wrap_pipeline_step(body, state=state, mesh=mesh,
                                 batch_specs=(P("data"), P("data")))
    losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(z["x"]), jnp.asarray(z["y"]))
        losses.append(float(loss))
    return losses, [np.asarray(a) for a in
                    jax.device_get(state.params["stages"])]


def test_wrap_pipeline_step_zero2_matches_jax(pipe_case, gpt_tp2_dp2):
    losses, staged = _jax_zero_pipeline(pipe_case[4])
    # two steps of FusedAdam at lr 1e-2 over pipe 2 x data 2: losses
    # 1e-5, parameters 2e-6 (the JAX composed step's own tolerances)
    for got in (r["pipe"]["zero"] for r in gpt_tp2_dp2):
        np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
        for g, w in zip(got["params"], staged):
            np.testing.assert_allclose(g, w[got["stage"]], rtol=0,
                                       atol=2e-6)
        lay = got["layout"]
        assert (lay["num_stages"], lay["num_shards"]) == (2, 2)
        assert lay["stage"] == got["stage"]
