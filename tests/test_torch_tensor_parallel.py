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
  sequence parallelism against the unsharded port BERT, likewise;
- the MoE GPT at tp = 2 with its experts over the tensor axis (with and
  without SP), and an MoE layer at tp = 2 × dp = 2 with its experts over
  the data axis (the token all-to-all; DDP and a ZeRO-2 step), against
  the unsharded layer and the JAX ones (2e-5);
- tensor-parallel paged serving at tp = 2: the sharded paged op against
  the unsharded one (bitwise), the engine and ``InferenceServer(tp=2)``
  against JAX ``generate()`` and the single-chip engine (tokens);
- ring attention and Ulysses on context meshes of 2, 4 and 2 × data 2
  against JAX (1e-5 of the largest magnitude; dropout masks bit for
  bit).
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
def gpt_tp2(gpt_case, moe_case, pipe_case, serve_case, cp_case):
    """The 2-rank spawn: the tiny GPT at tp 2 with SP (dropout, BERT,
    the MoE configs with the experts sharded over the tensor axis, with
    and without SP), tensor-parallel paged serving, then the pipe-2
    checks on a pipe mesh and ring / Ulysses on a context mesh of 2."""
    _, _, _, sd, ids, labels = gpt_case
    return run_on_ranks(W.gpt_tp_checks, 2, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG, dropout=True,
        bert=True, moe={cf: moe_case[1] for cf in MOE_CFS},
        moe_nosp=moe_case[1], serve=serve_case, pipe=pipe_case[2],
        cp=cp_case), 2, True)


@pytest.fixture(scope="module")
def gpt_tp2_dp2(gpt_case, moe_case, pipe_case, moe_data_case, cp_case):
    """The 4-rank spawn: the tiny GPT at tp 2 x dp 2, an MoE layer and
    the MoE GPT at tp 2 + SP with their experts over the data axis, then
    the pipe-4 schedules, the GPT closure at pipe 2 x tensor 2 and the
    ZeRO-2 step at pipe 2 x data 2, and ring / Ulysses on context meshes
    of 4 and 2 x data 2."""
    _, _, _, sd, ids, labels = gpt_case
    return run_on_ranks(W.gpt_tp_checks, 4, dict(
        sd=sd, ids=ids, labels=labels, cfg=GPT_CFG, pipe=pipe_case[4],
        moe_data=moe_data_case[0], moe_sp_data=moe_case[1], cp=cp_case),
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


def _jax_moe_loss_grads(gpt_case, moe_case, cf, sp=True):
    """CE, aux term and gradients of the JAX MoE GPT on a tp 2 mesh
    (with sequence parallelism under ``sp``)."""
    _, _, _, _, ids, labels = gpt_case
    jcfg = JGPTConfig.tiny(**GPT_CFG, num_moe_experts=4, moe_top_k=2,
                           moe_capacity_factor=cf, sequence_parallel=sp)
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


def test_moe_gpt_tp2_experts_over_the_tensor_axis_without_sp(
        gpt_case, moe_case, gpt_tp2):
    """Each tensor rank holds 2 of the 4 experts (cut on E by
    shard_state_dict), dispatches to them and all-reduces its part: the
    loss, aux and gathered gradients equal the unsharded port model's
    and the JAX GPT's on its tp 2 mesh."""
    ce, aux, grads = _jax_moe_loss_grads(gpt_case, moe_case, 4.0, sp=False)
    ranks = [r["moe_nosp"] for r in gpt_tp2]
    whole = ranks[0]["whole"]
    for r in ranks:
        for k, want in (("loss", ce), ("aux", aux)):
            np.testing.assert_allclose(r[k], whole[k], rtol=2e-5, err_msg=k)
            np.testing.assert_allclose(r[k], want, rtol=2e-5, err_msg=k)
    w1 = "transformer.layers.0.moe_mlp.w1"
    assert ranks[0]["grads"][w1].shape[0] == 2       # half the experts
    got = _gathered(ranks, "grads", 2)
    _close(got, whole["grads"])
    _close(got, grads)


def test_moe_gpt_tp2_sp_experts_over_the_data_axis(gpt_case, moe_case,
                                                   gpt_tp2_dp2):
    """The MoE GPT at tp 2 + SP with ``moe_expert_axis="data"`` on tp 2
    x dp 2: each data rank holds 2 of the 4 experts (whole on its tensor
    ranks) and its 2 batch rows; the layer gathers the sequence, runs the
    token all-to-all over data and cuts its output back to the chunk.
    The data mean of the loss and aux term, and the gradients averaged by
    ``DistributedDataParallel.mean_grads`` without ``params=`` (the
    experts found by their ``.grad`` and left out of the all-reduce),
    equal the unsharded port model's on the whole batch and the JAX
    GPT's on its tp 2 mesh; ``all_reduce_mean_grads`` without the
    parameters refuses."""
    ce, aux, grads = _jax_moe_loss_grads(gpt_case, moe_case, 1.25)
    ranks = [r["moe_sp_data"] for r in gpt_tp2_dp2]
    whole = ranks[0]["whole"]
    for k, want in (("loss", ce), ("aux", aux)):
        mean = (float(ranks[0][k]) + float(ranks[2][k])) / 2
        np.testing.assert_allclose(mean, float(whole[k]), rtol=2e-5,
                                   err_msg=k)
        np.testing.assert_allclose(mean, want, rtol=2e-5, err_msg=k)
    for r in ranks:
        assert "sharded over ['data']" in r["refused"]
    experts = [n for n, a in ranks[0]["axes"].items() if a == "data"]
    assert len(experts) == 4 * 2            # w1, w2, b1, b2 of 2 layers
    for pair in (ranks[:2], ranks[2:]):     # the tensor ranks of a data rank
        got = _gathered(pair, "grads", 2)
        for n in experts:
            np.testing.assert_array_equal(pair[0]["grads"][n],
                                          pair[1]["grads"][n])
            got[n] = np.concatenate([ranks[0]["grads"][n],
                                     ranks[2]["grads"][n]])
        _close(got, whole["grads"])
        _close(got, grads)


# --------------------------------------------------------------------- #
# the expert axis over data: an MoE layer at tp 2 x dp 2
# --------------------------------------------------------------------- #
MOE_LAYER = dict(num_experts=4, top_k=2, capacity_factor=1.25,
                 hidden_size=16, ffn_hidden_size=32, gated=True,
                 activation="silu")


@pytest.fixture(scope="module")
def moe_data_case():
    """The layer's whole JAX parameters, a batch of 4 rows (2 a data
    rank) and the loss weights; the JAX layer's output, aux and the
    gradients of ``sum(y * w) / 2 + aux`` on a data 2 x tensor 2 mesh
    with ``expert_axis="data"`` and without a mesh."""
    from apex_tpu.transformer.moe import MoEConfig as JMoEConfig
    from apex_tpu.transformer.moe import MoEMLP as JMoEMLP

    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 6, 16)).astype(np.float32)
    w = rng.normal(size=(4, 6, 16)).astype(np.float32)
    out = {}
    for tag, axis in (("mesh", "data"), ("whole", None)):
        layer = JMoEMLP(JMoEConfig(**MOE_LAYER, expert_axis=axis))
        if tag == "mesh":
            params = jax.tree.map(
                lambda a: a.unbox() if hasattr(a, "unbox") else a,
                layer.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"],
                is_leaf=lambda a: hasattr(a, "unbox"))
            params = {k: np.asarray(v) * (3.0 if k == "gate" else 1.0)
                      for k, v in params.items()}
            params["b1"] = rng.normal(size=params["b1"].shape).astype(
                np.float32) * 0.1
            params["b2"] = rng.normal(size=params["b2"].shape).astype(
                np.float32) * 0.1

        def loss_fn(p, layer=layer):
            y, aux = layer.apply({"params": p}, jnp.asarray(x))
            return jnp.sum(y * w) / 2 + aux, (y, aux)
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        args = params
        if tag == "mesh":
            m = jax_mesh.initialize_mesh(tensor_model_parallel_size=2,
                                         data_parallel_size=2,
                                         devices=jax.devices()[:4])
            # the experts placed on their data rank, as the layer's
            # partitioning names them
            args = {k: jax.device_put(v, jax.sharding.NamedSharding(
                m, P() if k == "gate" else P("data")))
                for k, v in params.items()}
        try:
            (_, (y, aux)), g = fn(args)
        finally:
            jax_mesh.destroy_mesh()
        out[tag] = dict(y=np.asarray(y), aux=float(aux),
                        grads={k: np.asarray(v) for k, v in g.items()})
    return dict(cfg=MOE_LAYER, params=params, x=x, w=w), out


def test_moe_layer_experts_over_the_data_axis(moe_data_case, gpt_tp2_dp2):
    """Each data rank holds 2 of the 4 experts and its 2 batch rows; the
    token all-to-all runs the slots on their owners.  The output, the
    mean aux term and the mean-over-data gradients (the experts left out
    of the DDP all-reduce) equal the unsharded layer's and the JAX
    layer's on a mesh of the same shape."""
    _, jax_out = moe_data_case
    # the JAX layer on its mesh is its own unsharded result
    for k in ("y",):
        _near(jax_out["mesh"][k], jax_out["whole"][k])
    np.testing.assert_allclose(jax_out["mesh"]["aux"],
                               jax_out["whole"]["aux"], rtol=2e-5)
    _close(jax_out["mesh"]["grads"], jax_out["whole"]["grads"])
    ranks = [r["moe_data"] for r in gpt_tp2_dp2]
    assert [r["ep"] for r in ranks] == [(2, 0), (2, 0), (2, 1), (2, 1)]
    assert ranks[0]["axes"] == [None] + ["data"] * 5
    y = np.concatenate([ranks[0]["y"], ranks[2]["y"]])
    whole = ranks[0]["whole"]
    np.testing.assert_allclose(y, whole["y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, jax_out["whole"]["y"], rtol=2e-5,
                               atol=2e-5)
    aux = (float(ranks[0]["aux"]) + float(ranks[2]["aux"])) / 2
    for want in (float(whole["aux"]), jax_out["whole"]["aux"]):
        np.testing.assert_allclose(aux, want, rtol=2e-5)
    got = {n: (g if n == "gate" else np.concatenate(
        [g, ranks[2]["grads"][n]])) for n, g in ranks[0]["grads"].items()}
    for r in ranks[1:]:          # the gate is replicated and equal
        np.testing.assert_array_equal(r["grads"]["gate"], got["gate"])
    _close(got, {k: np.asarray(v) for k, v in whole["grads"].items()})
    _close(got, jax_out["whole"]["grads"])
    # ZeRO-2 over data keeps the experts out of its shards: one FusedAdam
    # step gives the unsharded layer's plain step
    zero = {n: (p if n == "gate" else np.concatenate(
        [p, ranks[2]["zero_params"][n]]))
        for n, p in ranks[0]["zero_params"].items()}
    _close(zero, {k: np.asarray(v) for k, v in whole["params"].items()},
           tol=1e-6)


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


# --------------------------------------------------------------------- #
# context parallelism: ring attention and Ulysses on gloo context meshes
# --------------------------------------------------------------------- #
CP_RATE, CP_SEED = 0.1, 77


def _jax_cp_mesh(cp, dp):
    return jax_mesh.initialize_mesh(context_parallel_size=cp,
                                    data_parallel_size=dp,
                                    devices=jax.devices()[:cp * dp])


def _jax_out_grads(fn, q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * w)
    o = fn(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.fixture(scope="module")
def cp_case():
    """Whole q / k / v (b 2, S 16, h 4, hk 2, d 8) and loss weights, and
    the JAX references: ``ring_self_attention`` / ``ulysses_self_attention``
    on ``initialize_mesh(context_parallel_size=4, data_parallel_size=2)``
    (as tests/test_ring_attention.py builds it; every variant is exact
    attention, whatever the ranks) and, for dropout, ``ulysses_attention``
    inside ``shard_map`` at cp 2 and 4 with the integer seed."""
    from apex_tpu.parallel.ring_attention import ring_self_attention as jr
    from apex_tpu.parallel.ulysses import ulysses_attention as ju
    from apex_tpu.parallel.ulysses import ulysses_self_attention as jus

    rng = np.random.default_rng(21)
    d = {n: rng.normal(size=shp).astype(np.float32) for n, shp in (
        ("q", (2, 16, 4, 8)), ("k", (2, 16, 2, 8)), ("v", (2, 16, 2, 8)),
        ("w", (2, 16, 4, 8)))}
    q, k, v, w = (jnp.asarray(d[n]) for n in "qkvw")
    ref = {}
    mesh = _jax_cp_mesh(4, 2)
    try:
        for causal in (False, True):
            ref[f"ring_{causal}"] = _jax_out_grads(jax.jit(
                functools.partial(jr, mesh=mesh, causal=causal,
                                  batch_spec="data")), q, k, v, w)
            ref[f"uly_{causal}"] = _jax_out_grads(jax.jit(
                functools.partial(jus, mesh=mesh, causal=causal,
                                  batch_spec="data")), q, k, v, w)
        ref["uly_window"] = _jax_out_grads(jax.jit(functools.partial(
            jus, mesh=mesh, causal=True, window=5, batch_spec="data")),
            q, k, v, w)
        ref["ring_uneven"] = _jax_out_grads(jax.jit(functools.partial(
            jr, mesh=mesh, causal=True, batch_spec="data")),
            q, k[:, :8], v[:, :8], w)
    finally:
        jax_mesh.destroy_mesh()
    for cp in (2, 4):
        mesh = _jax_cp_mesh(cp, 1)
        spec = P(None, "context", None, None)
        try:
            run = jax.jit(jax.shard_map(
                lambda a, b, c: ju(a, b, c, "context", causal=True,
                                   dropout_rate=CP_RATE,
                                   dropout_rng=CP_SEED),
                mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
            ref[f"uly_dropout_{cp}"] = np.asarray(run(q, k, v))
        finally:
            jax_mesh.destroy_mesh()
    return dict(d, rate=CP_RATE, seed=CP_SEED, ref=ref)


def _cp_spawns(gpt_tp2, gpt_tp2_dp2):
    return {2: [r["cp"] for r in gpt_tp2], 4: [r["cp"] for r in gpt_tp2_dp2]}


def _cp_close(got, want):
    o, grads = got
    _near(o, want[0])
    for g, wg in zip(grads, want[1]):
        _near(g, wg)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("name", ["ring_False", "ring_True", "ring_remat",
                                  "ring_uneven", "uly_False", "uly_True",
                                  "uly_window"])
def test_context_parallel_matches_jax(cp_case, gpt_tp2, gpt_tp2_dp2, cp,
                                      name):
    """Every rank's whole output and whole input gradients (the cut's
    backward all-gathers) against the JAX function, 1e-5 of the largest
    magnitude: ring at cp 2 / 4 (causal and not, remat, uneven sk = sq /
    2, GQA throughout: hk 2), Ulysses at cp 2 (kv heads split) and cp 4
    (kv heads repeated: hk 2 < cp 4), with a window."""
    want = cp_case["ref"][name.replace("remat", "True")]
    for r in _cp_spawns(gpt_tp2, gpt_tp2_dp2)[cp]:
        _cp_close(r[name], want)


@pytest.mark.parametrize("name", ["ring", "uly"])
def test_context_parallel_cp2_dp2_matches_jax(cp_case, gpt_tp2_dp2, name):
    """Context 2 x data 2 (``batch_spec="data"``): each rank cuts its
    batch rows and sequence chunk."""
    for r in gpt_tp2_dp2:
        _cp_close(r["cp"][f"{name}_dp"], cp_case["ref"][f"{name}_True"])


@pytest.mark.parametrize("cp", [2, 4])
def test_ulysses_dropout_folds_the_seed_as_jax(cp_case, gpt_tp2,
                                               gpt_tp2_dp2, cp):
    """Dropout on the local chunks with the same integer seed: each
    rank's fold of the seed and its local lanes give the JAX masks bit
    for bit, and the outputs agree to 1e-6."""
    from apex_tpu.ops.attention import dropout_keep_mask as j_mask
    from apex_tpu_torch.ops.attention import dropout_keep_mask
    from apex_tpu_torch.parallel.ulysses import fold_seed

    ranks = _cp_spawns(gpt_tp2, gpt_tp2_dp2)[cp]
    s = 16 // cp
    for r, out in enumerate(ranks):
        want = cp_case["ref"][f"uly_dropout_{cp}"][:, r * s:(r + 1) * s]
        np.testing.assert_allclose(out["uly_dropout"], want, rtol=0,
                                   atol=1e-6)
        # JAX's fold (ulysses.py): int32(uint32(seed) ^ (rank + 1) * phi)
        jseed = (jnp.uint32(CP_SEED) ^ ((jnp.uint32(r) + jnp.uint32(1))
                                        * jnp.uint32(0x9E3779B9))).astype(
            jnp.int32)
        assert fold_seed(CP_SEED, r) == int(jseed)
        got = dropout_keep_mask(fold_seed(CP_SEED, r), 2, 4 // cp, 16, 16,
                                CP_RATE).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_mask(
            jseed, 2, 4 // cp, 16, 16, CP_RATE)))


def test_ulysses_divisibility_errors_and_agreement_with_ring(gpt_tp2,
                                                             gpt_tp2_dp2):
    """The JAX ValueErrors (h % cp, then GQA neither way), and Ulysses
    agrees with ring on every spawn."""
    for cp, ranks in _cp_spawns(gpt_tp2, gpt_tp2_dp2).items():
        for r in ranks:
            heads, gqa = r["errors"]
            assert "num_heads (3) divisible by the context axis size" \
                f" ({cp})" in heads
            assert "kv heads (3) divisible by cp" in gqa
            _cp_close(r["uly_True"], r["ring_True"])


# --------------------------------------------------------------------- #
# tensor-parallel paged serving at tp 2
# --------------------------------------------------------------------- #
def _paged_cases(rng):
    """The sharded-op cases: MHA (hk 4) and GQA (hk 2), chunk and
    decode, the compute dtype and int8 pages."""
    from apex_tpu_torch.ops.paged_attention import quantize_kv_pages

    cases = {}
    b, h, dd, nb, bs = 2, 4, 16, 7, 4
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    lengths = np.array([5, 9], np.int32)
    for hk in (4, 2):
        kp, vp = (rng.normal(size=(hk, nb, bs, dd)).astype(np.float32)
                  for _ in range(2))
        for quant in (None, "int8"):
            pool = dict(k_pages=kp, v_pages=vp)
            if quant:
                kq, vq, ks, vs = quantize_kv_pages(
                    torch.from_numpy(kp), torch.from_numpy(vp), quant)
                pool = dict(k_pages=kq.numpy(), v_pages=vq.numpy(),
                            k_scales=ks.numpy(), v_scales=vs.numpy())
            tag = f"hk{hk}_{quant}"
            cases["chunk_" + tag] = dict(
                q=rng.normal(size=(b, 3, h, dd)).astype(np.float32),
                tables=tables, lengths=lengths, **pool)
            cases["decode_" + tag] = dict(
                q=rng.normal(size=(b, 1, h, dd)).astype(np.float32),
                k_new=rng.normal(size=(b, 1, hk, dd)).astype(np.float32),
                v_new=rng.normal(size=(b, 1, hk, dd)).astype(np.float32),
                tables=tables, lengths=lengths, max_seq_len=12, **pool,
                **({"chunk_lens": np.ones(b, np.int32)} if quant else {}))
    return cases


SERVE_ENGINES = dict(
    shared_spec=dict(max_slots=2, block_size=4, prefill_chunk=4,
                     share_prefixes=True, spec_tokens=2),
    int8=dict(max_slots=2, block_size=4, prefill_chunk=4, kv_dtype="int8"))


@pytest.fixture(scope="module")
def serve_case(gpt_case):
    """The op cases, three greedy requests (two sharing a two-page
    prefix) and the JAX ``generate()`` tokens of each prompt."""
    from apex_tpu.models import generate as j_generate

    jcfg, model, params, _, _, _ = gpt_case
    rng = np.random.default_rng(13)
    p1 = rng.integers(0, 128, 10).astype(np.int32)
    p2 = np.concatenate([p1[:8], rng.integers(0, 128, 3)]).astype(np.int32)
    p3 = rng.integers(0, 128, 5).astype(np.int32)
    requests = [(p1, 6), (p2, 6), (p3, 5)]
    want = [np.asarray(j_generate(model, {"params": params},
                                  jnp.asarray(p[None]),
                                  max_new_tokens=n))[0, len(p):].tolist()
            for p, n in requests]
    return dict(ops=_paged_cases(rng), requests=requests,
                engines=SERVE_ENGINES, jax_tokens=want)


def test_sharded_paged_ops_are_the_unsharded_slice_bitwise(gpt_tp2):
    """Each rank on its kv heads of the pool and its q heads, as a
    tensor-parallel layer calls the op: the output is the unsharded
    op's slice of heads, and the fused decode step's written pages and
    scales the slice of the unsharded pool, bitwise — MHA and GQA,
    chunk and decode, float and int8 pages."""
    for r in gpt_tp2:
        ops = r["serve"]["ops"]
        assert len(ops) == 8
        for name, c in ops.items():
            got, want = c["o"]
            assert got.shape[2] == 2, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            for g, w in c.get("pools", []):
                np.testing.assert_array_equal(g, w, err_msg=name)
            assert len(c.get("pools", [])) == (
                0 if name.startswith("chunk") else
                4 if name.endswith("int8") else 2)


@pytest.mark.parametrize("engine", list(SERVE_ENGINES))
def test_tp2_paged_engine_is_token_identical(serve_case, gpt_tp2, engine):
    """The tiny GPT at tp 2 (each rank 2 of the 4 kv heads of every
    page) through ``PagedEngine(mesh=tp_mesh(2))``, prefix sharing and
    two drafts on: the same tokens on both ranks as the single-chip
    engine and JAX ``generate()``; on int8 pages, as the single-chip
    int8 engine."""
    for r in gpt_tp2:
        tp, single = r["serve"][engine], r["serve"][engine + "_single"]
        assert tp["tokens"] == single["tokens"]
        if engine != "int8":
            assert tp["tokens"] == serve_case["jax_tokens"]
        assert (tp["chips"], tp["mesh_shape"]) == (2, {"tensor": 2})
        assert (single["chips"], single["mesh_shape"]) == (1, None)
        assert tp["pool_heads"] == (2,) and single["pool_heads"] == (4,)
        assert tp["blocks_in_use"] == 0
        if engine == "shared_spec":
            assert tp["spec_proposed"] == single["spec_proposed"] > 0


def test_tp2_inference_server_serves_from_rank_zero(serve_case, gpt_tp2):
    """``InferenceServer(kv_cache="paged", tp=2)``: rank 0 schedules and
    streams the JAX tokens, rank 1 replays its records (and refuses a
    request); both report 2 chips a replica and the mesh shape."""
    r0, r1 = (r["serve"] for r in gpt_tp2)
    assert r0["server"] == serve_case["jax_tokens"]
    assert "requests enter on tensor rank 0" in r1["follower_submit"]
    for r in (r0, r1):
        h = r["health"]
        assert (h["chips_per_replica"], h["mesh_shape"]) == (
            2, {"tensor": 2})
        assert h["blocks_in_use"] == 0 and h["error"] is None
    assert r0["health"]["steps"] == r1["health"]["steps"] > 0
