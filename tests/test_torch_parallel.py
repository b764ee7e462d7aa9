"""The port's data parallelism on gloo ranks against the JAX package.

The rank functions are in ``torch_parallel_workers.py``; each check
spawns 2 CPU processes (``commons.run_on_ranks``) and holds their
results against the JAX function in ``shard_map`` over 2 devices of the
8-device CPU mesh, from the same numpy-seeded inputs:

- the mesh: the rank layout of every axis equals the JAX mesh's device
  layout, and ``MeshConfig.resolved`` raises as the JAX one does;
- ``init_distributed``: the environment bootstrap (every spawned rank
  starts through it), a world of one on a file store, and the error
  naming what a partial environment lacks;
- the DDP all-reduce: mean, sum, bf16 and int8 (average and sum)
  bitwise against ``all_reduce_mean_grads`` at 2 ranks; an inf
  gradient comes back NaN, a subnormal amax gives no NaN;
- SyncBatchNorm over the data axis, fused and not: statistics, the
  module's output, running statistics and gradients (cross-rank terms
  included) against JAX ``SyncBatchNorm`` (1e-6 of each tensor's
  largest magnitude), and ``batch_norm_train(axis_names=...)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_workers as W
from apex_tpu.core import mesh as jax_mesh
from apex_tpu.ops.batch_norm import batch_norm_train as j_bn_train
from apex_tpu.parallel import all_reduce_mean_grads as j_all_reduce
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JSyncBN
from apex_tpu_torch.core import mesh as port_mesh
from apex_tpu_torch.parallel import launch
from apex_tpu_torch.transformer.testing.commons import run_on_ranks

N = 2
MESH = Mesh(np.array(jax.devices()[:N]), ("data",))


def _per_rank(fn, *stacked):
    def body(*a):
        return jax.tree.map(lambda o: o[None], fn(*[t[0] for t in a]))
    f = jax.shard_map(body, mesh=MESH, in_specs=(P("data"),) * len(stacked),
                      out_specs=P("data"), check_vma=False)
    return jax.tree.map(np.asarray, f(*[jnp.asarray(s) for s in stacked]))


def _near(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30))


# --------------------------------------------------------------------- #
# mesh and launch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [dict(tensor_model_parallel_size=2),
                                dict(tensor_model_parallel_size=2,
                                     pipeline_model_parallel_size=2),
                                dict(fsdp_size=2, context_parallel_size=2)])
def test_mesh_layout_is_the_jax_mesh(kw):
    jm = jax_mesh.initialize_mesh(devices=jax.devices(), set_current=False,
                                  **kw)
    cfg = port_mesh.MeshConfig(
        tensor=kw.get("tensor_model_parallel_size", 1),
        pipe=kw.get("pipeline_model_parallel_size", 1),
        fsdp=kw.get("fsdp_size", 1),
        context=kw.get("context_parallel_size", 1)).resolved(8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        m = port_mesh.Mesh(cfg, rank)
        np.testing.assert_array_equal(m.ranks, ids)
        assert m.shape == dict(jm.shape)
        for axis in port_mesh.AXIS_ORDER:
            line = m.line(axis)
            assert rank in line and len(line) == jm.shape[axis]
            assert line[m.axis_rank(axis)] == rank


def test_mesh_config_errors_match_jax():
    for bad, n in ((dict(tensor=3), 8), (dict(data=2, tensor=2), 8)):
        with pytest.raises(ValueError) as want:
            jax_mesh.MeshConfig(**bad).resolved(n)
        with pytest.raises(ValueError) as got:
            port_mesh.MeshConfig(**bad).resolved(n)
        assert str(got.value) == str(want.value)


def test_init_distributed_world_of_one_and_partial_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        launch.init_distributed(device="cpu")
    assert not launch.is_distributed() and not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    try:
        assert launch.init_distributed(device="cpu") is False
        assert launch.is_distributed() and dist.get_world_size() == 1
        mesh = port_mesh.initialize_mesh(tensor_model_parallel_size=1)
        t = torch.ones(3)
        dist.all_reduce(t, group=mesh.group("tensor"))
        assert torch.equal(t, torch.ones(3))
    finally:
        launch.destroy_distributed()
    assert not launch.is_distributed() and not dist.is_initialized()


# --------------------------------------------------------------------- #
# DDP
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ddp_case():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=(N, 5, 7)).astype(np.float32),
             (rng.normal(size=(N, 33)) * 1e-3).astype(np.float32),
             rng.normal(size=(N, 1)).astype(np.float32)]
    special = [rng.normal(size=(N, 6)).astype(np.float32),
               np.full((N, 4), 1e-39, np.float32),     # subnormal amax
               np.zeros((N, 3), np.float32)]
    special[0][0, 2] = np.inf
    d = dict(grads=grads, special=special)
    return d, run_on_ranks(W.ddp_checks, N, d)


def test_ddp_bootstrap_and_bookkeeping(ddp_case):
    _, ranks = ddp_case
    assert [r["world"] for r in ranks] == [N] * N
    assert [r["rank"] for r in ranks] == list(range(N))
    assert all(tuple(r["line"]) == (0, 1) for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))
    np.testing.assert_array_equal(ranks[1]["shard"],
                                  np.arange(8, 16).reshape(-1, 1))


@pytest.mark.parametrize("name,kw", [
    ("mean", {}), ("sum", dict(average=False)),
    ("bf16", dict(allreduce_dtype=jnp.bfloat16)),
    ("int8", dict(allreduce_dtype="int8")),
    ("int8_sum", dict(allreduce_dtype="int8", average=False))])
def test_all_reduce_bitwise(ddp_case, name, kw):
    d, ranks = ddp_case
    want = _per_rank(lambda *g: j_all_reduce(list(g), "data", **kw),
                     *d["grads"])
    for r in range(N):
        for got, w in zip(ranks[r][name], want):
            np.testing.assert_array_equal(got, w[r].astype(np.float32))


def test_int8_nonfinite_and_subnormal(ddp_case):
    d, ranks = ddp_case
    want = _per_rank(lambda *g: j_all_reduce(list(g), "data",
                                             allreduce_dtype="int8"),
                     *d["special"])
    for r in range(N):
        inf_leaf, tiny, zero = ranks[r]["int8_special"]
        assert np.isnan(inf_leaf).all()
        assert np.isfinite(tiny).all() and np.isfinite(zero).all()
        np.testing.assert_array_equal(tiny, want[1][r])
        np.testing.assert_array_equal(zero, np.zeros(3))


# --------------------------------------------------------------------- #
# SyncBatchNorm
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.default_rng(2)
    c = 8
    d = dict(x=(rng.normal(size=(N, 2, 3, 5, c)) * 2 + 1).astype(np.float32),
             dy=rng.normal(size=(N, 2, 3, 5, c)).astype(np.float32),
             res=rng.normal(size=(N, 2, 3, 5, c)).astype(np.float32),
             w=rng.normal(size=(c,)).astype(np.float32),
             b=rng.normal(size=(c,)).astype(np.float32))
    return d, run_on_ranks(W.syncbn_checks, N, d)


def _jax_module(d, fused):
    bn = JSyncBN(use_running_average=False, axis_names=("data",),
                 act="relu", fused=fused)
    c = d["w"].shape[0]
    params = {"scale": jnp.asarray(d["w"]), "bias": jnp.asarray(d["b"])}
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def run(x, res, dy):
        def loss(x, res, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, x,
                              residual=res, mutable=["batch_stats"])
            return jnp.sum(y * dy), (y, upd["batch_stats"])
        (_, (y, st)), (dx, dres, dp) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, res, params)
        return dict(y=y, dx=dx, dres=dres, dw=dp["scale"], db=dp["bias"],
                    mean=st["mean"], var=st["var"])
    return _per_rank(run, d["x"], d["res"], d["dy"])


@pytest.mark.parametrize("fused", [0, 1])
def test_sync_batchnorm_module(bn_case, fused):
    d, ranks = bn_case
    want = _jax_module(d, bool(fused))
    for r in range(N):
        got = ranks[r][f"module_{fused}"]
        for k in ("y", "dx", "dres", "dw", "db", "mean", "var"):
            _near(got[k], want[k][r])


def test_sync_batch_norm_stats_and_op(bn_case):
    d, ranks = bn_case
    x = d["x"].reshape(-1, d["x"].shape[-1])
    for r in range(N):
        mean, var = ranks[r]["stats"]
        _near(mean, x.mean(0))
        _near(var, x.var(0), 1e-5)

    def op(x, dy):
        def loss(x):
            y, m, v = j_bn_train(x, jnp.asarray(d["w"]), jnp.asarray(d["b"]),
                                 axis_names=("data",))
            return jnp.sum(y * dy), (y, m, v)
        (_, (y, m, v)), dx = jax.value_and_grad(loss, has_aux=True)(x)
        return dict(y=y, mean=m, var=v, dx=dx)
    want = _per_rank(op, d["x"], d["dy"])
    for r in range(N):
        for k in ("y", "mean", "var", "dx"):
            _near(ranks[r]["op"][k], want[k][r])
        # the converted module normalises with the whole batch's stats
        xr = d["x"][r]
        _near(ranks[r]["converted"],
              (xr - x.mean(0)) / np.sqrt(x.var(0) + 1e-5), 1e-5)
