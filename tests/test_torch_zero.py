"""The port's ZeRO-1/2 on gloo ranks against the JAX package.

The rank function (``torch_parallel_workers.zero_checks``) runs on 2
spawned CPU processes over the data axis; the JAX side runs the same
on 2 devices of the 8-device CPU mesh in ``shard_map``:

- ``reduce_scatter_mean_grads``, stages 1 and 2, exact and int8 wires:
  bitwise against the JAX function;
- the layout helpers (``zero_partition`` / ``zero_unpartition`` round
  trip, ``shard_segments``);
- three zero-mode steps of ``distributed_fused_adam`` (stages 2 and 1)
  and of ``distributed_fused_lamb(shard_axis=...)`` on the JAX tests'
  MLP, each rank on its half of the batch, against the JAX zero-mode
  train state after the same steps (1e-6); the gathered fp32 masters
  equal the module's parameters; the int8 wire's steps stay within
  3 lr of the exact wire's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_workers as W
from apex_tpu import amp
from apex_tpu.optim import fused_adam
from apex_tpu.parallel import (
    ZeroConfig,
    distributed_fused_lamb,
    reduce_scatter_mean_grads,
    zero_state_specs,
)
from apex_tpu_torch.parallel import distributed_optim as Z
from apex_tpu_torch.transformer.testing.commons import run_on_ranks

N = 2
AXIS = "fsdp"
MESH = Mesh(np.array(jax.devices()[:N]), (AXIS,))


def _mlp_params(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": jax.random.normal(k1, (16, 33)) * 0.1,
            "b1": jnp.zeros((33,)),
            "w2": jax.random.normal(k2, (33, 1)) * 0.1,
            "b2": jnp.zeros((1,))}


def _mlp_apply(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _port_names(p):
    """The JAX MLP's params as the port module's state dict."""
    return {"l1.weight": np.asarray(p["w1"]).T, "l1.bias": np.asarray(p["b1"]),
            "l2.weight": np.asarray(p["w2"]).T, "l2.bias": np.asarray(p["b2"])}


@pytest.fixture(scope="module")
def zero_case():
    x = jax.random.normal(jax.random.PRNGKey(3), (64, 16))
    y = jnp.sum(x[:, :4], axis=1, keepdims=True)
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=(N, 5, 7)).astype(np.float32),
             rng.normal(size=(N, 33)).astype(np.float32)]
    d = dict(x=np.asarray(x).reshape(N, -1, 16),
             y=np.asarray(y).reshape(N, -1, 1),
             params={k: np.ascontiguousarray(v)
                     for k, v in _port_names(_mlp_params()).items()},
             grads=grads)
    return d, run_on_ranks(W.zero_checks, N, d)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("rd", [None, "int8"])
def test_reduce_scatter_bitwise(zero_case, stage, rd):
    d, ranks = zero_case

    def body(*g):
        out = reduce_scatter_mean_grads([t[0] for t in g], AXIS,
                                        reduce_dtype=rd, stage=stage)
        return [o[None] for o in out]
    f = jax.shard_map(body, mesh=MESH, in_specs=(P(AXIS),) * 2,
                      out_specs=P(AXIS), check_vma=False)
    want = [np.asarray(w) for w in f(*[jnp.asarray(g) for g in d["grads"]])]
    for r in range(N):
        for got, w in zip(ranks[r][f"rs_{stage}_{rd}"], want):
            np.testing.assert_array_equal(got, w[r])


def test_partition_layout():
    t = {"a": torch.arange(7.0).view(7), "b": torch.ones(2, 3)}
    rows = Z.zero_partition(t, 3)
    assert rows["a"].shape == (3, 3) and rows["b"].shape == (3, 2)
    back = Z.zero_unpartition(rows, t)
    assert torch.equal(back["a"], t["a"]) and torch.equal(back["b"], t["b"])
    # sizes 5, 4, 3 over 3 rows of 4: row 1 holds 1 of a, 3 of b
    assert Z.shard_segments([5, 4, 3], 0, 3) == [4, 0, 0, 0]
    assert Z.shard_segments([5, 4, 3], 1, 3) == [1, 3, 0, 0]
    assert Z.shard_segments([5, 4, 3], 2, 3) == [0, 1, 3, 0]
    assert Z.shard_segments([5], 1, 2) == [2, 1]
    with pytest.raises(ValueError, match="stage"):
        Z.ZeroConfig(stage=3, axis_size=2).resolved()
    with pytest.raises(ValueError, match="allreduce_dtype"):
        Z.ZeroConfig(reduce_dtype=torch.int32, axis_size=2).resolved()


def _jax_zero(tx, d, steps=3, **zkw):
    state = amp.initialize(_mlp_apply, _mlp_params(), tx, opt_level="O0",
                           zero=ZeroConfig(axis=AXIS, axis_size=N, **zkw))
    specs = zero_state_specs(state)

    def step(state, x, y):
        def loss_fn(p):
            loss = jnp.mean((state.apply_fn(p, x) - y) ** 2)
            return state.scale_loss(loss)
        grads = jax.grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads)[0]
    f = jax.jit(jax.shard_map(step, mesh=MESH,
                              in_specs=(specs, P(AXIS), P(AXIS)),
                              out_specs=specs, check_vma=False))
    x = jnp.asarray(d["x"].reshape(-1, 16))
    y = jnp.asarray(d["y"].reshape(-1, 1))
    for _ in range(steps):
        state = f(state, x, y)
    return _port_names(jax.device_get(state.params))


@pytest.mark.parametrize("name,tx,zkw", [
    ("adam_s2", lambda: fused_adam(1e-2), dict(stage=2)),
    ("adam_s1", lambda: fused_adam(1e-2), dict(stage=1)),
    ("lamb_s2", lambda: distributed_fused_lamb(1e-2, shard_axis=AXIS),
     dict(stage=2))])
def test_zero_steps_match_jax(zero_case, name, tx, zkw):
    d, ranks = zero_case
    want = _jax_zero(tx(), d, **zkw)
    for r in range(N):
        got = ranks[r][name]
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        # the gathered fp32 masters are the module's parameters (fp32)
        masters = ranks[r][name + "_masters"]
        assert set(masters) == set(got)
        for k in got:
            np.testing.assert_array_equal(masters[k], got[k])


def test_zero_int8_wire_steps_stay_close(zero_case):
    """The int8 wire's reduce-scatter is bitwise (above), but the ranks'
    gradients come from torch's products, which round apart from XLA's;
    a value on a quantization boundary then lands a step away, and Adam
    turns that into an update of up to lr.  So the int8 run is held
    within 3 lr (three steps) of the exact run instead."""
    _, ranks = zero_case
    for r in range(N):
        got, exact = ranks[r]["adam_int8"], ranks[r]["adam_s2"]
        for k in exact:
            assert np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], exact[k], rtol=0, atol=3e-2)
