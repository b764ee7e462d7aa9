"""Ring attention through the virtual ring, and the slice's paths at a
world of one, against the JAX package.

The virtual ring plays ``cp`` ranks in one process through the same
ticks as the ring over a process group
(``apex_tpu_torch.parallel.virtual_ring_attention``); it is held against
the JAX ``ring_self_attention`` on ``initialize_mesh(
context_parallel_size=4, data_parallel_size=2)``, as
tests/test_ring_attention.py builds it, at 1e-5 of the largest
magnitude (fp32): causal and not, GQA, uneven lengths, remat, DP × CP
and the gradients of a weighted sum.  A gloo world of one in this
process then runs ring, Ulysses and the MoE expert axis (tensor and
data) over groups of one rank: bitwise equal to the calls without a
mesh, as the card's phases 27 and 28 hold them over NCCL.  The
multi-rank checks ride the spawns of test_torch_tensor_parallel.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.core import mesh as jax_mesh
from apex_tpu.parallel.ring_attention import ring_self_attention as j_ring
from apex_tpu_torch.ops.attention import fused_attention
from apex_tpu_torch.parallel import (
    ring_attention,
    ulysses_attention,
    virtual_ring_attention,
)
from apex_tpu_torch.parallel.ring_attention import chunk_mask
from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP


def _near(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _qkvw(seed, b, s, h, hk, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return [rng.normal(size=shp).astype(np.float32) for shp in (
        (b, s, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, s, h, d))]


def _port(fn, q, k, v, w):
    xs = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = fn(*xs)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in xs]


def _jax(q, k, v, w, **kw):
    mesh = jax_mesh.initialize_mesh(context_parallel_size=4,
                                    data_parallel_size=2)
    try:
        fn = jax.jit(functools.partial(j_ring, mesh=mesh,
                                       batch_spec="data", **kw))

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) * w)
        args = [jnp.asarray(t) for t in (q, k, v)]
        return np.asarray(fn(*args)), [np.asarray(g) for g in jax.grad(
            loss, argnums=(0, 1, 2))(*args)]
    finally:
        jax_mesh.destroy_mesh()


# b 2 (one row a data rank), S 32 (chunks of 8 at cp 4)
CASES = {
    "causal": (dict(h=4, hk=4), dict(causal=True)),
    "full": (dict(h=4, hk=4), dict(causal=False)),
    "gqa": (dict(h=8, hk=2), dict(causal=True)),
    "uneven": (dict(h=4, hk=2, sk=16), dict(causal=True)),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("remat", [False, True])
def test_virtual_ring_matches_jax_ring_self_attention(name, remat):
    """cp 4 virtual ranks on each data row (DP × CP: the rows of the
    batch are the data ranks' shards): output and gradients."""
    shape, kw = CASES[name]
    q, k, v, w = _qkvw(list(CASES).index(name), 2, 32, d=8, **shape)
    want = _jax(q, k, v, w, remat=remat, **kw)

    def per_row(qq, kk, vv):
        return torch.cat([virtual_ring_attention(
            qq[i:i + 1], kk[i:i + 1], vv[i:i + 1], 4, remat=remat, **kw)
            for i in range(2)])
    got = _port(per_row, q, k, v, w)
    _near(got[0], want[0])
    for g, wg in zip(got[1], want[1]):
        _near(g, wg)


def test_dead_chunks_launch_nothing():
    """Causal, equal lengths, cp 4: chunk (rank, src) is live iff src <=
    rank — 10 of 16 — the diagonal takes the kernel's causal mask and
    the rest run unmasked; uneven lengths get the -1e30 bias."""
    kinds = {(r, s): chunk_mask(True, r, s, 8, 8, 4)[0]
             for r in range(4) for s in range(4)}
    assert sum(k != "dead" for k in kinds.values()) == 10
    assert all(kinds[(r, r)] == "causal" for r in range(4))
    assert all(kinds[(r, s)] == "full" for r in range(4) for s in range(r))
    kind, bias = chunk_mask(True, 2, 1, 8, 4, 4)     # sk = sq / 2
    assert kind == "bias" and bias.shape == (8, 4)
    dead = bias == torch.tensor(-1e30)
    assert dead.any() and (bias[~dead] == 0).all()
    assert chunk_mask(False, 0, 3, 8, 8, 4) == ("full", None)


def test_virtual_ring_of_one_is_fused_attention_bitwise():
    q, k, v, w = _qkvw(3, 2, 16, 4, 2, 8)
    for causal in (False, True):
        got = _port(lambda a, b, c: virtual_ring_attention(
            a, b, c, 1, causal=causal), q, k, v, w)
        want = _port(lambda a, b, c: fused_attention(
            a, b, c, causal=causal), q, k, v, w)
        np.testing.assert_array_equal(got[0], want[0])
        for g, wg in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, wg)


# --------------------------------------------------------------------- #
# a gloo world of one: groups of one rank, bitwise the calls without
# --------------------------------------------------------------------- #
@pytest.fixture
def world_of_one():
    from apex_tpu_torch.core import mesh as mesh_lib
    from apex_tpu_torch.parallel.launch import (
        destroy_distributed,
        init_distributed,
    )

    init_distributed(device="cpu")
    try:
        yield mesh_lib
    finally:
        mesh_lib.destroy_mesh()
        destroy_distributed()


def test_ring_and_ulysses_at_a_world_of_one(world_of_one):
    mesh = world_of_one.initialize_mesh(context_parallel_size=1)
    q, k, v, w = _qkvw(4, 2, 16, 4, 2, 8)
    want = _port(lambda a, b, c: fused_attention(a, b, c, causal=True),
                 q, k, v, w)
    for fn in (lambda a, b, c: ring_attention(a, b, c, causal=True,
                                              mesh=mesh),
               lambda a, b, c: ring_attention(a, b, c, causal=True,
                                              remat=True, mesh=mesh),
               lambda a, b, c: ulysses_attention(a, b, c, causal=True)):
        got = _port(fn, q, k, v, w)
        np.testing.assert_array_equal(got[0], want[0])
        for g, wg in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, wg)


@pytest.mark.parametrize("axis", ["tensor", "data"])
def test_moe_expert_axis_at_a_world_of_one(world_of_one, axis):
    """The expert axis over a group of one runs the sharded path (the
    copies and reductions, or the two all-to-alls) and computes what
    the layer computes without a mesh, bitwise: output, aux and every
    gradient."""
    cfg = MoEConfig(num_experts=4, top_k=2, hidden_size=16,
                    ffn_hidden_size=32, gated=True, activation="silu",
                    expert_axis=axis)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(3, 6, 16)).astype(np.float32))
    wy = torch.from_numpy(rng.normal(size=(3, 6, 16)).astype(np.float32))

    def run(layer, sd=None):
        if sd is None:
            layer.init_weights(torch.Generator().manual_seed(0))
        else:
            layer.load_state_dict(sd)
        y, aux = layer(x)
        ((y * wy).sum() + aux).backward()
        return y.detach(), aux.detach(), {
            n: p.grad for n, p in layer.named_parameters()}

    plain = MoEMLP(cfg, device="cpu")
    want = run(plain)
    world_of_one.initialize_mesh()
    sharded = MoEMLP(cfg, device="cpu")
    assert sharded.ep_active and sharded.w1.expert_axis == axis
    got = run(sharded, plain.state_dict())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for n in want[2]:
        assert torch.equal(got[2][n], want[2][n]), n
