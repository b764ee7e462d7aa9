"""Tensor-parallel paged serving: the gates, a rank's shard of the
paged op, and a world of one, in one process.

The gates are the JAX package's (``TestConfigTimeValidation`` in
tests/test_tp_serving.py), held where the port keeps the serving mesh:
the engine refuses ``kv_heads % tp``, a mesh without a tensor axis and a
model not built on the mesh's tensor axis; the server refuses ``tp`` on
the dense cache and a ``tp`` that disagrees with the mesh; ``tp_mesh``
needs that many processes.  (The JAX config's ``kv_mesh`` /
``kv_shard_axis`` have no counterpart: the model's layers hold their
heads from the mesh they are built on.)  Each rank's call of the paged
ops on its shard — its q heads, its kv heads of the pool — is the
unsharded call's slice, bitwise, for every rank of tp 2 and 4.  Then a
gloo world of one runs the tensor-parallel code over a tensor group of
one rank — the engine and the server on a port ``Mesh``, float and int8
pages — and must give the single-chip engine's tokens, as the card's
phase 29 holds it over NCCL.  The tp = 2 checks ride the spawn of
test_torch_tensor_parallel.py.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.core.mesh import Mesh, MeshConfig
from apex_tpu_torch.models import LlamaConfig
from apex_tpu_torch.models.jax_import import shard_paged_pool
from apex_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_decode_fused,
    quantize_kv_pages,
    tp_head_shards,
)
from apex_tpu_torch.serving import (
    InferenceServer,
    PagedEngine,
    Request,
    Scheduler,
    tp_mesh,
)
from apex_tpu_torch.transformer.testing import commons


def _mesh(tensor):
    return Mesh(MeshConfig(data=1, tensor=tensor), 0)


class TestConfigTimeValidation:
    def test_engine_rejects_indivisible_tp_and_foreign_meshes(self):
        with commons.without_mesh():
            model = commons.standalone_gpt(device="cpu", vocab_size=64,
                                           hidden_size=32, max_seq_len=32)
        with pytest.raises(ValueError,
                           match="divisible by the tensor-parallel"):
            PagedEngine(model, mesh=3)
        with pytest.raises(ValueError, match="no 'tensor' axis"):
            PagedEngine(model, mesh=object())
        # a model whose layers hold whole heads on a tensor axis of 2
        with pytest.raises(ValueError, match="build the model on the"):
            PagedEngine(model, mesh=_mesh(2))
        assert PagedEngine(model, max_slots=1, mesh=1).mesh is None

    def test_server_rejects_tp_on_dense_and_mismatch(self):
        with commons.without_mesh():
            model = commons.standalone_gpt(device="cpu", vocab_size=64,
                                           hidden_size=32, max_seq_len=32)
        with pytest.raises(ValueError, match="require kv_cache='paged'"):
            InferenceServer(model, tp=2)
        with pytest.raises(ValueError, match="require kv_cache='paged'"):
            InferenceServer(model, mesh=_mesh(1))
        for mesh in (_mesh(2), 2):
            with pytest.raises(ValueError, match="disagrees with mesh"):
                InferenceServer(model, kv_cache="paged", tp=4, mesh=mesh)

    def test_tp_mesh_needs_enough_devices(self):
        with pytest.raises(ValueError, match="needs 2 devices"):
            tp_mesh(2)
        with pytest.raises(ValueError, match="tp must be >= 1"):
            tp_mesh(0)


# --------------------------------------------------------------------- #
# a rank's shard of the paged ops
# --------------------------------------------------------------------- #
def _pool_case(kind, kv_dtype, h=8, hk=4, d=16, nb=7, bs=4):
    """A one-layer pool (float or quantized) as an engine's cache, and
    the op's other inputs for a chunk of 3 or a decode step."""
    g = torch.Generator().manual_seed(21)
    kp, vp = (torch.randn(hk, nb, bs, d, generator=g) for _ in range(2))
    pool = dict(key=kp, value=vp)
    if kv_dtype:
        kq, vq, ks, vs = quantize_kv_pages(kp, vp, kv_dtype)
        pool = dict(key=kq, value=vq, key_scales=ks, value_scales=vs)
    args = dict(tables=torch.tensor([[1, 2, 3], [4, 5, 6]],
                                    dtype=torch.int32),
                lengths=torch.tensor([5, 9], dtype=torch.int32),
                q=torch.randn(2, 3 if kind == "chunk" else 1, h, d,
                              generator=g))
    if kind == "decode":
        args.update(k_new=torch.randn(2, 1, hk, d, generator=g),
                    v_new=torch.randn(2, 1, hk, d, generator=g))
    return pool, args


def _op(kind, pool, a):
    """The op on ``pool`` (updated in place by a decode step): the
    output, and for a decode step the pool after it."""
    scales = ({} if "key_scales" not in pool else dict(
        k_scales=pool["key_scales"], v_scales=pool["value_scales"]))
    if kind == "chunk":
        return paged_attention(a["q"], pool["key"], pool["value"],
                               a["tables"], a["lengths"], **scales), {}
    extra = {} if not scales else dict(
        chunk_lens=torch.ones(2, dtype=torch.int32))
    o = paged_decode_fused(a["q"], a["k_new"], a["v_new"], pool["key"],
                           pool["value"], a["tables"], a["lengths"],
                           max_seq_len=12, **scales, **extra)[0]
    return o, pool


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("kind", ["chunk", "decode"])
@pytest.mark.parametrize("tp", [2, 4])
def test_a_ranks_shard_of_the_paged_op_is_the_unsharded_slice(tp, kind,
                                                              kv_dtype):
    """Every rank of ``tp`` calls the op on its q heads
    (``tp_head_shards``), its kv heads of the pool
    (``shard_paged_pool``) and of the new rows, as a tensor-parallel
    layer does: its output is the whole call's slice of heads and its
    written pages and scales the whole pool's slice, bitwise."""
    pool, a = _pool_case(kind, kv_dtype)
    whole_o, whole_pool = _op(kind, {k: v.clone() for k, v in pool.items()},
                              a)
    for r, ((qlo, qhi), (klo, khi)) in enumerate(
            tp_head_shards(8, 4, tp)):
        mine = {k: v[None] for k, v in pool.items()}
        mine = {k: v[0] for k, v in shard_paged_pool(mine, r, tp).items()}
        local = dict(a, q=a["q"][:, :, qlo:qhi])
        for k in ("k_new", "v_new"):
            if k in a:
                local[k] = a[k][:, :, klo:khi]
        o, written = _op(kind, mine, local)
        assert torch.equal(o, whole_o[:, :, qlo:qhi]), r
        for k, v in written.items():
            assert torch.equal(v, whole_pool[k][klo:khi]), (r, k)


def test_shard_paged_pool_cuts_the_kv_heads_and_keeps_the_tables():
    pool = dict(key=torch.arange(2 * 4 * 3).reshape(2, 4, 3),
                key_scales=torch.ones(2, 4, 5), tables=torch.ones(3, 2))
    mine = shard_paged_pool(pool, 1, 2)
    assert torch.equal(mine["key"], pool["key"][:, 2:])
    assert torch.equal(mine["key_scales"], pool["key_scales"][:, 2:])
    assert mine["tables"] is pool["tables"]
    with pytest.raises(ValueError, match="divisible by the tensor-parallel"):
        shard_paged_pool(pool, 0, 3)


# --------------------------------------------------------------------- #
# a gloo world of one
# --------------------------------------------------------------------- #
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, max_seq_len=64)
ENGINE = dict(max_slots=3, block_size=8, prefill_chunk=4,
              share_prefixes=True, spec_tokens=2)


def _requests():
    rng = np.random.default_rng(3)
    p = rng.integers(0, 128, 20).astype(np.int32)
    return [(p, 6), (np.concatenate([p[:16], p[:3]]), 5),
            (rng.integers(0, 128, 7).astype(np.int32), 7)]


def _tokens(model, **kw):
    eng = PagedEngine(model, **ENGINE, **kw)
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt=p, max_new_tokens=n))
            for p, n in _requests()]
    sched.drain()
    assert eng.blocks_in_use == 0
    return [list(r.tokens) for r in reqs], eng


@pytest.fixture(scope="module")
def world_of_one():
    from apex_tpu_torch.parallel.launch import (
        destroy_distributed,
        init_distributed,
    )

    init_distributed(device="cpu")
    try:
        yield mesh_lib.initialize_mesh()
    finally:
        mesh_lib.destroy_mesh()
        destroy_distributed()


def _llama_pair():
    """The tiny Llama (GQA: 4 heads, 2 kv heads) without a mesh and on
    the current mesh, from the same whole weights."""
    from apex_tpu_torch.models import LlamaModel

    cfg = LlamaConfig.tiny(**LLAMA)
    with commons.without_mesh():
        single = LlamaModel(cfg, device="cpu")
        single.init_weights(torch.Generator().manual_seed(5))
    sharded = LlamaModel(cfg, device="cpu")
    sharded.load_state_dict(single.state_dict())
    return single, sharded


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_on_a_mesh_of_one_is_the_single_chip_engine(world_of_one,
                                                           kv_dtype):
    single, sharded = _llama_pair()
    want, _ = _tokens(single, kv_dtype=kv_dtype)
    got, eng = _tokens(sharded, mesh=world_of_one, kv_dtype=kv_dtype)
    assert got == want
    assert (eng.chips_per_replica, eng.mesh_shape) == (1, {"tensor": 1})


def test_server_on_a_mesh_of_one(world_of_one):
    single, sharded = _llama_pair()
    want, _ = _tokens(single)
    srv = InferenceServer(sharded, kv_cache="paged", mesh=world_of_one,
                          **ENGINE)
    with srv:
        got = [srv.submit(p, max_new_tokens=n).result(timeout=120)
               for p, n in _requests()]
        health = srv.health()
    assert got == want
    assert health["chips_per_replica"] == 1
    assert health["mesh_shape"] == {"tensor": 1}
    assert srv.engine.tp == 1 and srv.tp_rank == 0
