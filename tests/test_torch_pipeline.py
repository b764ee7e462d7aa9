"""The port's pipeline parallelism in one process, against the JAX package.

- the microbatch calculators and their errors: the JAX module's numbers;
- ``bubble_fraction``, ``schedule_ticks``, ``live_microbatches``: equal;
- ``stage_split`` / ``stage_unsplit`` on stacked tensors (the JAX
  reshape) and on layer state dicts, round trips exact;
- ``forward_backward_no_pipelining`` on the toy residual-MLP stages of
  ``tests/test_pipeline.py`` against the JAX schedule function (loss 1e-6,
  gradients 1e-5 relative: the JAX function sums the microbatch gradients
  before scaling them, the port seeds each backward with 1/M);
- a pipe group of one (no mesh): the 1F1B and interleaved schedules equal
  ``forward_backward_no_pipelining`` bit for bit, and the p2p helpers
  call nothing;
- ``get_forward_backward_func``: the JAX dispatch;
- ``build_model``'s layer order: each rank's chunk, loaded by
  ``stage_params_from_jax`` from the JAX ``build_model`` stack, maps a
  microbatch as the JAX ``stage_fn`` on that row (2e-5, fp32);
- a world of one (gloo, file store): ``broadcast_data`` moves nothing
  and raises the JAX errors, ``stage_local_zero`` /
  ``pipeline_state_layout`` / ``local_stage`` / ``sync_grad_overflow``,
  and the MoE layer's tp 1 path (C-13's repair takes only tp > 1).

The multi-rank checks (pp 2 and 4 over gloo) ride the spawns of
``tests/test_torch_tensor_parallel.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from apex_tpu.parallel import pipeline as jpl
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer.pipeline_parallel import schedules as js
from apex_tpu_torch.models.jax_import import (
    closure_params_from_jax,
    stage_params_from_jax,
)
from apex_tpu_torch.parallel import pipeline as pl
from apex_tpu_torch.transformer import microbatches as mb_lib
from apex_tpu_torch.transformer.pipeline_parallel import (
    build,
    p2p,
    schedules as S,
)

HID, MB, SEQ = 16, 2, 4


# --------------------------------------------------------------------- #
# microbatch calculators
# --------------------------------------------------------------------- #
RAMPS = [(None, 64, 4, 2), ([16, 16, 300], 64, 4, 2), ([8, 8, 100], 32, 2, 2),
         ([32, 0, 10], 32, 4, 1)]


@pytest.mark.parametrize("ramp,gbs,mbs,dp", RAMPS)
def test_calculators_follow_the_jax_schedule(ramp, gbs, mbs, dp):
    got = mb_lib.build_num_microbatches_calculator(ramp, gbs, mbs, dp)
    want = jmb.build_num_microbatches_calculator(ramp, gbs, mbs, dp)
    assert type(got).__name__ == type(want).__name__
    for consumed in (0, 1, 50, 99, 100, 150, 250, 299, 301, 10_000):
        got.update(consumed, False)
        want.update(consumed, False)
        assert (got.get(), got.get_current_global_batch_size()) == \
            (want.get(), want.get_current_global_batch_size()), consumed


@pytest.mark.parametrize("args", [
    (None, 30, 4, 2),               # global batch not divisible
    ([16, 16], 64, 4, 2),           # a rampup spec of two
    ([70, 16, 300], 64, 4, 2),      # ramps down
    ([16, 20, 300], 64, 4, 2),      # increments do not reach it
    ([12, 16, 300], 64, 4, 2),      # start not divisible by mb·dp
])
def test_calculator_errors_are_the_jax_ones(args):
    with pytest.raises(ValueError) as want:
        jmb.build_num_microbatches_calculator(*args)
    with pytest.raises(ValueError) as got:
        mb_lib.build_num_microbatches_calculator(*args)
    assert str(got.value) == str(want.value)


def test_global_calculator():
    mb_lib.destroy_microbatch_calculator()
    with pytest.raises(RuntimeError):
        mb_lib.get_num_microbatches()
    mb_lib.setup_microbatch_calculator(
        rampup_batch_size=[16, 16, 300], global_batch_size=64,
        micro_batch_size=4, data_parallel_size=2)
    assert (mb_lib.get_num_microbatches(),
            mb_lib.get_current_global_batch_size()) == (2, 16)
    mb_lib.update_num_microbatches(150)
    assert mb_lib.get_current_global_batch_size() == 32
    mb_lib.destroy_microbatch_calculator()
    with pytest.raises(RuntimeError):
        mb_lib.get_current_global_batch_size()


# --------------------------------------------------------------------- #
# bubble arithmetic and stage partitioning
# --------------------------------------------------------------------- #
def test_bubble_math_equals_jax():
    for p in range(1, 6):
        assert pl.live_microbatches(p) == jpl.live_microbatches(p)
        for m in range(1, 10):
            assert pl.bubble_fraction(p, m) == jpl.bubble_fraction(p, m)
            assert pl.schedule_ticks(p, m) == jpl.schedule_ticks(p, m)
    for fn in (pl.bubble_fraction, pl.schedule_ticks):
        for bad in ((0, 4), (2, 0)):
            with pytest.raises(ValueError):
                fn(*bad)
    with pytest.raises(ValueError):
        pl.live_microbatches(0)


def test_stage_split_tensors_as_jax():
    tree = {"w": np.arange(48.0, dtype=np.float32).reshape(8, 3, 2),
            "s": np.float32(2.0)}
    want = jpl.stage_split({k: jnp.asarray(v) for k, v in tree.items()}, 4)
    got = pl.stage_split({k: torch.tensor(v) for k, v in tree.items()}, 4)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = pl.stage_unsplit(got)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    assert back["s"].dim() == 0
    with pytest.raises(ValueError, match="stage-balance"):
        pl.stage_split({"w": torch.zeros(6, 2)}, 4)


def test_stage_split_layer_state_dict_round_trip():
    layers = nn.ModuleList(nn.Linear(3, 3) for _ in range(6))
    sd = layers.state_dict()
    parts = pl.stage_split(sd, 3)
    assert [sorted(p) for p in parts] == [sorted(
        nn.ModuleList(nn.Linear(3, 3) for _ in range(2)).state_dict())] * 3
    assert torch.equal(parts[2]["1.weight"], sd["5.weight"])
    back = pl.stage_unsplit(parts)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="stage-balance"):
        pl.stage_split(sd, 4)


# --------------------------------------------------------------------- #
# the toy stages of tests/test_pipeline.py
# --------------------------------------------------------------------- #
class Toy(nn.Module):
    def __init__(self, w1, b1, w2):
        super().__init__()
        self.w1, self.b1, self.w2 = (nn.Parameter(torch.tensor(a))
                                     for a in (w1, b1, w2))


def toy_fn(stage, x):
    return x + torch.tanh(x @ stage.w1 + stage.b1) @ stage.w2


def _jtoy(params, x):
    w1, b1, w2 = params
    return x + jnp.tanh(x @ w1 + b1) @ w2


def _toy_params(seed, *lead):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=lead + s) * sc).astype(np.float32)
            for s, sc in (((HID, HID), 0.3), ((HID,), 0.1),
                          ((HID, HID), 0.3))]


class ToyModel(nn.Module):
    """``n`` toy stages in a row (the model a pipe group of one runs)."""

    def __init__(self, params):
        super().__init__()
        self.stages = nn.ModuleList(Toy(*(a[i] for a in params))
                                    for i in range(params[0].shape[0]))

    def forward(self, x):
        for s in self.stages:
            x = toy_fn(s, x)
        return x


@pytest.mark.parametrize("m", [1, 3, 4])
def test_no_pipelining_matches_jax(m):
    params = _toy_params(0, 2)
    batch = np.random.default_rng(1).normal(
        size=(m * MB, SEQ, HID)).astype(np.float32)

    def jfwd(p, mb):
        for s in range(2):
            mb = _jtoy([a[s] for a in p], mb)
        return jnp.mean(mb ** 2)
    want_loss, want = js.forward_backward_no_pipelining(
        jfwd, jnp.asarray(batch), [jnp.asarray(a) for a in params],
        num_microbatches=m)
    model = ToyModel(params)
    loss, grads = S.forward_backward_no_pipelining(
        lambda mod, mb: torch.mean(mod(mb) ** 2), torch.tensor(batch), model,
        num_microbatches=m)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for i, name in enumerate(("w1", "b1", "w2")):
        for s in range(2):
            np.testing.assert_allclose(
                grads[f"stages.{s}.{name}"].numpy(), np.asarray(want[i][s]),
                rtol=1e-5, atol=1e-6)


def test_no_pipelining_takes_the_microbatch_count_from_the_calculator():
    mb_lib.setup_microbatch_calculator(global_batch_size=8,
                                       micro_batch_size=2)
    try:
        model = ToyModel(_toy_params(2, 1))
        seen = []
        S.forward_backward_no_pipelining(
            lambda mod, mb: seen.append(mb.shape[0]) or mod(mb).sum(),
            torch.zeros(8, SEQ, HID), model)
        assert seen == [2] * 4
    finally:
        mb_lib.destroy_microbatch_calculator()


def _grads(model):
    return [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("v,m", [(1, 1), (1, 5), (2, 3), (3, 2)])
def test_a_pipe_of_one_equals_no_pipelining_bitwise(v, m):
    # no mesh: one process is one stage; its V chunks run in turn
    params = _toy_params(3, v)
    batch = torch.tensor(np.random.default_rng(4).normal(
        size=(m * MB, SEQ, HID)).astype(np.float32))
    ref = ToyModel(params)
    want_loss, _ = S.forward_backward_no_pipelining(
        lambda mod, mb: torch.mean(mod(mb) ** 2), batch, ref,
        num_microbatches=m)
    model = ToyModel(params)
    loss_fn = lambda y, i: torch.mean(y ** 2)
    if v == 1:
        loss, grads = S.forward_backward_pipelining_without_interleaving(
            toy_fn, loss_fn, model.stages[0], batch, num_microbatches=m)
        assert set(grads) == {"w1", "b1", "w2"}
    else:
        loss, grads = S.forward_backward_pipelining_with_interleaving(
            toy_fn, loss_fn, model.stages, batch, num_microbatches=m)
        assert "1.w1" in grads
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(_grads(model), _grads(ref)))
    assert S.last_run["peak_live"] == v     # one graph a chunk


def test_a_pipe_of_one_closes_the_input_and_the_loss_params():
    # return_input_cotangents and loss_params at one stage: dL/dh of each
    # microbatch and the head's gradient, as autograd of the whole model
    params = _toy_params(5, 1)
    head = torch.tensor(np.random.default_rng(6).normal(
        size=(HID, 3)).astype(np.float32))
    h = torch.tensor(np.random.default_rng(7).normal(
        size=(4 * MB, SEQ, HID)).astype(np.float32))
    ref, hr, hh = ToyModel(params), h.clone().requires_grad_(True), \
        head.clone().requires_grad_(True)
    torch.mean(torch.stack([torch.mean((ref(x) @ hh) ** 2)
                            for x in hr.chunk(4)])).backward()
    model, hp = ToyModel(params), head.clone().requires_grad_(True)
    loss, _, aux = S.forward_backward_pipelining_without_interleaving(
        toy_fn, lambda lp, y, i: torch.mean((y @ lp[0]) ** 2),
        model.stages[0], h, num_microbatches=4, loss_params=[hp],
        return_input_cotangents=True)
    assert aux["input_cotangents"].shape == (4, MB, SEQ, HID)
    torch.testing.assert_close(aux["input_cotangents"].reshape(h.shape),
                               hr.grad, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(aux["loss_params_grads"][0], hh.grad,
                               rtol=1e-6, atol=1e-7)
    assert aux["loss_params_grads"][0] is hp.grad
    with pytest.raises(ValueError, match="leaf"):
        S.forward_backward_pipelining_without_interleaving(
            toy_fn, lambda lp, y, i: y.sum(), model.stages[0], h,
            num_microbatches=4, loss_params=[hp * 2])


def test_interleaving_needs_m_divisible_by_pp():
    with pytest.raises(ValueError, match="num_microbatches"):
        S._check_interleaved(3, 2)


def test_p2p_at_a_pipe_of_one_calls_nothing():
    x = torch.randn(2, 3, requires_grad=True)
    assert p2p.send_forward_recv_forward(x) is x
    assert p2p.send_backward_recv_backward(x) is x
    assert p2p.recv_forward((2, 3), torch.float32) is None
    assert p2p.recv_backward((2, 3), torch.float32) is None
    p2p.send_forward(x)
    p2p.send_backward(x)


def test_dispatch_is_the_jax_one():
    for args in ((1,), (2,), (2, 2), (2, 1), (4, None)):
        assert S.get_forward_backward_func(*args).__name__ == \
            js.get_forward_backward_func(*args).__name__


# --------------------------------------------------------------------- #
# build_model and the weights carried across
# --------------------------------------------------------------------- #
GPT_LAYER = dict(vocab_size=64, hidden_size=32, num_heads=2, max_seq_len=8)


@pytest.mark.parametrize("v", [None, 2])
def test_build_model_layer_order_matches_jax(v):
    from apex_tpu.models import ParallelTransformerLayer as JLayer
    from apex_tpu.models import TransformerConfig as JTCfg
    from apex_tpu.transformer.pipeline_parallel import build_model as jbuild
    from apex_tpu_torch.models.gpt import GPTConfig
    from apex_tpu_torch.models.transformer import ParallelTransformerLayer

    x = np.random.default_rng(9).normal(size=(2, 8, 32)).astype(np.float32)
    jfn, stacked, _ = jbuild(
        JLayer(JTCfg(num_layers=1, dtype=jnp.float32, **GPT_LAYER)), 4, 2, v,
        rng=jax.random.PRNGKey(2), sample_input=jnp.zeros((2, 8, 32)))
    cfg = GPTConfig.tiny(**GPT_LAYER)
    # one process without a mesh is pipe rank 0; rank r's chunks have the
    # same layers, and stage_layers names the global ones its weights are
    fn, chunks = build.build_model(
        functools.partial(ParallelTransformerLayer, cfg), 4, 2, v,
        device="cpu")
    assert len(chunks) == (v or 1)
    for r in range(2):
        for c, chunk in enumerate(chunks):
            assert len(chunk) == 4 // (2 * (v or 1))
            chunk.load_state_dict(stage_params_from_jax(
                jax.device_get(stacked), stage=r, chunk=c))
            row = (lambda a: a[r]) if v is None else (lambda a: a[c, r])
            want = np.asarray(jax.jit(jfn)(jax.tree.map(row, stacked),
                                           jnp.asarray(x)))
            got = fn(chunk, torch.tensor(x)).detach().numpy()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
            first = (c * 2 + r) * len(chunk)
            assert build.stage_layers(4, 2, v, rank=r, chunk=c) == range(
                first, first + len(chunk))


def test_build_model_layer_remat_keeps_values_and_gradients():
    from apex_tpu_torch.models.gpt import GPTConfig
    from apex_tpu_torch.models.transformer import (
        ParallelTransformerLayer,
        init_module_weights,
    )

    gen = torch.Generator().manual_seed(7)

    def make(device):
        layer = ParallelTransformerLayer(GPTConfig.tiny(**GPT_LAYER),
                                         device=device)
        init_module_weights(layer, gen)     # the factory seeds its layers
        return layer
    remat_fn, chunks = build.build_model(make, 4, 2, 2, device="cpu",
                                         layer_remat=True)
    assert [len(c) for c in chunks] == [1, 1]
    plain_fn, _ = build.build_model(make, 2, 1, device="cpu")
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(2, 8, 32)).astype(np.float32))
    outs, grads = [], []
    for fn in (plain_fn, remat_fn):
        xi = x.clone().requires_grad_(True)
        y = fn(chunks[0], xi)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append([xi.grad] + [p.grad.clone()
                                  for p in chunks[0].parameters()])
        chunks.zero_grad(set_to_none=True)
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(ValueError, match="divisible"):
        build.build_model(make, 5, 2, device="cpu")


def test_closure_params_from_jax_names_and_layout():
    rng = np.random.default_rng(3)
    cl = dict(embed=rng.normal(size=(8, 4)), pos=rng.normal(size=(5, 4)),
              head=rng.normal(size=(4, 8)), fln_scale=rng.normal(size=4),
              fln_bias=rng.normal(size=4), stages=None)
    sd = closure_params_from_jax(cl)
    assert sorted(sd) == ["embedding.weight", "final_norm.bias",
                          "final_norm.weight", "lm_head.weight",
                          "position_embedding"]
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(), cl["head"].T)
    half = closure_params_from_jax(cl, tp_rank=1, tp=2)
    np.testing.assert_array_equal(half["embedding.weight"].numpy(),
                                  cl["embed"][4:])
    np.testing.assert_array_equal(half["lm_head.weight"].numpy(),
                                  cl["head"].T[4:])


# --------------------------------------------------------------------- #
# a world of one
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world_of_one():
    from apex_tpu_torch.core.mesh import initialize_mesh
    from apex_tpu_torch.parallel import launch

    launch.init_distributed(device="cpu")
    try:
        yield initialize_mesh()
    finally:
        launch.destroy_distributed()


def test_broadcast_data_at_a_tensor_group_of_one(world_of_one):
    from apex_tpu_torch.transformer.data import broadcast_data

    data = {"text": torch.arange(6).view(2, 3), "mask": torch.ones(2, 3,
                                                                   dtype=torch.int64)}
    out = broadcast_data(["text", "mask"], data, torch.int64)
    assert out["text"] is data["text"] and out["mask"] is data["mask"]
    with pytest.raises(KeyError, match="missing key 'x'"):
        broadcast_data(["x"], data, torch.int64)
    with pytest.raises(TypeError, match="dtype"):
        broadcast_data(["text"], data, torch.int32)


def test_stage_local_state_at_a_world_of_one(world_of_one):
    from apex_tpu_torch.core.train_state import MixedPrecisionTrainState
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel.distributed_optim import ZeroConfig

    model = nn.Module()
    model.stages = Toy(*_toy_params(8))
    plain = MixedPrecisionTrainState.create(model=model,
                                            optimizer=fused_adam(1e-2))
    with pytest.raises(ValueError, match="zero-mode"):
        pl.stage_local_zero(plain, num_stages=1)
    state = MixedPrecisionTrainState.create(
        model=model, optimizer=fused_adam(1e-2),
        zero=ZeroConfig(axis="data", stage=2))
    assert pl.stage_local_zero(state, num_stages=1) is state
    with pytest.raises(ValueError, match="pipe ranks"):
        pl.stage_local_zero(state, num_stages=2)
    with pytest.raises(ValueError, match="not found"):
        pl.stage_local_zero(state, num_stages=1, staged=("layers",))
    lay = pl.pipeline_state_layout(state)
    assert lay == dict(stage=0, num_stages=1, params=2 * HID * HID + HID,
                       shard=0, num_shards=1,
                       master_elements=2 * HID * HID + HID)
    staged = pl.stage_split({"w": torch.arange(4.0)}, 1)
    assert torch.equal(pl.local_stage(staged)["w"], torch.arange(4.0))
    g = {"a": torch.tensor([1.0, float("inf")])}
    assert pl.sync_grad_overflow(g) is g and torch.isinf(g["a"][1])


def test_moe_layer_keeps_its_tp1_path(world_of_one):
    # C-13's gather runs only at tp > 1: a mesh of one tensor rank (or
    # none) keeps the chunk path, and its outputs, as before
    from apex_tpu_torch.models.gpt import GPTConfig
    from apex_tpu_torch.models.transformer import ParallelTransformerLayer
    from apex_tpu_torch.transformer.testing.commons import without_mesh

    cfg = GPTConfig.tiny(**GPT_LAYER, num_moe_experts=4, moe_top_k=2,
                         sequence_parallel=True)
    layer = ParallelTransformerLayer(cfg, device="cpu")
    assert layer.seq_chunk == (0, 1) and not layer.moe_whole_sequence
    with without_mesh():
        assert not ParallelTransformerLayer(
            cfg, device="cpu").moe_whole_sequence


# --------------------------------------------------------------------- #
# public names
# --------------------------------------------------------------------- #
#: JAX names with no torch counterpart (ROADMAP.md, out-of-scope JAX
#: tooling): shardings and PartitionSpec placement of global arrays
JAX_ONLY = {"model_replicated_sharding", "stage_specs", "stage_shardings",
            "pipeline_state_specs", "pipeline_state_shardings"}


@pytest.mark.parametrize("mod", [
    "transformer.microbatches", "transformer.data",
    "transformer.pipeline_parallel", "transformer.pipeline_parallel.p2p",
    "transformer.pipeline_parallel.schedules",
    "transformer.pipeline_parallel.build", "parallel.pipeline"])
def test_the_jax_modules_public_names_are_ported(mod):
    import importlib

    jax_mod = importlib.import_module(f"apex_tpu.{mod}")
    port = importlib.import_module(f"apex_tpu_torch.{mod}")
    for name in set(jax_mod.__all__) - JAX_ONLY:
        assert name in port.__all__ and hasattr(port, name), (mod, name)


@pytest.mark.parametrize("pkg,names", [
    ("transformer", ["data", "microbatches", "pipeline_parallel",
                     "broadcast_data", "setup_microbatch_calculator",
                     "get_num_microbatches"]),
    ("parallel", ["bubble_fraction", "schedule_ticks", "live_microbatches",
                  "stage_split", "stage_unsplit", "stage_local_zero",
                  "sync_grad_overflow", "run_1f1b", "wrap_pipeline_step"])])
def test_package_exports_are_the_jax_ones(pkg, names):
    import importlib

    jax_pkg = importlib.import_module(f"apex_tpu.{pkg}")
    port = importlib.import_module(f"apex_tpu_torch.{pkg}")
    for name in names:
        assert name in jax_pkg.__all__, name
        assert name in port.__all__ and hasattr(port, name), name
