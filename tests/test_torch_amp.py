"""The port's amp core held against the JAX package's.

Precision policies (which BERT leaves stay fp32 under O2), the dynamic
loss-scale state machine over a planted sequence of finite and
non-finite steps (scale, tracker and event tallies equal to the JAX
scaler's), an fp16 O2 step with a planted overflow (parameters and
optimizer state bit-unchanged, scale halved), FusedAdam against the JAX
``fused_adam`` over three steps (AdamW and L2, bias correction; fp32
within 1e-6), and the ``amp`` frontend.  The public API restored for
parity — ``PrecisionPolicy.with_overrides`` / ``cast_to_output``,
``tree_cast``, ``MixedPrecisionTrainState.compute_params``,
``select_step`` / ``backoff_exhausted`` and the package's top-level
re-exports — against the JAX counterparts.  All on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.core.loss_scale import DynamicLossScale as JaxDynamicLossScale
from apex_tpu.core.loss_scale import StaticLossScale as JaxStaticLossScale
from apex_tpu.core.precision import PrecisionPolicy as JaxPolicy
from apex_tpu.core.precision import tree_cast as jax_tree_cast
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.optim import fused_adam as jax_fused_adam
from apex_tpu.utils.metrics import counters as jax_counters
from apex_tpu_torch import amp
from apex_tpu_torch.core import (
    DynamicLossScale,
    MixedPrecisionTrainState,
    NoOpLossScale,
    PrecisionPolicy,
    StaticLossScale,
    all_finite,
    norm_param_filter,
    tree_cast,
)
from apex_tpu_torch.models import BertConfig, BertModel, params_from_jax
from apex_tpu_torch.optim import fused_adam
from apex_tpu_torch.utils.metrics import loss_scale_tallies


class TestPrecision:
    def test_o2_keeps_the_same_bert_leaves_fp32_as_jax(self):
        cfg = BertConfig.tiny(num_layers=1)
        jm = JaxBertModel(JaxBertConfig.tiny(num_layers=1,
                                             scan_layers=False))
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
        cast = JaxPolicy.from_opt_level("O2").cast_to_compute(params)
        # mark each JAX leaf 1 where O2 keeps it fp32, and carry the
        # marks over to the port's names
        marks = jax.tree.map(
            lambda a: np.full(a.shape, float(a.dtype == jnp.float32),
                              np.float32), cast)
        jax_fp32 = {n for n, t in params_from_jax(marks, cfg).items()
                    if float(t.flatten()[0]) == 1.0}
        model = BertModel(cfg, device="cpu")
        sd = PrecisionPolicy.from_opt_level("O2").cast_to_compute(
            model.state_dict())
        port_fp32 = {n for n, t in sd.items() if t.dtype == torch.float32}
        assert port_fp32 == jax_fp32
        assert len(port_fp32) == 8 and all("norm" in n for n in port_fp32)

    @pytest.mark.parametrize("name,expect", [
        ("transformer.layers.3.input_norm.weight", True),
        ("emb_norm_scale", True), ("mlm_norm.bias", True),
        ("features.bn1.weight", True), ("encoder.LayerNorm.weight", True),
        ("transformer.layers.3.mlp.dense_h_to_4h.weight", False),
        ("embedding.weight", False), ("mlm_bias", False)])
    def test_norm_filter(self, name, expect):
        assert norm_param_filter(name) is expect

    @pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
    @pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
    def test_opt_levels_match_jax(self, level, half):
        jhalf = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
        ref = JaxPolicy.from_opt_level(level, half_dtype=jhalf[half])
        got = PrecisionPolicy.from_opt_level(level, half_dtype=half)
        for field in ("keep_batchnorm_fp32", "master_weights",
                      "loss_scale", "per_op_casting"):
            assert getattr(got, field) == getattr(ref, field), field
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(got, field)).split(".")[-1] == \
                jnp.dtype(getattr(ref, field)).name, field
        assert got.needs_loss_scaling == ref.needs_loss_scaling

    def test_module_cast_and_master_copy(self):
        model = BertModel(BertConfig.tiny(num_layers=1), device="cpu")
        pol = PrecisionPolicy.O2()
        masters = pol.master_params(model)
        pol.cast_to_param(model)
        assert model.embedding.weight.dtype == torch.bfloat16
        assert model.emb_norm_scale.dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in masters.values())

    def test_unknown_level_raises(self):
        with pytest.raises(ValueError, match="O4"):
            PrecisionPolicy.from_opt_level("O4")


class TestRestoredApi:
    """Public API of the JAX package's core, held against it."""

    def test_with_overrides_matches_jax(self):
        ref = JaxPolicy.O2().with_overrides(loss_scale=128.0,
                                            keep_batchnorm_fp32=False)
        got = PrecisionPolicy.O2().with_overrides(loss_scale=128.0,
                                                  keep_batchnorm_fp32=False)
        assert got.loss_scale == ref.loss_scale == 128.0
        assert got.keep_batchnorm_fp32 is ref.keep_batchnorm_fp32 is False
        assert got.opt_level == ref.opt_level == "O2"
        assert got.needs_loss_scaling == ref.needs_loss_scaling
        assert PrecisionPolicy.O2().loss_scale is None   # unchanged
        with pytest.raises(TypeError):
            PrecisionPolicy.O2().with_overrides(no_such_field=1)

    @pytest.mark.parametrize("with_filter", [False, True])
    def test_tree_cast_matches_jax(self, with_filter):
        rng = np.random.default_rng(4)
        a, b = (rng.normal(size=(3, 2)).astype(np.float32) for _ in "ab")
        i = np.arange(4, dtype=np.int32)
        jtree = {"dense": {"kernel": jnp.asarray(a)},
                 "layer_norm": [jnp.asarray(b), jnp.asarray(i)], "n": 3}
        ttree = {"dense": {"kernel": torch.from_numpy(a)},
                 "layer_norm": [torch.from_numpy(b), torch.from_numpy(i)],
                 "n": 3}

        def keep(path, leaf):
            return any("norm" in str(getattr(k, "key", k)) for k in path)
        flt = keep if with_filter else None
        ref = jax_tree_cast(jtree, jnp.bfloat16, keep_fp32_filter=flt)
        got = tree_cast(ttree, torch.bfloat16, keep_fp32_filter=flt)
        assert got["n"] == ref["n"] == 3
        for g, r in ((got["dense"]["kernel"], ref["dense"]["kernel"]),
                     (got["layer_norm"][0], ref["layer_norm"][0]),
                     (got["layer_norm"][1], ref["layer_norm"][1])):
            assert str(g.dtype).split(".")[-1] == jnp.dtype(r.dtype).name
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(r.astype(jnp.float32)))
        assert isinstance(got["layer_norm"], list)
        assert tree_cast(ttree, None) is ttree

    @pytest.mark.parametrize("level", ["O0", "O2"])
    def test_cast_to_output_matches_jax(self, level):
        x = np.linspace(-2, 2, 7, dtype=np.float32)
        ref = JaxPolicy.from_opt_level(level).cast_to_output(
            {"y": jnp.asarray(x)})
        got = PrecisionPolicy.from_opt_level(level).cast_to_output(
            {"y": torch.from_numpy(x)})
        assert str(got["y"].dtype).split(".")[-1] == \
            jnp.dtype(ref["y"].dtype).name
        np.testing.assert_array_equal(got["y"].float().numpy(),
                                      np.asarray(ref["y"], np.float32))

    def test_compute_params_is_the_o2_model_copy(self):
        model, state = _tiny_state("O2", torch.bfloat16)
        cp = state.compute_params()
        assert set(cp) == set(state.params)
        assert cp["fc1.weight"].dtype == torch.bfloat16
        assert cp["mid_norm.weight"].dtype == torch.float32
        assert torch.equal(cp["fc1.weight"],
                           state.params["fc1.weight"].bfloat16())
        assert torch.equal(cp["fc1.weight"], model.fc1.weight)

    def test_select_step_matches_jax(self):
        ls, jls = DynamicLossScale(), JaxDynamicLossScale()
        new = {"w": np.ones(3, np.float32), "s": [np.full(2, 5.0,
                                                          np.float32)]}
        old = {"w": np.zeros(3, np.float32), "s": [np.full(2, 7.0,
                                                           np.float32)]}

        def tt(tree):
            return {"w": torch.from_numpy(tree["w"]),
                    "s": [torch.from_numpy(tree["s"][0])]}

        def jt(tree):
            return {"w": jnp.asarray(tree["w"]),
                    "s": [jnp.asarray(tree["s"][0])]}
        for flag in (True, False):
            got = ls.select_step(torch.tensor(flag), tt(new), tt(old))
            ref = jls.select_step(jnp.asarray(flag), jt(new), jt(old))
            np.testing.assert_array_equal(got["w"].numpy(),
                                          np.asarray(ref["w"]))
            np.testing.assert_array_equal(got["s"][0].numpy(),
                                          np.asarray(ref["s"][0]))

    def test_backoff_exhausted_matches_jax(self):
        kw = dict(init_scale=4.0, min_scale=1.0, growth_interval=100)
        ls, jls = DynamicLossScale(**kw), JaxDynamicLossScale(**kw)
        st, jst = ls.init(), jls.init()
        for _ in range(4):
            assert bool(ls.backoff_exhausted(st)) == bool(
                jls.backoff_exhausted(jst))
            st = ls.adjust(st, torch.tensor(False))
            jst = jls.adjust(jst, jnp.asarray(False))
        assert bool(ls.backoff_exhausted(st))
        s, js = StaticLossScale(8.0), JaxStaticLossScale(8.0)
        assert bool(s.backoff_exhausted(s.init())) == bool(
            js.backoff_exhausted(js.init()))

    def test_top_level_reexports(self):
        import apex_tpu
        import apex_tpu_torch
        for name in ("PrecisionPolicy", "LossScaleState", "DynamicLossScale",
                     "StaticLossScale", "NoOpLossScale", "all_finite"):
            assert hasattr(apex_tpu, name)
            assert name in apex_tpu_torch.__all__
            assert getattr(apex_tpu_torch, name) is getattr(
                __import__("apex_tpu_torch.core", fromlist=[name]), name)


# planted finiteness sequence: overflows at the start, a clean run that
# crosses the growth interval twice, an overflow in the middle
PLANTED = [False, False, True, True, True, True, True, False, True, True,
           True, True, True, True, True, True, False]


class TestLossScale:
    def test_state_machine_matches_jax(self):
        kw = dict(init_scale=2.0 ** 10, growth_interval=4,
                  max_scale=2.0 ** 11, min_scale=2.0 ** 8)
        jls = JaxDynamicLossScale(**kw)
        ls = DynamicLossScale(**kw)
        jstate, state = jls.init(), ls.init()
        jax_counters.reset()
        for flag in PLANTED:
            jstate = jls.adjust(jstate, jnp.asarray(flag))
            state = ls.adjust(state, torch.tensor(flag))
            assert float(state.loss_scale) == float(jstate.loss_scale)
            assert int(state.growth_tracker) == int(jstate.growth_tracker)
        jax.effects_barrier()
        ref = jax_counters.snapshot()
        assert loss_scale_tallies(state) == {
            "amp.loss_scale.growth": ref.get("amp.loss_scale.growth", 0),
            "amp.loss_scale.backoff": ref.get("amp.loss_scale.backoff", 0)}
        assert state.state_dict() == jstate.state_dict()

    def test_scale_unscale_and_static_noop(self):
        ls = DynamicLossScale()
        st = ls.init()
        loss = torch.tensor(2.0, dtype=torch.bfloat16)
        assert ls.scale(st, loss).dtype == torch.float32
        assert float(ls.scale(st, loss)) == 2.0 * 2 ** 16
        g = [torch.full((3,), 2.0 ** 16)]
        ls.unscale_(st, g)
        assert torch.equal(g[0], torch.ones(3))
        s = StaticLossScale(128.0)
        st2 = s.init()
        assert float(s.scale(st2, loss)) == 256.0
        assert s.adjust(st2, torch.tensor(False)) is st2
        n = NoOpLossScale()
        assert n.scale(n.init(), loss) is loss

    def test_all_finite(self):
        assert bool(all_finite([torch.ones(3), torch.zeros(2)]))
        assert not bool(all_finite([torch.ones(3),
                                    torch.tensor([1.0, float("inf")])]))
        assert not bool(all_finite([torch.tensor([float("nan")])]))
        assert bool(all_finite([torch.arange(3)]))


class _Tiny(torch.nn.Module):
    """linear → LayerNorm → linear; the norm is found by its name."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 8)
        self.mid_norm = torch.nn.LayerNorm(8)
        self.fc2 = torch.nn.Linear(8, 2)

    def forward(self, x):
        h = self.mid_norm(self.fc1(x).float())
        return self.fc2(h.to(self.fc2.weight.dtype))


def _tiny_state(opt_level, half=None, lr=1e-2):
    torch.manual_seed(0)
    model = _Tiny()
    return model, amp.initialize(model, fused_adam(lr), opt_level,
                                 half_dtype=half)


class TestTrainState:
    def test_fp16_overflow_skips_the_step_and_halves_the_scale(self):
        model, state = _tiny_state("O2", torch.float16)
        assert state.policy.loss_scale == "dynamic"
        x = torch.randn(4, 8).half()
        # a mean loss: at the 2**16 start scale its fp16 grads fit
        state.scale_loss(model(x).float().mean()).backward()
        assert bool(state.apply_gradients())
        before = {n: p.clone() for n, p in state.params.items()}
        module_before = [p.clone() for p in model.parameters()]
        moments = [t.clone() for t in state.opt_state.exp_avg]
        scale = float(state.loss_scale_state.loss_scale)
        count = int(state.opt_state.count)
        state.scale_loss(model(x).float().mean()).backward()
        next(model.parameters()).grad[0, 0] = float("inf")    # planted
        finite = state.apply_gradients()
        assert not bool(finite)
        for n, p in state.params.items():
            assert torch.equal(p, before[n]), n
        for p, q in zip(model.parameters(), module_before):
            assert torch.equal(p, q)
        for a, b in zip(state.opt_state.exp_avg, moments):
            assert torch.equal(a, b)
        assert int(state.opt_state.count) == count
        assert float(state.loss_scale_state.loss_scale) == scale / 2
        assert loss_scale_tallies(state.loss_scale_state)[
            "amp.loss_scale.backoff"] == 1

    def test_o2_masters_and_compute_copy(self):
        model, state = _tiny_state("O2", torch.bfloat16)
        assert model.fc1.weight.dtype == torch.bfloat16
        assert model.mid_norm.weight.dtype == torch.float32   # norm kept
        assert all(p.dtype == torch.float32 for p in state.params.values())
        x = torch.randn(4, 8).to(torch.bfloat16)
        state.scale_loss(model(x).float().pow(2).sum()).backward()
        master0 = state.params["fc1.weight"].clone()
        assert bool(state.apply_gradients())
        assert model.fc1.weight.grad is None
        assert not torch.equal(state.params["fc1.weight"], master0)
        torch.testing.assert_close(model.fc1.weight,
                                   state.params["fc1.weight"].bfloat16(),
                                   rtol=0, atol=0)

    def test_o0_trains_the_module_params_in_place(self):
        model, state = _tiny_state("O0")
        before = model.fc1.weight.detach().clone()
        state.scale_loss(model(torch.randn(4, 8)).sum()).backward()
        state.apply_gradients()
        assert not torch.equal(model.fc1.weight, before)
        assert model.fc1.weight.data_ptr() == \
            state.params["fc1.weight"].data_ptr()

    def test_o1_trains_fp32_params_on_a_half_compute_copy(self):
        """O1 (amp's default level): the module keeps fp32 parameters,
        views of the flat buffer, with no masters; its forward runs on
        an fp16 copy with the norm fp32; fp16 gets the dynamic scale; the
        gradients land fp32 and the steps train."""
        model, state = _tiny_state("O1", torch.float16)
        assert state.policy.opt_level == "O1"
        assert state.policy.loss_scale == "dynamic"
        assert not state.policy.master_weights and len(state.groups) == 1
        seen = {}
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, n=n:
            seen.setdefault(n, mod.weight.dtype) and None)
            for n, m in model.named_children()]
        x = torch.randn(4, 8).half()
        losses = []
        for _ in range(3):
            loss = model(x).float().square().mean()
            state.scale_loss(loss).backward()
            assert model.fc1.weight.grad.dtype == torch.float32
            assert bool(state.apply_gradients())
            losses.append(loss.item())
        for h in hooks:
            h.remove()
        assert seen == {"fc1": torch.float16, "mid_norm": torch.float32,
                        "fc2": torch.float16}
        assert losses[-1] < losses[0]
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32
            assert p.data_ptr() == state.params[name].data_ptr()
        assert "weight" not in model.fc1.__dict__
        cp = state.compute_params()
        assert cp["fc1.weight"].dtype == torch.float16
        assert cp["mid_norm.weight"].dtype == torch.float32
        # the default opt level is O1, as the reference's
        assert amp.initialize(_Tiny(), fused_adam()).policy.opt_level == "O1"

    def test_deferred_features_name_their_roadmap_items(self):
        # ZeRO (item 10a) is ported: in a world of one the zero-mode O2
        # step is the plain O2 step bit for bit (one rank's reduce-scatter
        # and all-gather move nothing), and fp8 moments, laid over whole
        # parameters, are refused with it
        from apex_tpu_torch.core.mesh import initialize_mesh
        from apex_tpu_torch.parallel import launch
        from apex_tpu_torch.parallel.distributed_optim import ZeroConfig

        def run(zero):
            torch.manual_seed(0)
            model = _Tiny()
            state = MixedPrecisionTrainState.create(
                model=model, optimizer=fused_adam(1e-2),
                policy=PrecisionPolicy.from_opt_level(
                    "O2", half_dtype=torch.bfloat16),
                zero=zero)
            x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
            for _ in range(3):
                loss = model(x.bfloat16()).float().square().mean()
                state.scale_loss(loss).backward()
                state.apply_gradients()
            return ({n: t.clone() for n, t in state.master_params().items()},
                    [p.detach().clone() for p in model.parameters()])
        plain = run(None)
        assert not launch.is_distributed()
        launch.init_distributed(device="cpu")
        try:
            initialize_mesh()
            zero = run(ZeroConfig(axis="data", stage=2))
            with pytest.raises(ValueError, match="fp8"):
                MixedPrecisionTrainState.create(
                    model=_Tiny(),
                    optimizer=fused_adam(moment_format="fp8_block_scaled"),
                    zero=ZeroConfig(axis="data"))
        finally:
            launch.destroy_distributed()
        assert plain[0].keys() == zero[0].keys()
        for n in plain[0]:
            assert torch.equal(plain[0][n], zero[0][n]), n
        for a, b in zip(plain[1], zero[1]):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="stage"):
            ZeroConfig(stage=3, axis_size=1).resolved()
        # fp8 moments are ported (kernel B-18): the optimizer builds
        opt = fused_adam(moment_format="fp8_block_scaled")
        assert opt.moment_format == "fp8_block_scaled" and opt.per_leaf


class TestFrontend:
    def test_list_form_and_state_dict_round_trip(self):
        m1, m2 = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
        s1, s2 = amp.initialize([m1, m2], [fused_adam(), fused_adam()],
                                "O2", half_dtype=torch.float16)
        assert s1.loss_scale_state is not s2.loss_scale_state
        d = amp.state_dict(s1)
        assert d == {"loss_scale": 2.0 ** 16, "unskipped": 0}
        amp.load_state_dict(s2, {"loss_scale": 8.0, "unskipped": 3})
        assert amp.state_dict(s2) == {"loss_scale": 8.0, "unskipped": 3}
        assert all(t.dtype == torch.float32 for t in amp.master_params(s1))
        with pytest.raises(ValueError, match="list"):
            amp.initialize(m1, [fused_adam(), fused_adam()], "O0")

    def test_overrides(self):
        _, state = _tiny_state("O2", torch.bfloat16)
        assert state.policy.loss_scale is None
        st = amp.initialize(torch.nn.Linear(4, 4), fused_adam(), "O2",
                            loss_scale=128.0, keep_batchnorm_fp32=False)
        assert isinstance(st.loss_scaler, StaticLossScale)
        assert float(st.loss_scale_state.loss_scale) == 128.0


class TestFusedAdam:
    @pytest.mark.parametrize("adam_w_mode", [True, False])
    @pytest.mark.parametrize("bias_correction", [True, False])
    def test_three_steps_match_jax(self, adam_w_mode, bias_correction):
        rng = np.random.default_rng(8)
        shapes = [(5, 3), (7,)]
        params = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        kw = dict(weight_decay=0.01, adam_w_mode=adam_w_mode,
                  bias_correction=bias_correction)
        tx = jax_fused_adam(1e-2, **kw)
        jp = [jnp.asarray(p) for p in params]
        jst = tx.init(jp)
        opt = fused_adam(1e-2, **kw)
        tp = [torch.from_numpy(p.copy()) for p in params]
        st = opt.init(tp)
        for g in grads:
            upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
            jp = [p + u for p, u in zip(jp, upd)]
            opt.step([torch.from_numpy(x) for x in g], st, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(st.exp_avg_sq, jst.exp_avg_sq):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        assert int(st.count) == int(jst.count) == 3

    def test_moment_dtype_and_skip(self):
        opt = fused_adam(1e-2, moment_dtype=torch.bfloat16)
        p = [torch.ones(4)]
        st = opt.init(p)
        assert st.exp_avg[0].dtype == torch.bfloat16
        opt.step([torch.ones(4)], st, p, finite=torch.tensor(False))
        assert torch.equal(p[0], torch.ones(4)) and int(st.count) == 0
        opt.step([torch.ones(4)], st, p, finite=torch.tensor(True))
        assert int(st.count) == 1 and float(p[0][0]) < 1.0
