"""The port's amp core held against the JAX package's.

Precision policies (which BERT leaves stay fp32 under O2), the dynamic
loss-scale state machine over a planted sequence of finite and
non-finite steps (scale, tracker and event tallies equal to the JAX
scaler's), an fp16 O2 step with a planted overflow (parameters and
optimizer state bit-unchanged, scale halved), FusedAdam against the JAX
``fused_adam`` over three steps (AdamW and L2, bias correction; fp32
within 1e-6), and the ``amp`` frontend.  All on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.core.loss_scale import DynamicLossScale as JaxDynamicLossScale
from apex_tpu.core.precision import PrecisionPolicy as JaxPolicy
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

    def test_deferred_features_name_their_roadmap_items(self):
        model = torch.nn.Linear(2, 2)
        with pytest.raises(NotImplementedError, match="A-6"):
            amp.initialize(model, fused_adam(), "O1")
        with pytest.raises(NotImplementedError, match="A-5"):
            MixedPrecisionTrainState.create(model=model,
                                            optimizer=fused_adam(),
                                            zero=object())
        with pytest.raises(NotImplementedError, match="A-6"):
            fused_adam(moment_format="fp8_block_scaled")


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
