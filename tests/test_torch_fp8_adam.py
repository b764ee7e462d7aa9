"""The port's FusedAdam with fp8 block-scaled moments held against the
JAX package's ``fused_adam(moment_format="fp8_block_scaled")``.

- Quantization: ``_fp8_quant`` / ``_fp8_dequant`` and ``_fp8_pad``
  against the JAX functions, codes and scales bitwise, on data spanning
  1e-12 to 1e4 with ragged tails.
- Three steps against the JAX XLA path run eagerly
  (``APEX_TPU_OPS_IMPL=xla``), for leaves of 7, 300 and 16384 + 300
  elements, weight decay 0 / 0.01 × AdamW / L2: parameters, codes and
  scales bitwise equal in every case (the bias corrections,
  ``torch.pow`` against ``jnp.power``, agree bit for bit at these
  counts; the plain step takes its root in float64, since torch's fp32
  ``sqrt`` on the CPU is not correctly rounded and JAX's and the
  kernel's ``__fsqrt_rn`` are).
- Three steps against the JAX Pallas kernel in interpret mode for the
  16384 + 300 leaf, at the JAX package's own kernel-vs-XLA tolerances.
- The per-leaf layout through ``amp.initialize(..., "O2")``: each
  parameter padded on its own, no 256-block spanning two; a linear
  layer's moments in the JAX kernel's (transposed) order.
- A non-finite step leaves every tensor of the state bitwise unchanged.
- Resuming from a JAX state (one-layer tiny BERT, 2 steps, dense and fp8) through
  ``named_leaves_from_jax`` and ``load_jax_opt_state``: the loaded codes
  equal JAX's, and a third step on both sides agrees.
- One-layer tiny BERT, 3 amp steps with fp8 moments against ``jax.grad`` + the JAX
  optimizer: O0 fp32 losses within 1e-5 and parameters within 1e-5 (eps
  1e-5, as the dense O0 test) but where a code rounded the other way —
  at most one in a thousand, each within the three quanta of update it
  can move; O2 bf16 losses within 0.05.

Where gradients differ by fp32 rounding between the frameworks, a
code may round the other way: one step from equal states then agrees
within one e4m3 quantum of the block scale; over three steps a flipped
code moves the next steps' moments of its block, so each leaf's
dequantized moments agree within 1% (Frobenius norm).  ``TestKernelItems``
models the CUDA kernel's work items (tiles of 256 x 32, runs of 32
blocks, read from ``Fp8Layout.table``) and checks that they cover every
block of the padded state once, in the JAX order.  Tests marked
``cuda`` hold the CUDA kernel against the plain version on a GPU and
skip without one.
"""

import importlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import bert_mlm_loss_fn as jax_bert_loss
from apex_tpu.optim import fused_adam as jax_fused_adam
from apex_tpu_torch import _build, amp
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    bert_mlm_loss_fn,
    named_leaves_from_jax,
    params_from_jax,
)
from apex_tpu_torch.optim import fused_adam

JFA = importlib.import_module("apex_tpu.optim.fused_adam")
PFA = importlib.import_module("apex_tpu_torch.optim.fused_adam")
FP8 = "fp8_block_scaled"
SIZES = [7, 300, PFA._FP8_KERNEL_MIN + 300]


def _codes(q):
    """Codes of a JAX or torch fp8 array as uint8."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _dequant(q, s):
    return _codes(q).view(jnp.float8_e4m3fn).astype(np.float32) * np.repeat(
        np.asarray(s, np.float32), 256)


def _within_one_quantum(qa, sa, qb, sb):
    """Dequantized values agree within one e4m3 quantum of the block
    scale (plus what a scale difference moves a code by)."""
    sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
    da, db = _dequant(qa, sa), _dequant(qb, sb)
    s = np.repeat(np.maximum(sa, sb), 256)
    c = np.maximum(np.abs(da), np.abs(db)) / s
    quantum = np.where(c >= 2.0 ** -6,
                       np.exp2(np.floor(np.log2(np.maximum(c, 1e-30))) - 3),
                       2.0 ** -9) * s
    bound = quantum * (1 + 1e-6) + 448 * np.repeat(np.abs(sa - sb), 256)
    return bool((np.abs(da - db) <= bound).all())


class TestQuantization:
    def test_pad_lengths_match_jax(self):
        for n in [0, 1, 7, 255, 256, 257, 300, 16383, 16384, 16684,
                  131072, 131073, 400000]:
            assert PFA._fp8_pad(n) == JFA._fp8_pad(n), n
        assert (PFA._FP8_BLOCK, PFA._FP8_MAX, PFA._FP8_KERNEL_ROWS,
                PFA._FP8_KERNEL_MIN) == (JFA._FP8_BLOCK, JFA._FP8_MAX,
                                         JFA._FP8_KERNEL_ROWS,
                                         JFA._FP8_KERNEL_MIN)

    @pytest.mark.parametrize("n", SIZES + [4 * 256])
    def test_quant_and_dequant_bitwise(self, n):
        rng = np.random.default_rng(n)
        x = rng.normal(size=n).astype(np.float32)
        mags = np.array([1e-12, 1e-6, 1.0, 1e4], np.float32)
        x = x * np.repeat(mags, -(-n // 4))[:n]
        x[: min(n, 3)] = 0.0
        got = PFA._fp8_quant(torch.from_numpy(x))
        ref = JFA._fp8_quant(jnp.asarray(x))
        assert got.q.numel() == PFA._fp8_pad(n)
        np.testing.assert_array_equal(_codes(got.q), _codes(ref["q"]))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(ref["scale"]))
        back = PFA._fp8_dequant(got, n).numpy()
        np.testing.assert_array_equal(back,
                                      np.asarray(JFA._fp8_dequant(ref, n)))

    def test_conversion_matches_jax_at_the_edges(self):
        x = np.array([448, 448.2, 460, 1e-3, 2 ** -10, -0.0, np.nan,
                      2 ** -10 * 0.5, 0.75 * 2 ** -9, 3 * 2 ** -10, 1.0625,
                      1.1875, -1.0625], np.float32)
        got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
        ref = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
            np.uint8)
        np.testing.assert_array_equal(got.numpy(), ref)


def _run_both(wd, adamw, steps=3, impl="xla", monkeypatch=None,
              sizes=SIZES, lr=3e-3):
    rng = np.random.default_rng(int(wd * 100) + 2 * adamw)
    ps = [rng.normal(size=n).astype(np.float32) for n in sizes]
    gs = [[(rng.normal(size=n) * 1e-3).astype(np.float32) for n in sizes]
          for _ in range(steps)]
    monkeypatch.setenv("APEX_TPU_OPS_IMPL", impl)
    tx = jax_fused_adam(lr, weight_decay=wd, adam_w_mode=adamw,
                        moment_format=FP8)
    jp = [jnp.asarray(p) for p in ps]
    jst = tx.init(jp)
    opt = fused_adam(lr, weight_decay=wd, adam_w_mode=adamw,
                     moment_format=FP8)
    flat = torch.from_numpy(np.concatenate(ps))
    st = opt.init([flat], [[PFA.Leaf(n) for n in sizes]])
    for g in gs:
        upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        opt.step([torch.from_numpy(np.concatenate(g))], st, [flat])
    return flat, st, jp, jst


def _leaf_state(st, field, i):
    lay = st.layouts[0]
    m = getattr(st, field)[0]
    d, npad = lay.dst[i], PFA._fp8_pad(lay.leaves[i].numel)
    return m.q[d:d + npad], m.scale[d // 256:(d + npad) // 256]


class TestAgainstJax:
    @pytest.mark.parametrize("wd,adamw", [(0.0, True), (0.01, True),
                                          (0.0, False), (0.01, False)])
    def test_three_steps_match_the_xla_path(self, wd, adamw, monkeypatch):
        flat, st, jp, jst = _run_both(wd, adamw, monkeypatch=monkeypatch)
        ref = np.concatenate([np.asarray(p) for p in jp])
        np.testing.assert_array_equal(flat.numpy(), ref)
        for field in ("exp_avg", "exp_avg_sq"):
            for i in range(len(SIZES)):
                q, s = _leaf_state(st, field, i)
                jl = getattr(jst, field)[i]
                np.testing.assert_array_equal(_codes(q), _codes(jl["q"]))
                np.testing.assert_array_equal(s.numpy(),
                                              np.asarray(jl["scale"]))
        assert int(st.count) == int(jst.count) == 3

    @pytest.mark.parametrize("wd,adamw", [(0.0, True), (0.01, True),
                                          (0.01, False)])
    def test_three_steps_match_the_interpret_kernel(self, wd, adamw,
                                                    monkeypatch):
        n = PFA._FP8_KERNEL_MIN + 300
        flat, st, jp, jst = _run_both(wd, adamw, impl="pallas_interpret",
                                      monkeypatch=monkeypatch, sizes=[n])
        # the JAX package's own kernel-vs-XLA tolerances
        # (tests/test_optim.py::test_pallas_kernel_matches_xla_path)
        ref_p = np.asarray(jp[0])
        np.testing.assert_allclose(flat.numpy(), ref_p, rtol=1e-3,
                                   atol=1e-8)
        for field in ("exp_avg", "exp_avg_sq"):
            q, s = _leaf_state(st, field, 0)
            jl = getattr(jst, field)[0]
            da, db = _dequant(jl["q"], jl["scale"]), _dequant(q, s)
            atol = np.repeat(np.asarray(jl["scale"]), 256) * 2.0
            assert not (np.abs(db - da) > 0.15 * np.abs(da) + atol).any()
            np.testing.assert_allclose(s.numpy(), np.asarray(jl["scale"]),
                                       rtol=1e-3)

    def test_moment_dtype_is_ignored_and_bad_format_raises(self):
        opt = fused_adam(moment_dtype=torch.bfloat16, moment_format=FP8)
        assert opt.moment_dtype is None and opt.per_leaf
        st = opt.init([torch.zeros(300)])
        assert st.exp_avg[0].q.dtype == torch.float8_e4m3fn
        assert st.exp_avg[0].scale.shape == (2,)
        with pytest.raises(ValueError, match="moment_format"):
            fused_adam(moment_format="fp4")


class _TwoParams(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.big = torch.nn.Parameter(torch.ones(300))
        self.small = torch.nn.Parameter(torch.ones(37))
        self.fc = torch.nn.Linear(3, 100)


class TestLayout:
    def test_every_parameter_has_its_own_blocks(self):
        model = _TwoParams()
        state = amp.initialize(model, fused_adam(1e-3, moment_format=FP8),
                               "O2", half_dtype=torch.bfloat16)
        leaves = state.leaves()[0]
        names = [n for n, _ in leaves]
        lay = state.opt_state.layouts[0]
        assert [lf.numel for lf in lay.leaves] == [
            dict(model.named_parameters())[n].numel() for n in names]
        assert dict(leaves)["fc.weight"].rows_cols == (100, 3)
        assert dict(leaves)["big"].rows_cols is None
        ends = [d + PFA._fp8_pad(lf.numel)
                for d, lf in zip(lay.dst, lay.leaves)]
        assert all(d % 256 == 0 for d in lay.dst)
        assert lay.dst[1:] == ends[:-1] and lay.total == ends[-1]
        # huge gradients on one parameter, tiny on the next: with shared
        # blocks the tiny moments would flush to zero codes
        scale = float(state.loss_scale_state.loss_scale)
        grads = {"big": 1e3, "small": 1e-6, "fc.weight": 1e-2,
                 "fc.bias": 1e-4}
        gl = [torch.full_like(p, grads[n] * scale, dtype=torch.float32)
              for n, p in zip(state.names, state.module_params)]
        assert bool(state.apply_gradients(gl))
        m = state.opt_state.exp_avg[0]
        for i, (name, leaf) in enumerate(leaves):
            d = lay.dst[i]
            vals = PFA._fp8_dequant(PFA.Fp8Moment(
                m.q[d:d + PFA._fp8_pad(leaf.numel)],
                m.scale[d // 256:(d + PFA._fp8_pad(leaf.numel)) // 256]),
                leaf.numel)
            want = 0.1 * grads[name]
            torch.testing.assert_close(vals, torch.full_like(vals, want),
                                       rtol=0.07, atol=0)
            pads = m.q[d + leaf.numel:d + PFA._fp8_pad(leaf.numel)]
            assert not pads.view(torch.uint8).any()

    def test_transposed_leaf_runs_in_jax_order(self):
        rng = np.random.default_rng(3)
        w = rng.normal(size=(300, 5)).astype(np.float32)     # (out, in)
        g = rng.normal(size=(300, 5)).astype(np.float32)
        lay = PFA.Fp8Layout([PFA.Leaf(1500, (300, 5))])
        gathered = lay.gather(torch.from_numpy(g.reshape(-1)))
        np.testing.assert_array_equal(gathered[:1500].numpy(),
                                      g.T.reshape(-1))
        np.testing.assert_array_equal(
            lay.scatter(gathered).numpy(), g.reshape(-1))
        opt = fused_adam(1e-2, moment_format=FP8)
        p = torch.from_numpy(w.reshape(-1).copy())
        st = opt.init([p], [lay.leaves])
        opt.step([torch.from_numpy(g.reshape(-1))], st, [p])
        tx = jax_fused_adam(1e-2, moment_format=FP8)
        jst = tx.init({"k": jnp.asarray(w.T)})
        upd, jst = tx.update({"k": jnp.asarray(g.T)}, jst,
                             {"k": jnp.asarray(w.T)})
        np.testing.assert_array_equal(_codes(st.exp_avg[0].q),
                                      _codes(jst.exp_avg["k"]["q"]))
        np.testing.assert_array_equal(p.numpy().reshape(300, 5),
                                      np.asarray(w.T + upd["k"]).T)

    def test_non_finite_step_changes_nothing(self):
        model = _TwoParams()
        state = amp.initialize(model, fused_adam(1e-3, moment_format=FP8),
                               "O2", half_dtype=torch.float16)
        gl = [torch.full_like(p, 1e-3, dtype=torch.float32)
              for p in state.module_params]
        assert bool(state.apply_gradients(gl))
        st = state.opt_state
        before = [t.clone() for t in (st.exp_avg[0].q.view(torch.uint8),
                                      st.exp_avg[0].scale,
                                      st.exp_avg_sq[0].q.view(torch.uint8),
                                      st.exp_avg_sq[0].scale, st.count,
                                      state.groups[0].flat)]
        scale = float(state.loss_scale_state.loss_scale)
        gl[1] = gl[1].clone()
        gl[1][3] = float("inf")
        assert not bool(state.apply_gradients(gl))
        after = (st.exp_avg[0].q.view(torch.uint8), st.exp_avg[0].scale,
                 st.exp_avg_sq[0].q.view(torch.uint8), st.exp_avg_sq[0].scale,
                 st.count, state.groups[0].flat)
        for a, b in zip(before, after):
            assert torch.equal(a, b)
        assert float(state.loss_scale_state.loss_scale) == scale / 2


# ------------------------------------------------------------------ #
# tiny BERT against the JAX package
# ------------------------------------------------------------------ #
B, S, P = 2, 64, 8


def _build_bert(half=False):
    """A one-layer tiny BERT in both packages with the same weights."""
    kw = dict(scan_layers=False, num_layers=1)
    if half:
        kw["dtype"] = jnp.bfloat16
    jm = JaxBertModel(JaxBertConfig.tiny(**kw))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": variables["params"]}))
    cfg = BertConfig.tiny(num_layers=1,
                          **({"dtype": torch.bfloat16} if half else {}))
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jm, params, model


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, size=(B, S)).astype(np.int32)
    types = rng.integers(0, 2, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    pos = np.stack([rng.permutation(S)[:P] for _ in range(B)]).astype(
        np.int32)
    return ids, types, mask, pos, np.take_along_axis(ids, pos, axis=1)


def _jax_steps(state, data, steps, jit=False):
    """``steps`` JAX amp steps, eagerly (op by op, no FMA contraction),
    or under ``jax.jit`` where the comparison is a band anyway."""
    ids, types, mask, pos, labels = (jnp.asarray(a) for a in data)
    losses = []

    def one(state):
        def loss_of(p):
            cp = state.policy.cast_to_compute(p)
            logits, _ = state.apply_fn(cp, ids, token_type_ids=types,
                                       attention_mask=mask,
                                       mlm_positions=pos)
            loss = jax_bert_loss(logits.astype(jnp.float32), labels)
            return state.scale_loss(loss), loss
        grads, loss = jax.grad(loss_of, has_aux=True)(state.params)
        state, finite = state.apply_gradients(grads=grads)
        return state, loss, finite
    step = jax.jit(one) if jit else one
    for _ in range(steps):
        state, loss, finite = step(state)
        assert bool(finite)
        losses.append(float(loss))
    return state, losses


def _port_steps(state, model, data, steps):
    ids, types, mask, pos, labels = (torch.from_numpy(np.array(a))
                                     for a in data)
    losses = []
    for _ in range(steps):
        logits, _ = model(ids, token_type_ids=types, attention_mask=mask,
                          mlm_positions=pos)
        loss = bert_mlm_loss_fn(logits.float(), labels.long())
        state.scale_loss(loss).backward()
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    return losses


def _moments_close(qa, sa, qb, sb):
    """Over three steps a code that rounded the other way moves the next
    steps' values of its block by about a quantum each: compare each
    leaf's dequantized moment as a whole, within 1% (Frobenius norm)."""
    da, db = _dequant(qa, sa), _dequant(qb, sb)
    return np.linalg.norm(da - db) <= 1e-2 * np.linalg.norm(da)


def _compare_fp8_states(state, jstate, cfg, mode):
    """Per parameter, the port's codes and scales against the JAX
    state's: equal (``"exact"``), within one quantum (``"step"``: one
    step from equal states) or within 1% per leaf (``"steps"``)."""
    lay = state.opt_state.layouts[0]
    for field in ("exp_avg", "exp_avg_sq"):
        jl = named_leaves_from_jax(jax.tree.map(
            np.asarray, getattr(jstate.opt_state, field)), cfg)
        m = getattr(state.opt_state, field)[0]
        for i, (name, leaf) in enumerate(state.leaves()[0]):
            d, npad = lay.dst[i], PFA._fp8_pad(leaf.numel)
            q, s = m.q[d:d + npad], m.scale[d // 256:(d + npad) // 256]
            if mode == "exact":
                np.testing.assert_array_equal(_codes(q), _codes(jl[name]["q"]),
                                              err_msg=name)
                np.testing.assert_array_equal(
                    s.numpy(), np.asarray(jl[name]["scale"]), err_msg=name)
            else:
                check = (_within_one_quantum if mode == "step"
                         else _moments_close)
                assert check(q, s, jl[name]["q"], jl[name]["scale"]), name


@pytest.mark.parametrize("fmt", ["dense", FP8])
def test_resume_from_a_jax_state(fmt):
    jm, params, model = _build_bert()
    cfg = model.cfg
    data = _batch(5)
    tx = jax_fused_adam(1e-3, eps=1e-5, moment_format=fmt)
    jstate = jax_amp.initialize(jm.apply, params, tx, opt_level="O0")
    jstate, _ = _jax_steps(jstate, data, 2)
    # the port resumes from the JAX masters and optimizer state
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jstate.params), cfg))
    state = amp.initialize(model, fused_adam(1e-3, eps=1e-5,
                                             moment_format=fmt), "O0")
    ost = jstate.opt_state
    state.load_jax_opt_state(
        np.asarray(ost.count),
        named_leaves_from_jax(jax.tree.map(np.asarray, ost.exp_avg), cfg),
        named_leaves_from_jax(jax.tree.map(np.asarray, ost.exp_avg_sq), cfg))
    assert int(state.opt_state.count) == 2
    if fmt == FP8:
        _compare_fp8_states(state, jstate, cfg, mode="exact")
    else:
        ref = params_from_jax(jax.tree.map(np.asarray, ost.exp_avg_sq), cfg)
        flat = state.opt_state.exp_avg_sq[0]
        off = 0
        for name, leaf in state.leaves()[0]:
            np.testing.assert_array_equal(
                flat[off:off + leaf.numel].numpy(),
                ref[name].reshape(-1).numpy(), err_msg=name)
            off += leaf.numel
    jstate, jl = _jax_steps(jstate, data, 1)
    losses = _port_steps(state, model, data, 1)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if fmt == FP8:
        _compare_fp8_states(state, jstate, cfg, mode="step")
        assert int(state.opt_state.count) == 3


def test_named_leaves_refuse_a_scanned_stack():
    jm = JaxBertModel(JaxBertConfig.tiny(scan_layers=True))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError, match="scan"):
        named_leaves_from_jax(flax.core.meta.unbox(
            {"params": variables["params"]}), BertConfig.tiny())


def test_tiny_bert_o0_fp8_steps_match_jax():
    jm, params, model = _build_bert()
    data = _batch(6)
    tx = jax_fused_adam(1e-3, eps=1e-5, moment_format=FP8)
    jstate = jax_amp.initialize(jm.apply, params, tx, opt_level="O0")
    jstate, jl = _jax_steps(jstate, data, 3)
    state = amp.initialize(model, fused_adam(1e-3, eps=1e-5,
                                             moment_format=FP8), "O0")
    losses = _port_steps(state, model, data, 3)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), model.cfg)
    # where a moment's code rounded the other way (fp32-level gradient
    # differences), that element's update moves by up to a quantum of m
    # (2^-3) and of v (half of 2^-3 through the root): 3 steps x lr x
    # 0.19 at most; every other element stays within 1e-5
    off = n = 0
    for name, p in state.params.items():
        d = np.abs(p.numpy() - ref[name].numpy())
        assert d.max() <= 3 * 1e-3 * 0.19, name
        off += int((d > 1e-5 + 1e-5 * np.abs(ref[name].numpy())).sum())
        n += d.size
    assert off <= 1e-3 * n, (off, n)
    _compare_fp8_states(state, jstate, model.cfg, mode="steps")


def test_tiny_bert_o2_fp8_loss_trajectory_within_band():
    jm, params, model = _build_bert(half=True)
    data = _batch(7)
    tx = jax_fused_adam(1e-3, moment_format=FP8)
    jstate = jax_amp.initialize(jm.apply, params, tx, opt_level="O2",
                                half_dtype=jnp.bfloat16)
    jstate, jl = _jax_steps(jstate, data, 3, jit=True)
    state = amp.initialize(model, fused_adam(1e-3, moment_format=FP8), "O2",
                           half_dtype=torch.bfloat16)
    losses = _port_steps(state, model, data, 3)
    np.testing.assert_allclose(losses, jl, atol=0.05)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in state.params.values())
    st = state.opt_state
    assert st.exp_avg[0].q.dtype == torch.float8_e4m3fn
    assert st.layouts[0].numel == state.groups[0].flat.numel()
    assert int(st.count) == 3


# ------------------------------------------------------------------ #
# the CUDA kernel against its plain version (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wd,adamw", [(0.0, True), (0.01, True),
                                      (0.01, False)])
def test_kernel_matches_plain_on_card(wd, adamw, cuda_device):
    leaves = [PFA.Leaf(7), PFA.Leaf(300), PFA.Leaf(16684),
              PFA.Leaf(1024 * 4096, (4096, 1024)), PFA.Leaf(1500, (300, 5))]
    lay = PFA.Fp8Layout(leaves)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    p = torch.randn(lay.numel, generator=g, device=cuda_device)
    opt = fused_adam(1e-3, weight_decay=wd, adam_w_mode=adamw,
                     moment_format=FP8)
    outs = []
    for impl in ("kernel", "torch"):
        pp = p.clone()
        st = opt.init([pp], [leaves])
        g2 = torch.Generator(device=cuda_device).manual_seed(3)
        _build.reset_launches()
        for _ in range(3):
            grad = 1e-3 * torch.randn(lay.numel, generator=g2,
                                      device=cuda_device)
            opt.step([grad], st, [pp], implementation=impl)
        assert _build.launches["fp8_adam"] == (3 if impl == "kernel" else 0)
        outs.append((pp, st.exp_avg[0].q.view(torch.uint8),
                     st.exp_avg[0].scale, st.exp_avg_sq[0].q.view(torch.uint8),
                     st.exp_avg_sq[0].scale))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# the kernel's work items (csrc/fp8_adam.cu ``decode``), on the CPU
# ------------------------------------------------------------------ #
# layouts of every item kind: buffer-order leaves of odd sizes (the
# later leaves start off a 16-byte boundary), transposed leaves in tiles
# of 256 x 32 with padded blocks past them, and transposed leaves that
# are not whole tiles (rows % 256 or cols % 32), read in JAX order
ITEM_LAYOUTS = {
    "mixed": [PFA.Leaf(7), PFA.Leaf(300), PFA.Leaf(16684),
              PFA.Leaf(512 * 64, (512, 64)), PFA.Leaf(300 * 5, (300, 5)),
              PFA.Leaf(256 * 48, (256, 48)), PFA.Leaf(3)],
    "tiles": [PFA.Leaf(1024 * 96, (1024, 96)), PFA.Leaf(256 * 32, (256, 32)),
              PFA.Leaf(1024)],
    "runs": [PFA.Leaf(3), PFA.Leaf(40000), PFA.Leaf(256 * 33)],
}


def _kernel_items(lay):
    """The kernel's decode of every item: ``(state blocks, buffer index
    of each block's 256 elements, -1 for a pad)``, walking the table with
    a cursor as the kernel does."""
    rows = lay.table("cpu")[0].numpy()
    n_items = lay.table("cpu")[1]
    items, lf = [], 0
    for j in range(n_items):
        while lf + 1 < len(rows) and rows[lf + 1][0] <= j:
            lf += 1
        first, kind, n, src, blk0, nblk, R, C = (int(x) for x in rows[lf])
        u = j - first
        nrb = R // 256
        tiles = nrb * (C // 32) if kind == 1 else 0
        r = np.arange(256)
        if u < tiles:
            cb, rb = divmod(u, nrb)
            blocks = [blk0 + (cb * 32 + c) * nrb + rb for c in range(32)]
            idx = [src + (rb * 256 + r) * C + cb * 32 + c for c in range(32)]
        else:
            b0 = (n // 256 if kind == 1 else 0) + (u - tiles) * 32
            nb = min(32, nblk - b0)
            assert nb >= 1
            blocks = [blk0 + b0 + c for c in range(nb)]
            idx = []
            for c in range(nb):
                jx = (b0 + c) * 256 + r
                at = (jx % R) * C + jx // R if kind == 2 else jx
                idx.append(np.where(jx < n, src + at, -1))
        items.append((blocks, idx))
    return items


class TestKernelItems:
    @pytest.mark.parametrize("name", list(ITEM_LAYOUTS))
    def test_items_cover_the_state_in_jax_order(self, name):
        """Every block of the padded state belongs to exactly one item of
        at most 32 blocks, and its elements are the buffer's in the JAX
        package's order (pads where the leaf ends)."""
        lay = PFA.Fp8Layout(ITEM_LAYOUTS[name])
        # the buffer index (plus one) at every state position, 0 for pads
        want = lay.gather(torch.arange(1, lay.numel + 1, dtype=torch.float64)
                          .float()).double().numpy().astype(np.int64) - 1
        seen = np.zeros(lay.total // 256, np.int64)
        for blocks, idx in _kernel_items(lay):
            assert 1 <= len(blocks) <= 32
            for blk, at in zip(blocks, idx):
                seen[blk] += 1
                np.testing.assert_array_equal(
                    at, want[blk * 256:(blk + 1) * 256])
        assert (seen == 1).all()

    def test_tiles_are_256_rows_by_32_columns(self):
        lay = PFA.Fp8Layout(ITEM_LAYOUTS["tiles"])
        rows = lay.table("cpu")[0].numpy()
        assert list(rows[:, 1]) == [1, 1, 0]
        # 4 x 3 tiles and 4 runs of the 128 padded blocks past them (the
        # leaf pads to 512 blocks), 1 x 1 tile, one run for the last leaf
        assert lay.table("cpu")[1] == 12 + 4 + 1 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd,adamw", [(0.0, True), (0.01, True),
                                      (0.0, False), (0.01, False)])
@pytest.mark.parametrize("name", list(ITEM_LAYOUTS))
def test_item_kinds_bitwise_on_card(name, wd, adamw, dtype, cuda_device):
    """Every item kind (TMA tiles, bulk runs, tiles and runs read by the
    consumers: misaligned leaves, tiles that are not whole, bf16
    parameters) against the plain version: params, codes, scales and the
    count bitwise over three steps, a rerun bit for bit, and a
    non-finite step that writes nothing."""
    leaves = ITEM_LAYOUTS[name]
    lay = PFA.Fp8Layout(leaves)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    p = torch.randn(lay.numel, generator=g, device=cuda_device).to(dtype)
    opt = fused_adam(1e-3, weight_decay=wd, adam_w_mode=adamw,
                     moment_format=FP8)
    grads = [(1e-3 * torch.randn(lay.numel, generator=g,
                                 device=cuda_device)).to(dtype)
             for _ in range(3)]

    def run(impl):
        pp = p.clone()
        st = opt.init([pp], [leaves])
        for grad in grads:
            opt.step([grad], st, [pp], implementation=impl)
        return pp, st

    def state_bits(pp, st):
        return [t.reshape(-1).view(torch.uint8) for t in (
            pp, st.exp_avg[0].q, st.exp_avg[0].scale, st.exp_avg_sq[0].q,
            st.exp_avg_sq[0].scale, st.count)]

    got, again, ref = run("kernel"), run("kernel"), run("torch")
    for a, b, c in zip(state_bits(*got), state_bits(*again),
                       state_bits(*ref)):
        assert torch.equal(a, c)
        assert torch.equal(a, b)
    before = [t.clone() for t in state_bits(*got)]
    opt.step([grads[0]], got[1], [got[0]],
             finite=torch.tensor(False, device=cuda_device),
             implementation="kernel")
    for a, b in zip(before, state_bits(*got)):
        assert torch.equal(a, b)
