"""The port's optimizers and clipping held against the JAX package's.

FusedLAMB, FusedMixedPrecisionLamb, FusedNovoGrad, FusedAdagrad and LARC
(around FusedSGD) each take three fp32 steps over a tree of three
parameters laid end to end in one flat buffer, as the train state lays
them out (their leaves given to ``init``), against the JAX optax
transform on the same numpy-made parameters and gradients; a fourth step
with an inf in its gradient is skipped by the device ``finite`` flag and
changes no parameter, moment or count (the JAX train state's select, so
the JAX trajectory simply leaves that step out).  Parameters and states
within rtol 1e-6, atol 1e-7 (fp32 sums of squares in other orders; torch
and XLA round ``b ** t`` each their own way).  MP-LAMB's bf16 model
parameters: within one bf16 ulp of the JAX ones (equal but where a master
within 1e-6 of JAX's rounds the other way).  ``clip_grad_norm``,
``clip_by_global_norm`` and the ``_multi_tensor`` helpers against the
JAX functions at rtol 1e-6.  LAMB through ``amp.initialize`` (the per
parameter leaves of the flat buffer, linear weights transposed against
the JAX kernels) against the JAX train state.  All on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import optim as jax_optim
from apex_tpu.optim import _multi_tensor as jax_mt
from apex_tpu_torch import amp, contrib
from apex_tpu_torch import optim
from apex_tpu_torch.core.precision import tree_leaves
from apex_tpu_torch.optim import _multi_tensor as mt
from apex_tpu_torch.optim.fused_adam import Leaf

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"a": (5, 3), "b": (7,), "c": (4, 4, 2)}


def _tree(rng, scale=1.0, dtype=np.float32):
    return {k: (scale * rng.normal(size=s)).astype(dtype)
            for k, s in SHAPES.items()}


def _flat(tree, dtype=torch.float32):
    return torch.cat([torch.from_numpy(np.asarray(tree[k], np.float32))
                      .reshape(-1) for k in SHAPES]).to(dtype)


def _unflat(buf):
    out, off = {}, 0
    for k, s in SHAPES.items():
        n = int(np.prod(s))
        out[k] = buf[off:off + n].reshape(s)
        off += n
    return out


LEAVES = [[Leaf(int(np.prod(s))) for s in SHAPES.values()]]


def _run_pair(port_opt, jax_tx, *, dtype=np.float32, steps=3, seed=0):
    """Three steps, then one with an inf gradient, of the port optimizer
    on a flat buffer and of the JAX transform on the tree."""
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype=np.float32)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    buf = _flat(params, tdt)
    if getattr(port_opt, "per_leaf", False):
        state = port_opt.init([buf], LEAVES)
    else:
        state = port_opt.init([buf])
    jstate = jax_tx.init(jp)
    for i in range(steps + 1):
        grads = _tree(rng, 0.5 if i % 2 else 2.0)
        g = _flat(grads, tdt)
        if i == steps:          # skipped: nothing changes on either side
            g[3] = float("inf")
            before = buf.clone()
            count = getattr(state, "count", None)
            count = None if count is None else count.clone()
        finite = torch.isfinite(g).all()
        port_opt.step([g], state, [buf], finite)
        if i == steps:
            assert not bool(finite)
            assert torch.equal(buf, before)
            if count is not None:
                assert torch.equal(state.count, count)
            break
        jg = {k: jnp.asarray(v).astype(dtype) for k, v in grads.items()}
        upd, jstate = jax_tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    return buf, state, jp, jstate


def _close_tree(buf, jtree, rtol=RTOL, atol=ATOL):
    for k, v in _unflat(buf).items():
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jtree[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(adam_w_mode=False, weight_decay=0.05),
    dict(trust_clip=True, max_grad_norm=None),
    dict(weight_decay=0.0, always_adapt=True, bias_correction=False),
    dict(weight_decay=0.0),
    dict(max_grad_norm=0.5, b1=0.8, eps=1e-5),
])
def test_fused_lamb_matches_jax(kw):
    buf, state, jp, jstate = _run_pair(optim.fused_lamb(1e-2, **kw),
                                       jax_optim.fused_lamb(1e-2, **kw))
    _close_tree(buf, jp)
    _close_tree(state.exp_avg[0], jstate.exp_avg)
    _close_tree(state.exp_avg_sq[0], jstate.exp_avg_sq)
    assert int(state.count) == int(jstate.count) == 3


def test_fused_lamb_aliases_and_schedule():
    assert optim.FusedLAMB is optim.fused_lamb
    sched = lambda c: 1e-2 / c.float() if torch.is_tensor(c) else 1e-2 / c
    buf, _, jp, _ = _run_pair(optim.fused_lamb(sched),
                              jax_optim.fused_lamb(lambda c: 1e-2 / c))
    _close_tree(buf, jp)


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.0,
                                             max_grad_norm=None)])
def test_fused_mixed_precision_lamb_matches_jax(kw):
    port = optim.fused_mixed_precision_lamb(1e-2, **kw)
    buf, state, jp, jstate = _run_pair(
        port, jax_optim.fused_mixed_precision_lamb(1e-2, **kw),
        dtype=jnp.bfloat16)
    assert buf.dtype == torch.bfloat16
    _close_tree(state.master_params[0], jstate.master_params)
    _close_tree(state.inner.exp_avg[0], jstate.inner.exp_avg)
    # the model parameters are the rounded masters
    got = buf.float().numpy()
    ref = _flat({k: np.asarray(v, np.float32) for k, v in jp.items()}
                ).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert torch.equal(buf, state.master_params[0].to(torch.bfloat16))
    assert optim.FusedMixedPrecisionLamb is optim.fused_mixed_precision_lamb


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grad_averaging=True, weight_decay=0.01),
    dict(bias_correction=True, b1=0.9, b2=0.999),
])
def test_fused_novograd_matches_jax(kw):
    buf, state, jp, jstate = _run_pair(optim.fused_novograd(1e-2, **kw),
                                       jax_optim.fused_novograd(1e-2, **kw))
    _close_tree(buf, jp)
    _close_tree(state.exp_avg[0], jstate.exp_avg)
    np.testing.assert_allclose(
        state.exp_avg_sq[0].numpy(),
        [float(jstate.exp_avg_sq[k]) for k in SHAPES], rtol=RTOL)
    assert optim.FusedNovoGrad is optim.fused_novograd


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.01),
    dict(initial_accumulator_value=0.1, eps=1e-8),
])
def test_fused_adagrad_matches_jax(kw):
    buf, state, jp, jstate = _run_pair(optim.fused_adagrad(1e-2, **kw),
                                       jax_optim.fused_adagrad(1e-2, **kw))
    _close_tree(buf, jp)
    _close_tree(state.sum_sq[0], jstate.sum_sq)
    assert optim.FusedAdagrad is optim.fused_adagrad


@pytest.mark.parametrize("clip,wd,tc", [(True, 0.0, 0.02),
                                        (True, 1e-4, 0.5),
                                        (False, 1e-4, 0.02)])
def test_larc_around_fused_sgd_matches_jax(clip, wd, tc):
    lr = 0.1
    port = optim.larc(optim.fused_sgd(lr, momentum=0.9, weight_decay=wd),
                      trust_coefficient=tc, clip=clip)
    jtx = optax.chain(
        jax_optim.larc(lr, trust_coefficient=tc, clip=clip,
                       weight_decay=wd),
        jax_optim.fused_sgd(lr, momentum=0.9, weight_decay=wd))
    buf, state, jp, jstate = _run_pair(port, jtx)
    _close_tree(buf, jp)
    _close_tree(state.inner.momentum_buf[0], jstate[1].momentum_buf)
    assert optim.LARC is optim.larc


def test_larc_needs_a_float_learning_rate():
    port = optim.larc(optim.fused_sgd(lambda c: 0.1))
    state = port.init([torch.ones(3)])
    with pytest.raises(ValueError, match="learning_rate"):
        port.step([torch.ones(3)], state, [torch.ones(3)])


# ------------------------------------------------------------------ #
# clipping and the multi-tensor helpers
# ------------------------------------------------------------------ #
def _pair_trees(seed=4):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "x": [rng.normal(size=(4,)).astype(np.float32),
                  (3.0 * rng.normal(size=(2, 3))).astype(np.float32)]}
    port = {"w": torch.from_numpy(tree["w"]),
            "x": [torch.from_numpy(t) for t in tree["x"]]}
    jtree = jax.tree.map(jnp.asarray, tree)
    return port, jtree


def _close(port, ref, rtol=RTOL):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_norm_matches_jax(max_norm):
    port, jtree = _pair_trees()
    got, norm = optim.clip_grad_norm(port, max_norm)
    ref, jnorm = jax_optim.clip_grad_norm(jtree, max_norm)
    _close(got, ref)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    assert isinstance(got["x"], list)
    assert contrib.clip_grad_norm is optim.clip_grad_norm
    tx, jtx = optim.clip_by_global_norm(max_norm), \
        jax_optim.clip_by_global_norm(max_norm)
    clipped, _ = tx.update(port, tx.init(port))
    jclipped, _ = jtx.update(jtree, jtx.init(jtree))
    _close(clipped, jclipped)


def test_multi_tensor_helpers_match_jax():
    port, jtree = _pair_trees(5)
    np.testing.assert_allclose(float(optim.tree_l2_norm(port)),
                               float(jax_mt.tree_l2_norm(jtree)), rtol=RTOL)
    _close(optim.per_tensor_l2_norms(port),
           jax_mt.per_tensor_l2_norms(jtree))
    _close(optim.tree_scale(port, torch.tensor(0.37)),
           jax_mt.tree_scale(jtree, jnp.float32(0.37)))
    other, jother = _pair_trees(6)
    _close(optim.tree_axpby(0.3, port, -1.5, other),
           jax_mt.tree_axpby(0.3, jtree, -1.5, jother))
    for max_norm in (None, 1.0, 1e3):
        coef, norm = optim.global_grad_clip_coef(port, max_norm)
        jcoef, jnorm = jax_mt.global_grad_clip_coef(jtree, max_norm)
        np.testing.assert_allclose(float(coef), float(jcoef), rtol=RTOL)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    # half leaves: scaled in fp32, cast back
    half = {"h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    out = optim.tree_scale(half, torch.tensor(3.0))
    assert out["h"].dtype == torch.bfloat16
    assert out["h"].tolist() == [4.5, -6.75]


def test_segment_norms_of_a_flat_buffer():
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    buf = _flat(tree)
    got = mt.segment_norms(buf, [lf.numel for lf in LEAVES[0]])
    ref = [float(jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(tree[k])))))
           for k in SHAPES]
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)
    seg = mt.Segments.of(buf, LEAVES[0])
    assert seg.expand(torch.tensor([1.0, 2.0, 3.0])).tolist() == \
        [1.0] * 15 + [2.0] * 7 + [3.0] * 32
    with pytest.raises(ValueError, match="leaves hold"):
        mt.Segments.of(buf, [Leaf(3)])
    # a leaf of 4e6 elements: within 1e-6 of the float64 norm (the CPU's
    # own norm kernel runs one fp32 total and is ~1e-4 off here)
    big = torch.randn(4_000_003, generator=torch.Generator().manual_seed(9))
    got = mt.segment_norms(big, [3, 4_000_000])
    exact = [big[:3].double().norm(), big[3:].double().norm()]
    for a, b in zip(got, exact):
        assert abs(float(a) - float(b)) <= 1e-6 * float(b)


# ------------------------------------------------------------------ #
# a per-leaf optimizer through the train state
# ------------------------------------------------------------------ #
def test_lamb_through_the_train_state_matches_jax():
    rng = np.random.default_rng(8)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    names = [n for n, _ in model.named_parameters()]
    # the JAX tree: linear weights as (in, out) kernels
    jp = {n: jnp.asarray(p.detach().numpy().T if p.ndim == 2
                         else p.detach().numpy())
          for n, p in model.named_parameters()}
    state = amp.initialize(model, optim.fused_lamb(1e-2), "O0")
    tx = jax_optim.fused_lamb(1e-2)
    jstate = tx.init(jp)
    x = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    for _ in range(3):
        model(x).square().sum().backward()
        grads = {n: p.grad.detach().numpy().copy()
                 for n, p in model.named_parameters()}
        assert bool(state.apply_gradients())
        jg = {n: jnp.asarray(g.T if g.ndim == 2 else g)
              for n, g in grads.items()}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    for n in names:
        p = state.params[n].numpy()
        np.testing.assert_allclose(p.T if p.ndim == 2 else p,
                                   np.asarray(jp[n]), rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    assert [s.sizes for s in state.opt_state.segments] == [
        [30, 5, 15, 3]]
