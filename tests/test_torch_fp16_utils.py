"""The port's ``fp16_utils`` held against the JAX package's.

The casts (``network_to_half``, ``BN_convert_float``,
``prep_param_lists``, ``master_params_to_model_params``,
``model_grads_to_master_grads``) equal JAX's bit for bit on a tree with
norm and non-norm leaves; ``network_to_half`` and ``BN_convert_float``
on a module cast the same parameters in place.  The legacy scalers'
arguments map onto the same loss-scale fields.  ``FP16_Optimizer`` over
FusedAdam and over FusedSGD, on fp16 parameters with dynamic loss
scaling: three steps, one of them with an inf gradient (skipped, scale
halved), against the JAX ``FP16_Optimizer`` — fp32 masters within rtol
1e-6 (torch and XLA round ``b ** t`` each their own way), fp16 model
parameters the rounded masters, the scale state equal — then
``state_dict`` / ``load_state_dict`` carry the run on.  All on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as jfp
from apex_tpu.optim import fused_adam as jax_fused_adam
from apex_tpu.optim import fused_sgd as jax_fused_sgd
from apex_tpu_torch import fp16_utils as fp
from apex_tpu_torch.optim import fused_adam, fused_sgd

SHAPES = {"dense": {"kernel": (4, 3), "bias": (3,)},
          "layernorm": {"scale": (3,), "bias": (3,)},
          "bn_1": {"mean": (2,)},
          "steps": ()}


def _tree(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in SHAPES.items():
        if isinstance(v, dict):
            out[k] = {n: rng.normal(size=s).astype(dtype)
                      for n, s in v.items()}
    out["steps"] = np.asarray(3, np.int32)
    return out


def _port(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)) if dtype is
                        None or a.dtype.kind != "f" else
                        torch.from_numpy(np.array(a)).to(dtype), tree)


def _equal(port, ref):
    pl = jax.tree.leaves(port)
    rl = jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = np.asarray(r)
        assert str(p.dtype).split(".")[-1] == str(r.dtype), (p.dtype, r.dtype)
        got = p.float().numpy() if p.is_floating_point() else p.numpy()
        np.testing.assert_array_equal(got, r.astype(got.dtype))


@pytest.mark.parametrize("half", ["float16", "bfloat16"])
def test_casts_equal_jax(half):
    tree = _tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    th, jh = getattr(torch, half), getattr(jnp, half)
    halfed = fp.network_to_half(_port(tree), half_dtype=th)
    jhalfed = jfp.network_to_half(jtree, half_dtype=jh)
    _equal(halfed, jhalfed)
    assert halfed["layernorm"]["scale"].dtype == torch.float32
    assert halfed["bn_1"]["mean"].dtype == torch.float32
    assert halfed["dense"]["kernel"].dtype == th
    all_half = _port(tree, th)
    _equal(fp.BN_convert_float(all_half),
           jfp.BN_convert_float(jax.tree.map(
               lambda a: a.astype(jh) if a.dtype == jnp.float32 else a,
               jtree)))
    model, masters = fp.prep_param_lists(halfed)
    jmodel, jmasters = jfp.prep_param_lists(jhalfed)
    assert model is halfed
    _equal(masters, jmasters)
    assert masters["dense"]["kernel"].data_ptr() != \
        halfed["dense"]["kernel"].data_ptr()
    bumped = jax.tree.map(lambda t: t * 1.001 if t.is_floating_point()
                          else t, masters)
    jbumped = jax.tree.map(lambda a: a * 1.001 if a.dtype == jnp.float32
                           else a, jmasters)
    _equal(fp.master_params_to_model_params(halfed, bumped),
           jfp.master_params_to_model_params(jhalfed, jbumped))
    _equal(fp.model_grads_to_master_grads(halfed),
           jfp.model_grads_to_master_grads(jhalfed))


def test_module_forms_cast_in_place():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(4, 3)
            self.layernorm = torch.nn.LayerNorm(3)

    net = Net()
    assert fp.network_to_half(net) is net
    assert net.dense.weight.dtype == torch.float16
    assert net.layernorm.weight.dtype == torch.float32
    net.layernorm.half()
    assert fp.BN_convert_float(net) is net
    assert net.layernorm.weight.dtype == torch.float32
    assert net.dense.weight.dtype == torch.float16


def test_legacy_scalers_map_onto_the_same_fields():
    for port, ref in ((fp.DynamicLossScaler(), jfp.DynamicLossScaler()),
                      (fp.DynamicLossScaler(2.0 ** 10, 4.0, 7),
                       jfp.DynamicLossScaler(2.0 ** 10, 4.0, 7)),
                      (fp.LossScaler(128.0), jfp.LossScaler(128.0))):
        for f in ("init_scale", "growth_factor", "backoff_factor",
                  "growth_interval", "max_scale", "min_scale"):
            assert getattr(port, f) == getattr(ref, f), f


def _opt_pair(kind):
    if kind == "adam":
        return fused_adam(1e-2, weight_decay=0.01), \
            jax_fused_adam(1e-2, weight_decay=0.01)
    return fused_sgd(0.1, momentum=0.9), jax_fused_sgd(0.1, momentum=0.9)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 4)).astype(np.float16),
            "b": rng.normal(size=(4,)).astype(np.float16)}


def _grads(rng, bad=False):
    g = {"w": rng.normal(size=(5, 4)).astype(np.float16),
         "b": rng.normal(size=(4,)).astype(np.float16)}
    if bad:
        g["w"][1, 2] = np.inf
    return g


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_fp16_optimizer_steps_and_state_dict_match_jax(kind):
    popt, jtx = _opt_pair(kind)
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args=dict(init_scale=2.0 ** 8,
                                       scale_window=2))
    port, ref = fp.FP16_Optimizer(popt, **args), \
        jfp.FP16_Optimizer(jtx, **args)
    params = _params(1)
    model = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jmodel = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = port.init(model), ref.init(jmodel)
    rng = np.random.default_rng(2)
    for i, bad in enumerate((False, True, False, False)):
        g = _grads(rng, bad)
        # the scaled-loss gradients: the model's grads times the scale
        s = float(state.loss_scale_state.loss_scale)
        assert s == float(jstate.loss_scale_state.loss_scale)
        pg = {k: torch.from_numpy(v) * s for k, v in g.items()}
        jg = {k: jnp.asarray(v) * s for k, v in g.items()}
        state, model, finite = port.step(state, model, pg)
        jstate, jmodel, jfinite = ref.step(jstate, jmodel, jg)
        assert bool(finite) == bool(jfinite) == (not bad)
        for k in params:
            np.testing.assert_allclose(state.master_params[k].numpy(),
                                       np.asarray(jstate.master_params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            assert model[k].dtype == torch.float16
            assert torch.equal(model[k],
                               state.master_params[k].to(torch.float16))
            np.testing.assert_allclose(model[k].float().numpy(),
                                       np.asarray(jmodel[k], np.float32),
                                       rtol=2 ** -10, err_msg=k)
        assert port.state_dict(state)["loss_scaler"] == \
            ref.state_dict(jstate)["loss_scaler"]
        if i == 1:
            # resume from the state dict: the run goes on unchanged
            d = port.state_dict(state)
            state = port.load_state_dict(d)
            assert d["loss_scaler"] == {"loss_scale": 2.0 ** 7,
                                        "unskipped": 0}
    assert port.scale_loss(state, torch.tensor(2.0)).item() == \
        2.0 * float(jstate.loss_scale_state.loss_scale)


def test_fp16_optimizer_static_and_no_scale():
    opt = fp.FP16_Optimizer(fused_sgd(0.1), static_loss_scale=64.0)
    assert opt.loss_scaler.init_scale == 64.0
    assert type(fp.FP16_Optimizer(fused_sgd(0.1)).loss_scaler).__name__ == \
        "NoOpLossScale"
