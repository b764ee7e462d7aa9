"""The port's amp O1 (per-op casting) held against the JAX package's.

- The op lists: every table, the merged ``HALF/FP32/PROMOTE_FUNCS`` and
  ``classify_op`` of every listed name, alias and an unknown one equal
  the JAX module's, also after the same register / deregister sequence
  (a conflicting registration raises in both).
- ``cast_op``: the cast inputs equal JAX's bit for bit for each class.
- ``o1_intercept`` on a tiny BERT with ``dtype=None``: every module gets
  the class its flax counterpart gets from the JAX interceptor, and
  leaves its call in the dtype the flax module does; the hooks are gone
  and every ``dtype`` is ``None`` again after the block.
- A tiny ResNet (bf16 convs, fused BN) and a tiny BERT (``dtype=None``
  under ``o1_intercept(bfloat16)``, with and without remat), two O1 steps
  each (FusedSGD lr 0.1 momentum 0.9 wd 1e-4; FusedAdam 1e-3) against
  the JAX ``amp.initialize(..., opt_level="O1")`` state: the losses within
  2e-2 (ResNet, as the O2 test in ``test_torch_resnet.py``: bf16 rounds at
  other places in the two frameworks, through 14 convs and BNs) and 0.05
  (BERT, as ``test_torch_bert.py``'s O2 band); BERT's first-step
  gradients within 2^-5 of each tensor's largest entry (bf16 products
  rounded at other places, through two layers: four bf16 ulps); the
  stored parameters fp32 views of the flat buffer, no masters, and the
  module's parameters fp32 after the steps.
All on the CPU.
"""

import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.modules import module as torch_module

from apex_tpu import amp as jax_amp
from apex_tpu.amp import lists as jax_lists
from apex_tpu.amp import o1 as jax_o1
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import bert_mlm_loss_fn as jax_bert_loss
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu.optim import fused_adam as jax_fused_adam
from apex_tpu.optim import fused_sgd as jax_fused_sgd
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists, o1
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    ResNet,
    ResNetConfig,
    bert_mlm_loss_fn,
    params_from_jax,
    resnet_params_from_jax,
)
from apex_tpu_torch.optim import fused_adam, fused_sgd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TABLES = ("HALF_FUNCS", "FP32_FUNCS", "PROMOTE_FUNCS", "FUNCTIONAL_HALF",
           "FUNCTIONAL_FP32", "FUNCTIONAL_PROMOTE", "TORCH_HALF",
           "TORCH_FP32", "TORCH_PROMOTE", "TENSOR_HALF", "TENSOR_FP32",
           "TENSOR_PROMOTE", "TORCH_ALIASES")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ #
# the op lists
# ------------------------------------------------------------------ #
def _all_names():
    names = set(jax_lists.HALF_FUNCS | jax_lists.FP32_FUNCS
                | jax_lists.PROMOTE_FUNCS)
    names |= set(jax_lists.TORCH_ALIASES)
    return sorted(names | {"no_such_op", "Tensor.nope", "my_op"})


def _classes():
    return ({n: lists.classify_op(n) for n in _all_names()},
            {n: jax_lists.classify_op(n) for n in _all_names()})


@pytest.mark.parametrize("table", _TABLES)
def test_tables_equal_jax(table):
    assert getattr(lists, table) == getattr(jax_lists, table)
    assert getattr(amp, table, getattr(lists, table)) == \
        getattr(jax_lists, table)


def test_classification_equals_jax_for_every_name():
    port, ref = _classes()
    assert port == ref
    assert set(port.values()) == {"half", "fp32", "promote", "passthrough"}
    assert lists.__all__ == jax_lists.__all__
    for name in ("register_half_function", "register_float_function",
                 "register_promote_function", "deregister_function",
                 "classify_op", "HALF_FUNCS", "o1"):
        assert hasattr(amp, name)


def test_registration_round_trips_equal_jax():
    """The same registrations on both registries give the same classes at
    every step, and deregistering restores the built-in tables."""
    steps = [
        ("register_half_function", ("my_op",)),
        ("register_float_function", (torch, "softmax_fn")),
        ("register_promote_function", ("Tensor.matmul",)),
        ("deregister_function", ("my_op",)),
        ("register_float_function", ("my_op",)),
        ("register_half_function", ("sum",)),
    ]
    try:
        for fn, args in steps:
            jargs = tuple(jnp if a is torch else a for a in args)
            getattr(lists, fn)(*args)
            getattr(jax_lists, fn)(*jargs)
            port, ref = _classes()
            assert port == ref, (fn, args)
        assert lists.classify_op("Tensor.matmul") == "promote"
        assert lists.classify_op("t_matmul") == "promote"
        # a conflicting kind raises in both
        with pytest.raises(ValueError, match="conflicting"):
            lists.register_half_function("my_op")
        with pytest.raises(ValueError, match="conflicting"):
            jax_lists.register_half_function("my_op")
        with pytest.raises(TypeError):
            lists.register_half_function(3)
    finally:
        for name in ("my_op", "softmax_fn", "Tensor.matmul", "sum"):
            lists.deregister_function(name)
            jax_lists.deregister_function(name)
    port, ref = _classes()
    assert port == ref
    assert lists.classify_op("sum") == "fp32"
    assert lists._REGISTERED == {} and jax_lists._REGISTERED == {}


# ------------------------------------------------------------------ #
# cast_op
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", ["matmul", "softmax", "sum", "add",
                                  "cat", "no_such_op", "mm"])
@pytest.mark.parametrize("half", ["bfloat16", "float16"])
def test_cast_op_is_exact(name, half):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    ids = np.arange(3, dtype=np.int32)
    th, jh = getattr(torch, half), getattr(jnp, half)

    def port_fn(*args, **kw):
        return list(args) + [kw["k"]]

    def jax_fn(*args, **kw):
        return list(args) + [kw["k"]]

    got = o1.cast_op(name, port_fn, _t(a), _t(b).to(torch.bfloat16),
                     _t(ids), half_dtype=th, k=_t(a))
    ref = jax_o1.cast_op(name, jax_fn, jnp.asarray(a),
                         jnp.asarray(b).astype(jnp.bfloat16),
                         jnp.asarray(ids), half_dtype=jh, k=jnp.asarray(a))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert str(g.dtype).split(".")[-1] == str(r.dtype), (name, g.dtype,
                                                             r.dtype)
        np.testing.assert_array_equal(g.float().numpy() if
                                      g.is_floating_point() else g.numpy(),
                                      r.astype(np.float32) if
                                      g.is_floating_point() else r)
    assert o1.cast_op("matmul", torch.matmul, _t(a), _t(b).T).dtype == \
        torch.bfloat16


def test_classify_module_equals_jax_and_maps_the_port_names():
    for name in ("Dense", "Conv", "LayerNorm", "_Norm", "BatchNorm",
                 "Embed", "MultiHeadDotProductAttention", "LSTMCell",
                 "ParallelMLP", "_BN", "ResNet", "BertModel",
                 "SoftmaxCrossEntropyLoss", "Dropout", "Sequential"):
        assert o1.classify_module(name) == jax_o1.classify_module(name)
    from apex_tpu_torch.models.resnet import _BN, _Conv, _Dense
    from apex_tpu_torch.models.transformer import Norm
    for cls, flax_name in ((Norm, "_Norm"), (_Conv, "Conv"),
                           (_Dense, "Dense"), (_BN, "_BN")):
        assert o1.FLAX_COUNTERPARTS.get(cls.__name__, cls.__name__) == \
            flax_name
    assert o1.module_class(torch.nn.Linear(2, 2)) == "half"
    assert o1.module_class(torch.nn.LayerNorm(2)) == "fp32"


# ------------------------------------------------------------------ #
# tiny BERT under the intercept
# ------------------------------------------------------------------ #
B, S, P = 2, 64, 8


def _bert_pair(remat=False):
    jm = JaxBertModel(JaxBertConfig.tiny(scan_layers=False, dtype=None,
                                         remat=remat))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        {"params": v["params"]}))
    cfg = BertConfig.tiny(dtype=None, remat=remat)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return jm, params, model


def _bert_batch(seed=5, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    types = rng.integers(0, 2, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    pos = np.stack([rng.permutation(S)[:P] for _ in range(B)]).astype(
        np.int32)
    return ids, types, mask, pos, np.take_along_axis(ids, pos, axis=1)


def _jax_path(port_name):
    """The flax path of a port module name."""
    parts = port_name.split(".")
    if parts[:2] == ["transformer", "layers"]:
        parts = ["transformer", f"layer_{parts[2]}"] + parts[3:]
    return "/".join(parts)


def test_every_bert_module_gets_its_flax_class_and_dtype():
    jm, params, model = _bert_pair()
    ids, types, mask, pos, _ = _bert_batch()
    jax_seen = {}

    def record(next_fn, args, kwargs, context):
        out = next_fn(*args, **kwargs)
        mod = context.module
        path = "/".join(mod.path) if mod.scope is not None else None
        if (path is not None and context.method_name == "__call__"
                and path not in jax_seen):
            leaf = jax.tree.leaves(out)[0]
            jax_seen[path] = (jax_o1.classify_module(type(mod).__name__),
                              str(leaf.dtype))
        return out

    cp = jax_amp.PrecisionPolicy.O1().cast_to_compute(params)
    with fnn.intercept_methods(record):
        with jax_o1.o1_intercept(jnp.bfloat16):
            jm.apply(cp, jnp.asarray(ids), token_type_ids=jnp.asarray(types),
                     attention_mask=jnp.asarray(mask),
                     mlm_positions=jnp.asarray(pos))
    port_seen = {}

    def hook(mod, args, out):
        name = names.get(id(mod))
        if name is not None and name not in port_seen:
            leaf = out[0] if isinstance(out, tuple) else out
            port_seen[name] = (o1.module_class(mod),
                               str(leaf.dtype).split(".")[-1])

    names = {id(m): _jax_path(n) for n, m in model.named_modules()
             if not isinstance(m, torch.nn.ModuleList)}
    state = amp.initialize(model, fused_adam(1e-3), "O1")
    handle = torch_module.register_module_forward_hook(hook)
    try:
        with amp.o1.o1_intercept(torch.bfloat16):
            model(_t(ids), token_type_ids=_t(types),
                  attention_mask=_t(mask), mlm_positions=_t(pos))
    finally:
        handle.remove()
    assert set(port_seen) == set(jax_seen)
    assert port_seen == jax_seen
    # the intercept is gone, every promoting module has its None back
    assert not o1._ACTIVE and not o1._HANDLES and not o1._SET_DTYPE
    assert model.embedding.dtype is None
    assert all(m.dtype is None for m in model.modules()
               if hasattr(m, "dtype"))
    # no cast of the compute copy outlives the forward
    assert all(not isinstance(m.__dict__.get("weight"), torch.Tensor)
               for m in model.modules())
    state.compute_copy.remove()


def test_intercept_scoping_nesting_and_errors():
    from apex_tpu_torch.transformer import ColumnParallelLinear
    lin = ColumnParallelLinear(4, 4, device="cpu")     # dtype None
    lin.init_weights(torch.Generator().manual_seed(0))
    norm = torch.nn.LayerNorm(4)
    x = torch.randn(2, 4)
    with o1.o1_intercept(torch.float16):
        with o1.o1_intercept(torch.bfloat16):
            assert lin(x).dtype == torch.bfloat16
            assert norm(x.bfloat16()).dtype == torch.float32
            assert o1.module_dtype(lin) == torch.bfloat16
        assert o1.module_dtype(lin) == torch.float16
        assert lin.dtype is None
    assert o1.module_dtype(lin) is None and lin(x).dtype == torch.float32

    class BoomLinear(ColumnParallelLinear):
        def forward(self, x):
            assert self.dtype == torch.bfloat16
            raise RuntimeError("boom")
    boom = BoomLinear(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        with o1.o1_intercept():
            boom(torch.randn(1, 2))
    assert boom.dtype is None and not o1._SET_DTYPE and not o1._HANDLES
    from torch.utils.checkpoint import noop_context_fn
    assert o1.checkpoint_context_fn() is noop_context_fn


def _jax_bert_steps(jm, params, data, steps=2):
    def apply_fn(p, *args, **kw):
        with jax_o1.o1_intercept(jnp.bfloat16):
            return jm.apply(p, *args, **kw)
    state = jax_amp.initialize(apply_fn, params, jax_fused_adam(1e-3),
                               opt_level="O1")
    ids, types, mask, pos, labels = (jnp.asarray(a) for a in data)

    @jax.jit
    def step(state):
        def loss_of(p):
            logits, _ = state.apply_fn(p, ids, token_type_ids=types,
                                       attention_mask=mask,
                                       mlm_positions=pos)
            loss = jax_bert_loss(logits.astype(jnp.float32), labels)
            return state.scale_loss(loss), loss
        grads, loss = jax.grad(loss_of, has_aux=True)(state.compute_params())
        state, finite = state.apply_gradients(grads=grads)
        return state, grads, loss, finite
    losses, first = [], None
    for _ in range(steps):
        state, grads, loss, finite = step(state)
        first = grads if first is None else first
        assert bool(finite)
        losses.append(float(loss))
    return state, losses, first


def _port_bert_steps(model, data, steps=2):
    state = amp.initialize(model, fused_adam(1e-3), "O1")
    ids, types, mask, pos, labels = (_t(a) for a in data)
    losses, first = [], None
    for _ in range(steps):
        with amp.o1.o1_intercept(torch.bfloat16):
            logits, _ = model(ids, token_type_ids=types,
                              attention_mask=mask, mlm_positions=pos)
        assert logits.dtype == torch.float32
        loss = bert_mlm_loss_fn(logits.float(), labels.long())
        state.scale_loss(loss).backward()
        if first is None:
            first = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    return state, losses, first


@pytest.mark.parametrize("remat", [False, True])
def test_bert_o1_fused_adam_two_steps_match_jax(remat):
    jm, params, model = _bert_pair(remat)
    data = _bert_batch()
    _, jlosses, jgrads = _jax_bert_steps(jm, params, data)
    state, losses, grads = _port_bert_steps(model, data)
    np.testing.assert_allclose(losses, jlosses, atol=0.05)
    assert losses[-1] < losses[0]
    ref = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jgrads), model.cfg)
    # the pooler is outside the loss: no gradient in the port, zeros in JAX
    assert set(ref) - set(grads) == {"pooler.weight", "pooler.bias"}
    for name in ("pooler.weight", "pooler.bias"):
        assert not ref[name].any()
    for name, g in grads.items():
        assert g.dtype == torch.float32
        r = ref[name].float()
        err = float((g - r).abs().max())
        assert err <= 2 ** -5 * max(float(r.abs().max()), 1e-30), (name, err)
    _stored_params_are_flat_fp32_views(state, model)


def test_bert_o1_remat_equals_no_remat():
    """The recomputed layers rerun under the intercept: the same losses
    and gradients as without remat, bit for bit."""
    data = _bert_batch(6)
    out = []
    for remat in (False, True):
        _, _, model = _bert_pair(remat)
        out.append(_port_bert_steps(model, data, steps=1))
    assert out[0][1] == out[1][1]
    for name, g in out[0][2].items():
        assert torch.equal(g, out[1][2][name]), name


def _stored_params_are_flat_fp32_views(state, model):
    assert not state.policy.master_weights and len(state.groups) == 1
    flat = state.groups[0].flat
    assert flat.dtype == torch.float32
    lo = flat.data_ptr()
    hi = lo + flat.numel() * flat.element_size()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert lo <= p.data_ptr() < hi, name
        assert state.params[name].data_ptr() == p.data_ptr(), name


# ------------------------------------------------------------------ #
# tiny ResNet O1 + FusedSGD
# ------------------------------------------------------------------ #
TINY = dict(stage_sizes=(1, 1), width=64, num_classes=10)


def _resnet_batch():
    blob = np.load(os.path.join(REPO, "examples", "data",
                                "sample_imagenet.npz"))
    x = blob["images"][:4].astype(np.float32) / 255.0
    return x, (blob["labels"][:4] % 10).astype(np.int32)


def test_resnet_o1_fused_sgd_two_steps_match_jax():
    jm = JaxResNet(JaxResNetConfig(fused_bn=True, stem="s2d",
                                   dtype=jnp.bfloat16, **TINY))
    x, y = _resnet_batch()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    cfg = ResNetConfig(fused_bn=True, stem="s2d", dtype=torch.bfloat16,
                       **TINY)
    model = ResNet(cfg, device="cpu")
    model.load_state_dict(resnet_params_from_jax(params, stats, cfg))

    def apply_fn(p, x, bs):
        return jm.apply({"params": p, "batch_stats": bs}, x, train=True,
                        mutable=["batch_stats"])
    jstate = jax_amp.initialize(
        apply_fn, params, jax_fused_sgd(0.1, momentum=0.9,
                                        weight_decay=1e-4), opt_level="O1")
    jx, jy = jnp.asarray(x), jax.nn.one_hot(jnp.asarray(y), 10)

    @jax.jit
    def step(state, bs):
        def loss_of(p):
            logits, mut = state.apply_fn(p, jx, bs)
            loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(
                logits.astype(jnp.float32)) * jy, axis=-1))
            return state.scale_loss(loss), (loss, mut["batch_stats"])
        grads, (loss, bs) = jax.grad(loss_of, has_aux=True)(
            state.compute_params())
        state, finite = state.apply_gradients(grads=grads)
        return state, bs, loss, finite
    jlosses, bs = [], stats
    for _ in range(2):
        jstate, bs, loss, finite = step(jstate, bs)
        assert bool(finite)
        jlosses.append(float(loss))

    state = amp.initialize(model, fused_sgd(0.1, momentum=0.9,
                                            weight_decay=1e-4))
    assert state.policy.opt_level == "O1"      # amp's default level
    oh = F.one_hot(_t(y).long(), 10).float()
    losses = []
    for _ in range(2):
        loss = -(F.log_softmax(model(_t(x)).float(), dim=-1) * oh).sum(
            -1).mean()
        state.scale_loss(loss).backward()
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    assert jstate.params["fc"]["kernel"].dtype == jnp.float32
    _stored_params_are_flat_fp32_views(state, model)
    assert isinstance(state.loss_scaler, amp.PrecisionPolicy.O1()
                      .make_loss_scale().__class__)
