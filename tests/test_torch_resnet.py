"""The port's ResNet training path held against the JAX package's.

A tiny ResNet (``stage_sizes=(1, 1)``, width 64, 10 classes) on b=4
32×32 images from ``examples/data/sample_imagenet.npz`` (scaled /255),
with the JAX model's weights carried over by ``resnet_params_from_jax``,
on the CPU, for both stems and the fused BN: under fp32 O0 the logits and
every parameter's gradient within 1e-4 of each tensor's largest entry
(fp32 sums in another order through two stages), the running statistics
after one step within 1e-5.  Two steps of amp O2 (bf16) with FusedSGD
(lr 0.1, momentum 0.9, weight decay 1e-4) against the JAX
``amp.initialize(..., fused_sgd(...), opt_level="O2")`` state: the losses
within 2e-2 of JAX's (a bf16 forward rounds at other places in the two
frameworks: one bf16 ulp is 2^-8 relative, through 14 convs and BNs),
each fp32 master's change within 25% of the largest change of its
tensor (with batch statistics over 4 images, bf16 alone moves the first
step's gradients 20-35% of their largest entry away from the fp32 ones,
while the port's and JAX's bf16 gradients differ by 1-7%; momentum
carries that into the second step, and leaving momentum out would move
the second update by ~90%).  ``fused_sgd`` alone equals
JAX ``fused_sgd`` exactly in fp32.  The space-to-depth helpers equal
JAX's bitwise; one stride-2 ``conv2`` pins flax's asymmetric "SAME"
padding.
"""

import os

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jax_amp
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu.models.resnet import space_to_depth as jax_s2d
from apex_tpu.models.resnet import stem_conv_to_s2d as jax_stem_to_s2d
from apex_tpu.optim import fused_sgd as jax_fused_sgd
from apex_tpu_torch import _build, amp
from apex_tpu_torch.models import (
    ResNet,
    ResNetConfig,
    convert_stem_to_s2d,
    resnet50,
    resnet_params_from_jax,
    space_to_depth,
    stem_conv_to_s2d,
)
from apex_tpu_torch.models.resnet import _Conv
from apex_tpu_torch.optim import fused_sgd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(stage_sizes=(1, 1), width=64, num_classes=10)


def _batch():
    blob = np.load(os.path.join(REPO, "examples", "data",
                                "sample_imagenet.npz"))
    x = blob["images"][:4].astype(np.float32) / 255.0
    return x, (blob["labels"][:4] % 10).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(port, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err)


def _build_pair(stem, half=False):
    """(jax model, params, batch_stats, port model) with one weight set."""
    jdt = jnp.bfloat16 if half else jnp.float32
    jm = JaxResNet(JaxResNetConfig(fused_bn=True, stem=stem, dtype=jdt,
                                   **TINY))
    x, _ = _batch()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    cfg = ResNetConfig(fused_bn=True, stem=stem,
                       dtype=torch.bfloat16 if half else torch.float32,
                       **TINY)
    model = ResNet(cfg, device="cpu")
    model.load_state_dict(resnet_params_from_jax(params, stats, cfg))
    return jm, params, stats, model


def _jax_loss(logits, y, classes=10):
    oh = jax.nn.one_hot(y, classes)
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits.astype(jnp.float32))
                             * oh, axis=-1))


def _port_loss(logits, y, classes=10):
    oh = F.one_hot(y.long(), classes).float()
    return -(F.log_softmax(logits.float(), dim=-1) * oh).sum(-1).mean()


# ------------------------------------------------------------------ #
# layout helpers and padding
# ------------------------------------------------------------------ #
def test_space_to_depth_equals_jax_bitwise():
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(space_to_depth(_t(x)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x))))
    with pytest.raises(ValueError, match="not divisible"):
        space_to_depth(_t(x[:, :7]))


def test_stem_conv_to_s2d_equals_jax_bitwise():
    w7 = np.random.default_rng(1).normal(size=(7, 7, 3, 64)).astype(
        np.float32)                                        # HWIO
    ref = np.asarray(jax_stem_to_s2d(jnp.asarray(w7))).transpose(3, 2, 0, 1)
    got = stem_conv_to_s2d(_t(w7.transpose(3, 2, 0, 1)))   # OIHW
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="7, 7"):
        stem_conv_to_s2d(torch.zeros(64, 3, 3, 3))


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_conv2_pads_like_flax(size):
    """flax "SAME" at stride 2 pads (0, 1) on an even input, (1, 1) on
    an odd one; torch's padding=1 would pad (1, 1) on both."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 16)).astype(np.float32)
    conv = jnn.Conv(8, (3, 3), (2, 2), padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(v, jnp.asarray(x)))
    port = _Conv(16, 8, 3, 2, "SAME", ResNetConfig(), "cpu")
    with torch.no_grad():
        port.weight.copy_(_t(np.asarray(v["params"]["kernel"]).transpose(
            3, 2, 0, 1)))
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ #
# the tiny ResNet, fp32 O0
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_tiny_resnet_logits_grads_and_running_stats_match_jax(stem):
    jm, params, stats, model = _build_pair(stem)
    x, y = _batch()

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return _jax_loss(logits, jnp.asarray(y)), (logits, mut)
    (jloss, (jlogits, mut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = model(_t(x))
    loss = _port_loss(logits, _t(y))
    loss.backward()
    _rel_close(logits, jlogits, 1e-4, "logits")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    cfg = model.cfg
    ref = resnet_params_from_jax(jax.tree.map(np.asarray, jgrads), {}, cfg)
    names = dict(model.named_parameters())
    assert set(ref) == set(names)
    for name, g in ref.items():
        _rel_close(names[name].grad, g.numpy(), 1e-4, name)
    want = resnet_params_from_jax(params, jax.tree.map(
        np.asarray, mut["batch_stats"]), cfg)
    bufs = dict(model.named_buffers())
    assert len(bufs) == 2 * (1 + 3 * 2 + 2)   # 9 BNs, mean and var each
    for name, buf in bufs.items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_unfused_and_eval_mode_agree_with_the_fused_model():
    _, params, stats, fused = _build_pair("s2d")
    cfg = ResNetConfig(stem="s2d", **TINY)
    plain = ResNet(cfg, device="cpu")
    plain.load_state_dict(fused.state_dict())
    x, _ = _batch()
    for mode in ("train", "eval"):
        for m in (fused, plain):
            m.train(mode == "train")
        torch.testing.assert_close(fused(_t(x)), plain(_t(x)), rtol=1e-5,
                                   atol=1e-5)
    for (n, a), (_, b) in zip(fused.named_buffers(), plain.named_buffers()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=n)


def test_s2d_stem_computes_the_7x7_stem():
    _, _, _, conv = _build_pair("conv")
    s2d = ResNet(ResNetConfig(stem="s2d", fused_bn=True, **TINY),
                 device="cpu")
    s2d.load_state_dict(convert_stem_to_s2d(conv.state_dict()))
    x, _ = _batch()
    torch.testing.assert_close(s2d(_t(x)), conv(_t(x)), rtol=1e-4,
                               atol=1e-4)


def test_module_names_and_layouts():
    model = resnet50(device="cpu", num_classes=10)
    names = [n for n, _ in model.named_parameters()]
    assert names[:3] == ["stem.weight", "bn_stem.weight", "bn_stem.bias"]
    assert "stage3_block2.bn3.weight" in names
    assert "stage1_block0.bn_down.bias" in names
    assert "stage1_block1.downsample.weight" not in names
    assert names[-2:] == ["fc.weight", "fc.bias"]
    bns = [n for n, _ in model.named_buffers() if n.endswith(".mean")]
    assert len(bns) == 53          # the stem, 3 per block x 16, 4 bn_down
    assert model.stem.weight.shape == (64, 3, 7, 7)
    assert model.fc.weight.shape == (10, 2048)
    with pytest.raises(ValueError, match="unknown stem"):
        ResNet(ResNetConfig(stem="patch"), device="cpu")
    # bn_axis_names (item 10a): every BN takes the data group's
    # statistics on a mesh, the local ones without
    synced = ResNet(ResNetConfig(bn_axis_names=("data",), **TINY),
                    device="cpu")
    bns = [m for m in synced.modules() if hasattr(m, "axis_names")]
    assert len(bns) == len([n for n, _ in synced.named_buffers()
                            if n.endswith(".mean")]) > 0
    assert all(m.axis_names == ("data",) for m in bns)


# ------------------------------------------------------------------ #
# amp O2 + FusedSGD
# ------------------------------------------------------------------ #
def _jax_o2_steps(jm, params, stats, steps, data):
    tx = jax_fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)

    def apply_fn(p, x, bs):
        return jm.apply({"params": p, "batch_stats": bs}, x, train=True,
                        mutable=["batch_stats"])
    state = jax_amp.initialize(apply_fn, params, tx, opt_level="O2",
                               half_dtype=jnp.bfloat16)
    x, y = (jnp.asarray(a) for a in data)

    @jax.jit
    def step(state, bs):
        def loss_of(p):
            logits, mut = state.apply_fn(p, x, bs)
            loss = _jax_loss(logits, y)
            return state.scale_loss(loss), (loss, mut["batch_stats"])
        grads, (loss, bs) = jax.grad(loss_of, has_aux=True)(
            state.compute_params())
        state, finite = state.apply_gradients(grads=grads)
        return state, bs, loss, finite
    losses = []
    for _ in range(steps):
        state, stats, loss, finite = step(state, stats)
        assert bool(finite)
        losses.append(float(loss))
    return state, losses


def test_o2_fused_sgd_two_steps_match_jax():
    jm, params, stats, model = _build_pair("s2d", half=True)
    data = _batch()
    jstate, jlosses = _jax_o2_steps(jm, params, stats, 2, data)
    state = amp.initialize(model, fused_sgd(0.1, momentum=0.9,
                                            weight_decay=1e-4), "O2")
    start = {n: p.clone() for n, p in state.params.items()}
    x, y = (_t(a) for a in data)
    losses = []
    for _ in range(2):
        loss = _port_loss(model(x), y)
        state.scale_loss(loss).backward()
        assert bool(state.apply_gradients())
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    ref = resnet_params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                 {}, model.cfg)
    assert set(ref) == set(state.params)
    for name, p in state.params.items():
        assert p.dtype == torch.float32
        _rel_close(p - start[name], ref[name].numpy() - start[name].numpy(),
                   0.25, name)
    # the forward's copy: bf16 convs and classifier, fp32 BN parameters;
    # running statistics are fp32 buffers amp does not touch
    for name, p in model.named_parameters():
        want = torch.float32 if ".bn" in f".{name}" else torch.bfloat16
        assert p.dtype == want, name
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert int(state.opt_state.count) == 2


def test_o1_keeps_fp32_params_and_runs_bf16_convs():
    """amp O1 on the bf16 ResNet: the stored parameters are the module's
    own, fp32 views of one flat buffer with no masters; in the forward
    each conv reads a bf16 copy of its weight, each BN fp32 parameters;
    a FusedSGD step trains them in place."""
    model = ResNet(ResNetConfig(dtype=torch.bfloat16, **TINY), device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    state = amp.initialize(model, fused_sgd(0.1, momentum=0.9), "O1")
    assert len(state.groups) == 1 and not state.policy.master_weights
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n:
            seen.setdefault(n, mod.weight.dtype) and None)
        for n, m in model.named_modules() if n in ("stem", "bn_stem", "fc")]
    x, y = (_t(a) for a in _batch())
    before = state.params["stem.weight"].clone()
    loss = _port_loss(model(x), y)
    state.scale_loss(loss).backward()
    assert bool(state.apply_gradients())
    for h in hooks:
        h.remove()
    assert seen == {"stem": torch.bfloat16, "bn_stem": torch.float32,
                    "fc": torch.bfloat16}
    assert not torch.equal(state.params["stem.weight"], before)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert p.data_ptr() == state.params[name].data_ptr()


# ------------------------------------------------------------------ #
# FusedSGD alone
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kw", [
    dict(momentum=0.9, weight_decay=1e-4),
    dict(momentum=0.9, dampening=0.1),
    dict(momentum=0.9, nesterov=True, weight_decay=0.01),
    dict(),
])
def test_fused_sgd_equals_jax_exactly(kw):
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jax_fused_sgd(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    opt = fused_sgd(0.1, **kw)
    tp = [_t(p) for p in params]
    st = opt.init(tp)
    for g in grads:
        upd, jst = tx.update([jnp.asarray(a) for a in g], jst, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        opt.step([_t(a) for a in g], st, tp)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(st.momentum_buf, jst.momentum_buf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(st.count) == int(jst.count) == 3


def test_fused_sgd_skips_a_non_finite_step():
    opt = fused_sgd(0.1, momentum=0.9)
    p = [torch.ones(4)]
    st = opt.init(p)
    opt.step([torch.ones(4)], st, p, finite=torch.tensor(False))
    assert torch.equal(p[0], torch.ones(4)) and int(st.count) == 0
    assert torch.equal(st.momentum_buf[0], torch.zeros(4))
    opt.step([torch.ones(4)], st, p, finite=torch.tensor(True))
    assert int(st.count) == 1 and torch.equal(st.momentum_buf[0],
                                              torch.ones(4))
    torch.testing.assert_close(p[0], torch.full((4,), 0.9))
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, nesterov=True)


# ------------------------------------------------------------------ #
# on the card: the main path's kernels launch (GPU only)
# ------------------------------------------------------------------ #
@pytest.mark.cuda
def test_tiny_resnet_step_launches_each_bn_kernel_per_bn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    model = ResNet(ResNetConfig(fused_bn=True, stem="s2d", **TINY))
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    x, y = (_t(a).cuda() for a in _batch())
    _build.reset_launches()
    _port_loss(model(x), y).backward()
    for name in ("bn_reduce", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        assert _build.launches[name] == 9, name
