"""The port's fused BatchNorm held against the JAX package's.

Inputs come from a numpy seed and go through JAX ``batch_norm_train``,
both on its XLA path and through the Pallas kernels in interpret mode,
and through the port's plain path on the CPU: ``y``, ``mean`` and
``var``, and ``dx``, ``dγ``, ``dβ`` and ``dres`` through ``jax.vjp``,
for act None / ``"relu"`` × residual or none.  Tolerances: fp32 within
1e-5 of each tensor's largest entry (sums in another order); bf16 ``y``
within one bf16 ulp of JAX's (the fp32 scale and shift differ in their
last bits, which moves a rounding by at most one ulp) and the gradients
within 2^-7 of each tensor's largest entry (bf16 rounds dy, dx and dres).
An odd channel count runs against the XLA path only (outside the Pallas
kernels' envelope).  ``SyncBatchNorm`` is held against the JAX module in
train and eval mode, running statistics included.  The ``cuda``-marked
tests hold each kernel against its plain version on a GPU and skip here.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.batch_norm import batch_norm_inference as jax_bn_inference
from apex_tpu.ops.batch_norm import batch_norm_train as jax_bn_train
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch import _build
from apex_tpu_torch.ops import batch_norm as B
from apex_tpu_torch.parallel import (
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm_stats,
)

IMPLS = ("xla", "pallas_interpret")


def _data(seed, shape=(4, 6, 6, 64), dtype=np.float32):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (0.5 + rng.normal(size=shape)).astype(dtype)
    res = rng.normal(size=shape).astype(dtype)
    w = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=shape).astype(dtype)
    return x, res, w, b, dy


def _t(a, dtype=None, grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _rel(port, ref, tol, what=""):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = port.detach().float().numpy()
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err)


def _bf16_ulp(port, ref):
    """|port - ref| within one bf16 ulp of ref, elementwise."""
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = port.detach().float().numpy()
    mag = np.abs(ref)
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(np.maximum(
        mag, 1e-30))) - 7), 0.0)
    assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


def _jax_run(impl, x, w, b, r, act, dy, jdtype):
    """JAX forward and its vjp for cotangent (dy, 0, 0)."""
    args = (jnp.asarray(x, jdtype), jnp.asarray(w), jnp.asarray(b))
    if r is not None:
        args += (jnp.asarray(r, jdtype),)

    def f(*a):
        return jax_bn_train(a[0], a[1], a[2],
                            residual=a[3] if len(a) > 3 else None, act=act,
                            implementation=impl)
    (y, mean, var), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(dy, jdtype), jnp.zeros_like(mean),
                 jnp.zeros_like(var)))
    return (y, mean, var), grads


def _port_run(x, w, b, r, act, dy, dtype):
    xt, wt, bt = _t(x, dtype, True), _t(w, None, True), _t(b, None, True)
    rt = None if r is None else _t(r, dtype, True)
    y, mean, var = B.batch_norm_train(xt, wt, bt, residual=rt, act=act)
    ins = (xt, wt, bt) + ((rt,) if rt is not None else ())
    grads = torch.autograd.grad(y, ins, _t(dy, dtype))
    return (y, mean, var), grads


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("use_res", [False, True])
def test_fp32_forward_and_backward_match_jax(impl, c, act, use_res):
    x, res, w, b, dy = _data(c + (act is None) + 2 * use_res,
                             shape=(4, 6, 6, c))
    r = res if use_res else None
    (jy, jm, jv), jg = _jax_run(impl, x, w, b, r, act, dy, jnp.float32)
    (y, m, v), g = _port_run(x, w, b, r, act, dy, torch.float32)
    for port, ref, what in ((y, jy, "y"), (m, jm, "mean"), (v, jv, "var")):
        _rel(port, ref, 1e-5, what)
    for port, ref, what in zip(g, jg, ("dx", "dw", "db", "dres")):
        _rel(port, ref, 1e-5, what)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("use_res", [False, True])
def test_bf16_matches_jax(impl, act, use_res):
    x, res, w, b, dy = _data(7 + 2 * use_res + (act is None))
    r = res if use_res else None
    (jy, jm, jv), jg = _jax_run(impl, x, w, b, r, act, dy, jnp.bfloat16)
    (y, m, v), g = _port_run(x, w, b, r, act, dy, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and m.dtype == torch.float32
    _bf16_ulp(y, jy)
    _rel(m, jm, 1e-5, "mean")
    _rel(v, jv, 1e-5, "var")
    for port, ref, what in zip(g, jg, ("dx", "dw", "db", "dres")):
        _rel(port, ref, 2 ** -7, what)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("use_res", [False, True])
def test_odd_channels_match_jax_xla(act, use_res):
    x, res, w, b, dy = _data(11, shape=(3, 5, 5, 37))
    r = res if use_res else None
    (jy, jm, jv), jg = _jax_run("xla", x, w, b, r, act, dy, jnp.float32)
    (y, m, v), g = _port_run(x, w, b, r, act, dy, torch.float32)
    for port, ref in ((y, jy), (m, jm), (v, jv)) + tuple(zip(g, jg)):
        _rel(port, ref, 1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_reading_mean_and_var_matches_jax(impl):
    """The mean/var cotangents (gm, gv) enter the dx coefficients."""
    x, res, w, b, _ = _data(13)

    def jloss(x, w, b, r):
        y, m, v = jax_bn_train(x, w, b, residual=r, act="relu",
                               implementation=impl)
        return jnp.sum(y * jnp.cos(y)) + jnp.sum(m * 2.0) + jnp.sum(v * 3.0)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, b, res)))
    ins = [_t(a, None, True) for a in (x, w, b, res)]
    y, m, v = B.batch_norm_train(ins[0], ins[1], ins[2], residual=ins[3],
                                 act="relu")
    loss = (y * torch.cos(y)).sum() + (m * 2.0).sum() + (v * 3.0).sum()
    g = torch.autograd.grad(loss, ins)
    for port, ref, what in zip(g, jg, ("dx", "dw", "db", "dres")):
        _rel(port, ref, 1e-5, what)


def test_reference_composition_matches_jax():
    from apex_tpu.ops.batch_norm import batch_norm_reference as jax_ref
    x, res, w, b, _ = _data(17)
    jy, jm, jv = jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         residual=jnp.asarray(res), act="relu")
    y, m, v = B.batch_norm_reference(_t(x), _t(w), _t(b), residual=_t(res),
                                     act="relu")
    for port, ref in ((y, jy), (m, jm), (v, jv)):
        _rel(port, ref, 1e-5)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("use_res", [False, True])
def test_inference_matches_jax(act, use_res):
    x, res, w, b, _ = _data(19)
    rng = np.random.default_rng(20)
    mean = rng.normal(size=64).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    r = res if use_res else None
    ref = jax_bn_inference(jnp.asarray(x), jnp.asarray(mean),
                           jnp.asarray(var), jnp.asarray(w), jnp.asarray(b),
                           residual=None if r is None else jnp.asarray(r),
                           act=act)
    got = B.batch_norm_inference(_t(x), _t(mean), _t(var), _t(w), _t(b),
                                 residual=None if r is None else _t(r),
                                 act=act)
    _rel(got, ref, 1e-6)


def test_no_weight_or_bias_and_grad_free_call():
    x, _, _, _, _ = _data(23)
    jy, jm, jv = jax_bn_train(jnp.asarray(x), implementation="xla")
    y, m, v = B.batch_norm_train(_t(x))
    for port, ref in ((y, jy), (m, jm), (v, jv)):
        _rel(port, ref, 1e-5)


# ------------------------------------------------------------------ #
# SyncBatchNorm
# ------------------------------------------------------------------ #
def _jax_module_run(x, w, b, m0, v0, act, r, train, fused):
    mod = JaxSyncBN(axis_names=None, fused=fused, act=act)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(m0),
                                 "var": jnp.asarray(v0)}}
    kw = dict(use_running_average=not train,
              residual=None if r is None else jnp.asarray(r))
    if not train:
        return mod.apply(variables, jnp.asarray(x), **kw), variables[
            "batch_stats"]
    y, mut = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"],
                       **kw)
    return y, mut["batch_stats"]


def _port_module(w, b, m0, v0, act, fused):
    mod = SyncBatchNorm(64, fused=fused, act=act, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(_t(w))
        mod.bias.copy_(_t(b))
        mod.mean.copy_(_t(m0))
        mod.var.copy_(_t(v0))
    return mod


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_sync_batchnorm_matches_jax_module(fused, train):
    x, res, w, b, _ = _data(29)
    rng = np.random.default_rng(30)
    m0 = rng.normal(size=64).astype(np.float32)
    v0 = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    jy, jstats = _jax_module_run(x, w, b, m0, v0, "relu", res, train, fused)
    mod = _port_module(w, b, m0, v0, "relu", fused)
    mod.train(train)
    y = mod(_t(x), residual=_t(res))
    _rel(y, jy, 1e-5, "y")
    # running statistics: 0.9 old + 0.1 batch, the variance Bessel-
    # corrected by n / (n - 1) with n = 4*6*6
    _rel(mod.mean, jstats["mean"], 1e-5, "mean")
    _rel(mod.var, jstats["var"], 1e-5, "var")
    if train:
        xf = x.reshape(-1, 64).astype(np.float64)
        n = xf.shape[0]
        want = 0.9 * v0 + 0.1 * xf.var(0) * n / (n - 1)
        np.testing.assert_allclose(mod.var.numpy(), want, rtol=1e-5)
    else:
        assert torch.equal(mod.var, _t(v0))


def test_fused_module_equals_unfused_with_gradients():
    x, res, w, b, dy = _data(31)
    outs = []
    for fused in (True, False):
        mod = _port_module(w, b, np.zeros(64, np.float32),
                           np.ones(64, np.float32), "relu", fused)
        xt, rt = _t(x, None, True), _t(res, None, True)
        y = mod(xt, residual=rt)
        g = torch.autograd.grad(y, (xt, rt, mod.weight, mod.bias), _t(dy))
        outs.append((y, mod.mean.clone(), mod.var.clone()) + g)
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)


def test_sync_batch_norm_stats_match_jax():
    from apex_tpu.parallel.sync_batchnorm import (
        sync_batch_norm_stats as jax_stats)
    x, _, _, _, _ = _data(37)
    jm, jv = jax_stats(jnp.asarray(x), (), reduce_dims=(0, 1, 2))
    m, v = sync_batch_norm_stats(_t(x), reduce_dims=(0, 1, 2))
    _rel(m, jm, 1e-5)
    _rel(v, jv, 1e-5)


def test_running_stats_are_fp32_buffers_under_a_bf16_input():
    mod = SyncBatchNorm(64, fused=True, device="cpu")
    assert [n for n, _ in mod.named_buffers()] == ["mean", "var"]
    mod(_t(_data(41)[0], torch.bfloat16))
    assert mod.mean.dtype == mod.var.dtype == torch.float32


def test_flax_batchnorm_agrees_on_the_normalisation():
    """The port's train-mode y equals flax ``nn.BatchNorm``'s."""
    x, _, w, b, _ = _data(43)
    bn = jnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
         "batch_stats": {"mean": jnp.zeros(64), "var": jnp.ones(64)}}
    jy, _ = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    y, _, _ = B.batch_norm_train(_t(x), _t(w), _t(b))
    _rel(y, jy, 1e-5)


# ------------------------------------------------------------------ #
# what the op refuses
# ------------------------------------------------------------------ #
def test_axis_names_and_process_groups_name_a5():
    # cross-process statistics are ported (item 10a; the multi-process
    # checks are in test_torch_parallel.py).  Without a mesh the axes
    # are unbound and the statistics local, as JAX ignores unbound axes
    x = _t(_data(47)[0])
    y0, m0, v0 = B.batch_norm_train(x)
    y1, m1, v1 = B.batch_norm_train(x, axis_names=("data",))
    assert torch.equal(y0, y1) and torch.equal(m0, m1) and torch.equal(v0, v1)
    bn = SyncBatchNorm(64, axis_names=("data",), device="cpu")
    assert bn.axis_names == ("data",)
    assert torch.equal(bn(x), SyncBatchNorm(64, device="cpu")(x))
    pg = SyncBatchNorm(64, process_group=object(), device="cpu")
    assert pg.process_group is not None
    lin = torch.nn.Linear(2, 2)
    assert convert_syncbn_model(lin) is lin
    seq = torch.nn.Sequential(SyncBatchNorm(64, device="cpu"))
    assert convert_syncbn_model(seq)[0].axis_names == ("data",)
    mean, var = sync_batch_norm_stats(x, ("data",), reduce_dims=(0, 1, 2))
    assert torch.equal(mean, m0)


def test_layout_and_argument_checks():
    x = _t(_data(53)[0])
    # an NCHW-contiguous tensor seen as NHWC is not dense: no hidden copy
    nchw = x.permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="channels-last"):
        B.batch_norm_train(nchw.permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="unknown act"):
        B.batch_norm_train(x, act="gelu")
    with pytest.raises(ValueError, match="residual shape"):
        B.batch_norm_train(x, residual=x[:2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        B.batch_norm_train(x, implementation="kernel")
    with pytest.raises(ValueError, match="unknown act"):
        SyncBatchNorm(64, act="tanh", device="cpu")


def test_launch_counters_exist():
    for name in ("bn_reduce", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        assert name in _build.launches
    assert _build.SOURCES["batch_norm"] == "batch_norm.cu"


# ------------------------------------------------------------------ #
# the CUDA kernels against their plain versions (GPU only)
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(dev, rows, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (0.5 + torch.randn(rows, c, generator=g, device=dev)).to(dtype)
    res = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    dy = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    return x, res, dy, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(4096, 64), (1000, 256), (333, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,use_res", [(None, False), ("relu", False),
                                         ("relu", True)])
def test_kernels_match_plain_on_card(rows, c, dtype, act, use_res,
                                     cuda_device):
    """B-12/B-14 within 1e-5 of Σ|term| per channel; B-13/B-15 bitwise
    on the same per-channel vectors."""
    x, res, dy, w, b = _card_case(cuda_device, rows, c, dtype, rows + c)
    r = res if use_res else None
    relu = act == "relu"
    s1, s2 = B.bn_reduce_kernel(x)
    p1, p2 = B.bn_reduce_reference(x)
    xf = x.float()
    torch.testing.assert_close(s1, p1, rtol=0, atol=1e-5 * float(
        xf.abs().sum(0).max()))
    torch.testing.assert_close(s2, p2, rtol=0, atol=1e-5 * float(
        p2.max()))
    mean = p1 / rows
    var = torch.clamp_min(p2 / rows - mean * mean, 0.0)
    rstd = torch.rsqrt(var + 1e-5)
    scale, shift = rstd * w, b - mean * rstd * w
    y = B.bn_apply_kernel(x, r, scale, shift, relu)
    yp = B.bn_apply_reference(x, r, scale, shift, relu)
    assert torch.equal(y, yp)
    ys = yp if relu and use_res else None
    scsh = (scale, shift) if relu and not use_res else None
    t1, t2 = B.bn_bwd_reduce_kernel(dy, x, ys, scsh, mean, rstd, relu)
    q1, q2 = B.bn_bwd_reduce_reference(dy, x, ys, scsh, mean, rstd, relu)
    torch.testing.assert_close(t1, q1, rtol=0, atol=1e-5 * float(
        dy.float().abs().sum(0).max()))
    torch.testing.assert_close(t2, q2, rtol=0, atol=1e-4 * float(
        (dy.float() * (xf - mean) * rstd).abs().sum(0).max()))
    a = rstd * w
    cb, cc = -a * q1 / rows, -a * q2 / rows
    dx, dres = B.bn_bwd_dx_kernel(dy, x, ys, scsh, mean, rstd, a, cb, cc,
                                  relu, use_res)
    dxp, dresp = B.bn_bwd_dx_reference(dy, x, ys, scsh, mean, rstd, a, cb,
                                       cc, relu, use_res)
    assert torch.equal(dx, dxp)
    assert (dres is None) == (not use_res)
    if use_res:
        assert torch.equal(dres, dresp)


@pytest.mark.cuda
def test_auto_launches_the_kernels_and_matches_torch_on_card(cuda_device):
    x, res, dy, w, b = _card_case(cuda_device, 2048, 128, torch.float32, 5)
    outs = []
    for impl in ("auto", "torch"):
        _build.reset_launches()
        xt, rt = x.clone().requires_grad_(), res.clone().requires_grad_()
        y, m, v = B.batch_norm_train(xt.view(8, 16, 16, 128), w, b,
                                     residual=rt.view(8, 16, 16, 128),
                                     act="relu", implementation=impl)
        g = torch.autograd.grad(y, (xt, rt), dy.view(8, 16, 16, 128))
        counts = [_build.launches[n] for n in
                  ("bn_reduce", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")]
        assert counts == ([1, 1, 1, 1] if impl == "auto" else [0, 0, 0, 0])
        outs.append((y, m, v) + g)
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)
