"""Fused BatchNorm (+ optional residual-add + ReLU) — CUDA kernels plus
plain PyTorch.

Counterpart of ``apex_tpu/ops/batch_norm.py``, with its API and layout:
a channels-last ``(N, ..., C)`` tensor in, ``(y, mean, var)`` out, the
batch mean and biased variance in fp32.  Each direction touches the
activation in two passes, on the kernel path and the plain one alike:

- forward: one reduction (Σx, Σx² per channel), then one map
  ``y = act(x·scale + shift (+ residual))``;
- backward: one reduction giving both statistics (Σdz, Σdz·x̂, which are
  also dβ and dγ), then one map ``dx = a·dz + b + x̂·c`` that also writes
  the residual's cotangent ``dres = dz``.

The four passes are the kernels of ``csrc/batch_norm.cu`` (the Pallas
``_bn_reduce_kernel``, ``_bn_apply_kernel``, ``_bn_bwd_reduce_kernel``
and ``_bn_bwd_dx_kernel``), each beside its plain version here
(``*_reference``); the (C,)-vector arithmetic between them is plain
PyTorch on both paths.  The kernels take any C and any row count, so on
a CUDA tensor ``"auto"`` always launches them.

The input must be laid out densely in the order of its shape: a model
that keeps NCHW activations in ``torch.channels_last`` memory passes
``x.permute(0, 2, 3, 1)``.  Anything else raises rather than paying a
hidden transpose.

Cross-process statistics (SyncBatchNorm): ``axis_names`` (mesh axes,
their group from the current mesh; without a mesh they are unbound and
ignored, as unbound axes are in JAX) or a ``process_group``.  The
per-channel partial sums the reduction pass writes are all-reduced over
the group (one collective of the stacked ``(2, C)``) before the map, and
the backward's ``(Σdz, Σdz·x̂)`` with the mean / variance cotangents
(``(4, C)``) before the dx map; dγ and dβ stay the local sums, which
the data-parallel gradient all-reduce combines.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch import _build
from apex_tpu_torch.core import mesh as mesh_lib
from apex_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["batch_norm_train", "batch_norm_inference", "batch_norm_reference",
           "bn_reduce_reference", "bn_apply_reference",
           "bn_bwd_reduce_reference", "bn_bwd_dx_reference",
           "bn_reduce_kernel", "bn_apply_kernel", "bn_bwd_reduce_kernel",
           "bn_bwd_dx_kernel"]

_ACTS = (None, "relu")
_THREADS = 256
# blocks per SM the grids aim for: the reductions write one partial row
# per block, so they take fewer
_REDUCE_BLOCKS_PER_SM = 4
_MAP_BLOCKS_PER_SM = 8


def _check_act(act):
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")


def sync_group(axis_names=(), process_group=None):
    """The group the statistics reduce over: ``process_group``, else the
    mesh group of ``axis_names``, else None (local statistics; no mesh
    means the axes are unbound)."""
    if process_group is not None:
        return process_group
    if not axis_names or not mesh_lib.mesh_is_initialized():
        return None
    return mesh_lib.get_mesh().group(tuple(axis_names))


def _sum_over(group, *rows):
    """The ``(C,)`` rows summed over ``group`` (one all-reduce of their
    stack), or as they are without a group."""
    if group is None:
        return rows
    st = torch.stack(rows)
    dist.all_reduce(st, group=group)
    return tuple(st)


class AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` (forward all-reduce) whose cotangent is
    summed over the group too (backward all-reduce): the derivative of
    the sum of every rank's loss, as JAX transposes a ``psum``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _epilogue(z, residual, act):
    if residual is not None:
        z = z + residual.float()
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    return z


# --------------------------------------------------------------------- #
# whole-op plain compositions
# --------------------------------------------------------------------- #
def batch_norm_reference(x, weight=None, bias=None, *, eps: float = 1e-5,
                         residual=None, act: Optional[str] = None,
                         axis_names=(), process_group=None):
    """Train-mode BN(+add+ReLU) as the JAX golden composition computes
    it: ``(y, mean, var)``, ``y = (x - mean)·rsqrt(var + eps)·w + b``
    with the biased variance ``max(Σx²/n - mean², 0)``; the sums over
    the ``axis_names`` / ``process_group`` group (differentiable)."""
    _check_act(act)
    group = sync_group(axis_names, process_group)
    dims = tuple(range(x.ndim - 1))
    n = 1
    for d in dims:
        n *= x.shape[d]
    xf = x.float()
    s1, s2 = xf.sum(dims), torch.square(xf).sum(dims)
    if group is not None:
        s1, s2 = AllReduceSum.apply(torch.stack([s1, s2]), group)
        n *= dist.get_world_size(group)
    mean = s1 / float(n)
    var = torch.clamp_min(s2 / float(n) - torch.square(mean), 0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return _epilogue(y, residual, act).to(x.dtype), mean, var


def batch_norm_inference(x, mean, var, weight=None, bias=None, *,
                         eps: float = 1e-5, residual=None,
                         act: Optional[str] = None):
    """Eval-mode BN over given (running) statistics, + optional add and
    ReLU: one elementwise map, as in the JAX package (which has no
    kernel for it)."""
    _check_act(act)
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return _epilogue(y, residual, act).to(x.dtype)


# --------------------------------------------------------------------- #
# the four passes: plain versions
# --------------------------------------------------------------------- #
def bn_reduce_reference(x2):
    """Plain B-12 on ``(rows, C)``: ``(Σx, Σx²)`` per channel, fp32."""
    xf = x2.float()
    return xf.sum(0), torch.square(xf).sum(0)


def bn_apply_reference(x2, res2, scale, shift, relu: bool):
    """Plain B-13: ``act(x·scale + shift (+ res))`` in ``x.dtype``."""
    z = x2.float() * scale + shift
    return _epilogue(z, res2, "relu" if relu else None).to(x2.dtype)


def _dz_xhat(dy, x2, y2, scsh, mean, rstd, relu):
    """dz (dy under the ReLU mask: ``y > 0`` with a residual, else
    ``x·scale + shift > 0``) and x̂, both fp32."""
    xf = x2.float()
    dz = dy.float()
    if relu:
        if y2 is not None:
            mask = y2.float() > 0.0
        else:
            mask = xf * scsh[0] + scsh[1] > 0.0
        dz = dz * mask
    return dz, (xf - mean) * rstd


def bn_bwd_reduce_reference(dy, x2, y2, scsh, mean, rstd, relu: bool):
    """Plain B-14: ``(Σdz, Σdz·x̂)`` per channel, fp32.  ``y2``: the saved
    output (ReLU with a residual) or None; ``scsh``: the saved
    ``(scale, shift)`` (ReLU without one) or None."""
    dz, xhat = _dz_xhat(dy, x2, y2, scsh, mean, rstd, relu)
    return dz.sum(0), (dz * xhat).sum(0)


def bn_bwd_dx_reference(dy, x2, y2, scsh, mean, rstd, a, b, c, relu: bool,
                        has_res: bool):
    """Plain B-15: ``(dx, dres)``, ``dx = a·dz + b + x̂·c`` and ``dres =
    dz`` (None without a residual), both in ``x.dtype``."""
    dz, xhat = _dz_xhat(dy, x2, y2, scsh, mean, rstd, relu)
    dx = (a * dz + b + xhat * c).to(x2.dtype)
    return dx, (dz.to(x2.dtype) if has_res else None)


# --------------------------------------------------------------------- #
# the four passes: CUDA kernels
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(x2, blocks_per_sm, *others):
    """``(vec, chunks)`` of csrc/batch_norm.cu's layout: 16-byte vectors
    of channels when C and every row pointer allow it, and enough row
    chunks for ``blocks_per_sm`` blocks on each SM."""
    rows, c = x2.shape
    vec = 16 // x2.element_size()
    ptrs = [t.data_ptr() for t in (x2,) + others if t is not None]
    if c % vec or any(p % 16 for p in ptrs):
        vec = 1
    cv = c // vec
    tx = min(cv, 32)
    ty = _THREADS // tx
    tiles = -(-cv // tx)
    want = blocks_per_sm * _sm_count(x2.device.index or 0)
    return vec, max(1, min(-(-rows // ty), -(-want // tiles)))


def _check_rows(name, x2, *rows_like):
    if not x2.is_cuda:
        raise ValueError(f"{name}: needs a CUDA tensor, got one on "
                         f"{x2.device}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (rows, C) matrix")
    if x2.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"{name}: unsupported dtype {x2.dtype}")
    for t in rows_like:
        if t is not None and (t.shape != x2.shape or t.dtype != x2.dtype
                              or not t.is_contiguous()
                              or t.device != x2.device):
            raise ValueError(
                f"{name}: every (rows, C) operand must match x "
                f"{tuple(x2.shape)} {x2.dtype} and be contiguous, got "
                f"{tuple(t.shape)} {t.dtype}")


def _vecs(x2, *vs):
    """The (C,) operands as contiguous fp32 on x's device."""
    c = x2.shape[1]
    out = []
    for v in vs:
        if v is None:
            out.append(None)
            continue
        if v.numel() != c or v.device != x2.device:
            raise ValueError(f"per-channel operand of {tuple(v.shape)} on "
                             f"{v.device} for C={c} on {x2.device}")
        out.append(v.reshape(c).float().contiguous())
    return out


def _p(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_I64, _I32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p


def bn_reduce_kernel(x2):
    """B-12 on a ``(rows, C)`` CUDA tensor: ``(Σx, Σx²)``, fp32."""
    _check_rows("bn_reduce", x2)
    rows, c = x2.shape
    vec, chunks = _geometry(x2, _REDUCE_BLOCKS_PER_SM)
    part = torch.empty(chunks, 2, c, dtype=torch.float32, device=x2.device)
    out = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    fn = _build.function("batch_norm", "apex_bn_reduce",
                         [_PTR, _PTR, _PTR, _I64, _I32, _I32, _I32, _I32,
                          _PTR])
    code = fn(x2.data_ptr(), part.data_ptr(), out.data_ptr(), rows, c, vec,
              chunks, _build.FLOAT_CODES[x2.dtype], _stream(x2))
    _build.check(code, "bn_reduce")
    return out[0], out[1]


def bn_apply_kernel(x2, res2, scale, shift, relu: bool):
    """B-13: ``act(x·scale + shift (+ res))`` in ``x.dtype``."""
    _check_rows("bn_apply", x2, res2)
    rows, c = x2.shape
    scale, shift = _vecs(x2, scale, shift)
    y = torch.empty_like(x2)
    vec, chunks = _geometry(x2, _MAP_BLOCKS_PER_SM, res2, y)
    fn = _build.function("batch_norm", "apex_bn_apply",
                         [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32,
                          _I32, _I32, _I32, _PTR])
    code = fn(x2.data_ptr(), _p(res2), scale.data_ptr(), shift.data_ptr(),
              y.data_ptr(), rows, c, vec, chunks, int(relu),
              _build.FLOAT_CODES[x2.dtype], _stream(x2))
    _build.check(code, "bn_apply")
    return y


def _bwd_operands(name, dy, x2, y2, scsh, mean, rstd, relu):
    dy = dy.to(x2.dtype).contiguous()
    _check_rows(name, x2, dy, y2)
    if relu and y2 is None and scsh is None:
        raise ValueError(f"{name}: the ReLU mask needs y or (scale, shift)")
    scale, shift = _vecs(x2, *(scsh if scsh is not None else (None, None)))
    mean, rstd = _vecs(x2, mean, rstd)
    return dy, (y2 if relu else None), scale, shift, mean, rstd


def bn_bwd_reduce_kernel(dy, x2, y2, scsh, mean, rstd, relu: bool):
    """B-14: ``(Σdz, Σdz·x̂)``, fp32 (arguments as the plain version's)."""
    dy, y2, scale, shift, mean, rstd = _bwd_operands(
        "bn_bwd_reduce", dy, x2, y2, scsh, mean, rstd, relu)
    rows, c = x2.shape
    vec, chunks = _geometry(x2, _REDUCE_BLOCKS_PER_SM, dy, y2)
    part = torch.empty(chunks, 2, c, dtype=torch.float32, device=x2.device)
    out = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    fn = _build.function("batch_norm", "apex_bn_bwd_reduce",
                         [_PTR] * 9 + [_I64, _I32, _I32, _I32, _I32, _I32,
                                       _PTR])
    code = fn(dy.data_ptr(), x2.data_ptr(), _p(y2), _p(scale), _p(shift),
              mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
              out.data_ptr(), rows, c, vec, chunks, int(relu),
              _build.FLOAT_CODES[x2.dtype], _stream(x2))
    _build.check(code, "bn_bwd_reduce")
    return out[0], out[1]


def bn_bwd_dx_kernel(dy, x2, y2, scsh, mean, rstd, a, b, c, relu: bool,
                     has_res: bool):
    """B-15: ``(dx, dres)`` in ``x.dtype`` (``dres`` None without a
    residual)."""
    dy, y2, scale, shift, mean, rstd = _bwd_operands(
        "bn_bwd_dx", dy, x2, y2, scsh, mean, rstd, relu)
    a, b, c = _vecs(x2, a, b, c)
    rows, ch = x2.shape
    dx = torch.empty_like(x2)
    dres = torch.empty_like(x2) if has_res else None
    vec, chunks = _geometry(x2, _MAP_BLOCKS_PER_SM, dy, y2, dx, dres)
    fn = _build.function("batch_norm", "apex_bn_bwd_dx",
                         [_PTR] * 12 + [_I64, _I32, _I32, _I32, _I32, _I32,
                                        _PTR])
    code = fn(dy.data_ptr(), x2.data_ptr(), _p(y2), _p(scale), _p(shift),
              mean.data_ptr(), rstd.data_ptr(), a.data_ptr(), b.data_ptr(),
              c.data_ptr(), dx.data_ptr(), _p(dres), rows, ch, vec, chunks,
              int(relu), _build.FLOAT_CODES[x2.dtype], _stream(x2))
    _build.check(code, "bn_bwd_dx")
    return dx, dres


_PASSES = {
    False: (bn_reduce_reference, bn_apply_reference, bn_bwd_reduce_reference,
            bn_bwd_dx_reference),
    True: (bn_reduce_kernel, bn_apply_kernel, bn_bwd_reduce_kernel,
           bn_bwd_dx_kernel),
}


# --------------------------------------------------------------------- #
# the autograd core (``_bn_core`` with its custom_vjp)
# --------------------------------------------------------------------- #
class _BatchNormFn(torch.autograd.Function):
    """``(y, mean, var)`` of ``(rows, C)`` ``x2``; the backward is the
    single-reduction one of ``_bn_core_bwd``, mean/var cotangents
    included."""

    @staticmethod
    def forward(ctx, x2, w, b, res2, eps, relu, kernel, group):
        reduce, apply, _, _ = _PASSES[kernel]
        n = float(x2.shape[0])
        s1, s2 = _sum_over(group, *reduce(x2))
        if group is not None:
            n *= dist.get_world_size(group)
        ctx.n, ctx.group = n, group
        mean = s1 / n
        var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
        rstd = torch.rsqrt(var + eps)
        scale = rstd * w.float()
        shift = b.float() - mean * scale
        y2 = apply(x2, res2, scale, shift, relu)
        has_res = res2 is not None
        # the ReLU mask's source: y with a residual (the affine alone
        # cannot tell the sign), else the (C,) scale and shift
        ctx.save_for_backward(x2, w, mean, rstd,
                              y2 if relu and has_res else None,
                              scale if relu and not has_res else None,
                              shift if relu and not has_res else None)
        ctx.relu, ctx.kernel, ctx.has_res = relu, kernel, has_res
        ctx.set_materialize_grads(False)
        return y2, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2, w, mean, rstd, y2, scale, shift = ctx.saved_tensors
        _, _, bwd_reduce, bwd_dx = _PASSES[ctx.kernel]
        n = ctx.n
        if dy is None:
            dy = torch.zeros_like(x2)
        scsh = None if scale is None else (scale, shift)
        s1, s2 = bwd_reduce(dy, x2, y2, scsh, mean, rstd, ctx.relu)
        a = rstd * w.float()
        gm = torch.zeros_like(s1) if dmean is None else dmean.float()
        gv = torch.zeros_like(s2) if dvar is None else dvar.float()
        # dx needs the group's sums; dγ, dβ stay local
        g1, g2, gm, gv = _sum_over(ctx.group, s1, s2, gm, gv)
        bcoef = (gm - a * g1) / n
        ccoef = (2.0 * gv / rstd - a * g2) / n
        dx, dres = bwd_dx(dy, x2, y2, scsh, mean, rstd, a, bcoef, ccoef,
                          ctx.relu, ctx.has_res)
        # dγ, dβ: the local sums of the one reduction
        return (dx, s2.to(w.dtype), s1.to(w.dtype), dres, None, None, None,
                None)


def batch_norm_train(x, weight=None, bias=None, *, eps: float = 1e-5,
                     residual=None, act: Optional[str] = None,
                     axis_names=(), process_group=None,
                     implementation: Optional[str] = None):
    """Fused train-mode BatchNorm(+residual-add+ReLU) over a channels-last
    ``(N, ..., C)`` tensor: ``(y, mean, var)``, the statistics fp32 (the
    variance biased, for the caller's running-stats update).  With
    ``axis_names`` (a mesh's) or ``process_group`` the statistics are the
    group's (module docstring).

    ``residual`` (x's shape) is added after the affine, before ``act``
    (None or ``"relu"``); its cotangent comes out of the fused backward.
    Differentiable in ``x``, ``weight``, ``bias`` and ``residual``, and
    through ``mean`` and ``var``.  ``implementation`` as in
    :mod:`._dispatch`.  ``x`` (and ``residual``) must be laid out densely
    in the order of their shape, else ValueError.
    """
    _check_act(act)
    group = sync_group(axis_names, process_group)
    if residual is not None and residual.shape != x.shape:
        raise ValueError(
            f"residual shape {tuple(residual.shape)} != x shape "
            f"{tuple(x.shape)}")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(
                f"batch_norm_train: {name} of shape {tuple(t.shape)} has "
                f"strides {t.stride()}; it must be channels-last and dense "
                "(hand it x.permute(0, 2, 3, 1) of a torch.channels_last "
                "NCHW tensor)")
    kernel = resolve_impl(implementation, x) == "kernel"
    c = x.shape[-1]
    x2 = x.view(-1, c)
    res2 = None if residual is None else residual.view(-1, c)
    w = weight if weight is not None else torch.ones(
        c, dtype=torch.float32, device=x.device)
    b = bias if bias is not None else torch.zeros(
        c, dtype=torch.float32, device=x.device)
    y2, mean, var = _BatchNormFn.apply(x2, w, b, res2, float(eps),
                                       act == "relu", kernel, group)
    return y2.view(x.shape), mean, var
