"""Fused GroupNorm (+ optional SiLU) over channels-last tensors — CUDA
kernels plus plain PyTorch.

Counterpart of ``apex_tpu/ops/group_norm.py`` (apex's
``contrib.group_norm``, built for diffusion UNets), with its API and
layout: an ``(N, ..., C)`` tensor, ``num_groups`` groups of ``C /
num_groups`` neighbouring channels, statistics per sample and group in
fp32, then the affine and the optional SiLU, cast once to ``x.dtype``.

- :func:`group_norm_reference` is the JAX package's composition
  (two-pass ``jnp.var``), the golden semantics and the CPU path; torch
  autograd differentiates it there, as JAX differentiates its default
  XLA path.
- On a CUDA tensor ``"auto"`` launches the kernels of
  ``csrc/group_norm.cu``, which replace the Pallas ``_gn_fwd_kernel``
  (y plus the saved mean and rstd per sample and group) and
  ``_gn_bwd_kernel`` (dx, and dγ/dβ over the whole batch), through
  :class:`_GroupNormFn`.  Beside each kernel is its plain version with
  the kernel's formulas (:func:`group_norm_fwd_reference`,
  :func:`group_norm_bwd_reference`), which the kernels are held against
  on the card.
- Each direction has two routes, both hand kernels, chosen before any
  launch by :func:`cluster_plan` from the shape, the dtype and the card's
  cluster capacity: the cluster route (one launch; persistent
  thread-block clusters, each holding a slab — a sample's rows of a span
  of whole groups — in its CTAs' shared memory, so each operand is read
  once; launches counted under ``group_norm_fwd`` / ``group_norm_bwd``)
  where a sample's slab fits 16 CTAs and a group is a power-of-two count
  of 16-byte vectors, else the three-pass route
  (``group_norm_fwd_3pass`` / ``group_norm_bwd_3pass``), which takes
  every GroupNorm of SD-1.5's and SDXL's UNets (groups of 10, 20 and 40
  channels) and a VAE decoder's large maps.

The JAX kernels' envelope (``C % 128 == 0``, ``C <= 1024``, an 8-aligned
divisor of the spatial extent) is a TPU tiling rule: the port's kernels
take any C divisible by the groups (SD-1.5's 320 channels, more than
1024), any batch, any spatial extent and the 2-D ``(N, C)`` case.  An
input not laid out densely in the order of its shape is copied first
(none is for ``x.permute(0, 2, 3, 1)`` of a ``torch.channels_last`` NCHW
tensor).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from apex_tpu_torch import _build
from apex_tpu_torch.ops._dispatch import resolve_device, resolve_impl

__all__ = ["group_norm", "group_norm_reference", "GroupNorm",
           "group_norm_fwd_reference", "group_norm_bwd_reference",
           "group_norm_fwd_kernel", "group_norm_bwd_kernel",
           "ClusterPlan", "cluster_plan", "rows_per_cta"]

_ACTS = (None, "silu")
_THREADS = 256
# blocks per SM the three-pass grids aim for: the statistics passes write
# one partial row per block, so they take fewer
_REDUCE_BLOCKS_PER_SM = 4
_MAP_BLOCKS_PER_SM = 8
# the fold after a statistics pass merges chunks x cg partials of a
# (sample, group) in one warp, whose merges are serial: at most this many
# a lane (fewer chunks), unless a thread of the statistics pass would then
# walk more than _MAX_THREAD_ROWS rows (the sweep on the H100: SD-1.5's
# UNet widths fastest near 8 a lane, larger maps near 16-32 rows a thread)
_FOLD_PER_LANE = 8
_MAX_THREAD_ROWS = 32

# the cluster route (csrc/group_norm.cu kClusterThreads, kMaxCluster):
# threads a CTA, CTAs a cluster
CLUSTER_THREADS = 512
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: bytes of each row a slab spans at least, where whole groups allow,
#: forward / backward: the narrowest spans make the smallest clusters
#: (more of them fit the card at once); the backward, which stages dy and
#: x, ran fastest at 64 bytes in bf16 on the H100
SPAN_BYTES = {False: 32, True: 64}
#: 16-byte vectors a thread holds of a slab, forward / backward
#: (csrc/group_norm.cu kFwdK, kBwdK): a CTA's ring holds three stages of
#: K x 8 KB an operand (x; dy and x)
THREAD_VECTORS = {False: 8, True: 4}
#: the widest span a slab may take: 32 vectors, and 128 channels in the
#: backward, whose per-warp sums share the CTA's shared memory with the
#: ring (kMaxSpan, kMaxBwdSpan)
MAX_SPAN_VECTORS = 32
MAX_BWD_SPAN = 128


def _check(c: int, num_groups: int, act) -> None:
    if c % num_groups != 0:
        raise ValueError(
            f"channels {c} not divisible by groups {num_groups}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")


def _stats(xf4, eps: float):
    """``(mean, rstd)`` of ``(N, R, G, cg)`` fp32 over axes (1, 3), kept
    as ``(N, 1, G, 1)``: the mean, then the two-pass variance of
    ``jnp.var``."""
    mean = xf4.mean(dim=(1, 3), keepdim=True)
    var = torch.square(xf4 - mean).mean(dim=(1, 3), keepdim=True)
    return mean, torch.rsqrt(var + eps)


# --------------------------------------------------------------------- #
# plain compositions
# --------------------------------------------------------------------- #
def group_norm_reference(x, num_groups: int, weight=None, bias=None, *,
                         eps: float = 1e-5, act: Optional[str] = None):
    """GroupNorm as the JAX reference composition computes it: fp32
    statistics, ``(x - mean)·rsqrt(var + eps)``, then the affine, then
    SiLU, cast once to ``x.dtype``."""
    c = x.shape[-1]
    _check(c, num_groups, act)
    n = x.shape[0]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean, rstd = _stats(xf, eps)
    y = ((xf - mean) * rstd).reshape(x.shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _affine(c, w, b, device):
    w = torch.ones(c, device=device) if w is None else w.float()
    b = torch.zeros(c, device=device) if b is None else b.float()
    return w, b


def group_norm_fwd_reference(x3, weight, bias, num_groups: int,
                             eps: float = 1e-5, silu: bool = False):
    """Plain B-16 on ``(N, R, C)``: ``(y, mean, rstd)``, y in
    ``x.dtype``, the statistics ``(N, G)`` fp32 (a missing weight or bias
    is ones or zeros)."""
    n, _, c = x3.shape
    w, b = _affine(c, weight, bias, x3.device)
    xf = x3.float().reshape(n, -1, num_groups, c // num_groups)
    mean, rstd = _stats(xf, eps)
    z = ((xf - mean) * rstd).reshape(x3.shape) * w + b
    if silu:
        z = z * torch.sigmoid(z)
    return z.to(x3.dtype), mean.reshape(n, num_groups), \
        rstd.reshape(n, num_groups)


def _per_channel(stat, c):
    """``(N, G)`` group statistics broadcast to ``(N, 1, C)``."""
    n, g = stat.shape
    return stat.reshape(n, 1, g, 1).expand(n, 1, g, c // g).reshape(n, 1, c)


def group_norm_bwd_reference(dy3, x3, weight, bias, mean, rstd,
                             num_groups: int, silu: bool = False):
    """Plain B-17: ``(dx, dγ, dβ)`` from the saved ``(N, G)`` statistics
    — ``dy' = dy·silu'(z)`` under SiLU, ``c1 = Σ_g w·dy' / cnt``, ``c2 =
    Σ_g w·dy'·x̂ / cnt``, ``dx = (w·dy' - c1 - x̂·c2)·rstd`` in
    ``x.dtype``; ``dγ = Σ dy'·x̂``, ``dβ = Σ dy'`` over the batch, fp32."""
    n, r, c = x3.shape
    w, b = _affine(c, weight, bias, x3.device)
    mu, rs = _per_channel(mean, c), _per_channel(rstd, c)
    xhat = (x3.float() - mu) * rs
    d = dy3.float()
    if silu:
        z = xhat * w + b
        s = torch.sigmoid(z)
        d = d * (s * (1.0 + z * (1.0 - s)))
    wdy = d * w
    inv = 1.0 / float(r * (c // num_groups))
    fold = (n, num_groups, c // num_groups)
    c1 = wdy.sum(1).reshape(fold).sum(-1) * inv
    c2 = (wdy * xhat).sum(1).reshape(fold).sum(-1) * inv
    dx = (wdy - _per_channel(c1, c) - xhat * _per_channel(c2, c)) * rs
    return dx.to(x3.dtype), (d * xhat).sum((0, 1)), d.sum((0, 1))


# --------------------------------------------------------------------- #
# the CUDA kernels
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(x3, num_groups, *others):
    """``(vec, chunks, map_chunks)`` of csrc/group_norm.cu's layout:
    16-byte vectors of channels when C and every pointer allow it, and
    enough row chunks per sample for the map pass to fill every SM; the
    statistics passes fill the SMs too, but take no more chunks than keep
    their fold within :data:`_FOLD_PER_LANE` merges a lane, unless a
    thread would then walk more than :data:`_MAX_THREAD_ROWS` rows."""
    n, rows, c = x3.shape
    vec = 16 // x3.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in (x3,) + others):
        vec = 1
    cv = c // vec
    tx = min(cv, 32)
    ty = _THREADS // tx
    tiles = -(-cv // tx)
    sms = _sm_count(x3.device.index or 0)
    steps = -(-rows // ty)

    def chunks(per_sm):
        want = -(-per_sm * sms // (tiles * n))
        return max(1, min(steps, want))
    fold = max(1, 32 * _FOLD_PER_LANE // (c // num_groups))
    reduce = max(-(-steps // _MAX_THREAD_ROWS),
                 min(chunks(_REDUCE_BLOCKS_PER_SM), fold))
    return vec, reduce, chunks(_MAP_BLOCKS_PER_SM)



class ClusterPlan(NamedTuple):
    """Geometry of a cluster-route launch: ``span`` channels (whole
    groups) a slab, ``cluster`` CTAs of :data:`CLUSTER_THREADS` a slab,
    ``clusters`` persistent clusters walking the slabs."""
    span: int
    cluster: int
    clusters: int


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _spans(c: int, cg: int, itemsize: int, backward: bool):
    """Spans of whole groups a slab may take, in the order tried: the
    fewest groups reaching :data:`SPAN_BYTES` of each row (or the widest
    where none does), then narrower ones, whose CTAs hold more rows.  A
    span is a power-of-two count of 16-byte vectors, at most a warp's 32
    (the kernels' shuffle trees) and :data:`MAX_BWD_SPAN` channels in the
    backward."""
    vec = 16 // itemsize
    top = min(c, MAX_SPAN_VECTORS * vec, MAX_BWD_SPAN if backward else c)
    spans = [s for s in range(cg, top + 1, cg)
             if c % s == 0 and _pow2(s // vec)]
    if not spans:
        return []
    first = next((s for s in spans
                  if s * itemsize >= SPAN_BYTES[backward]), spans[-1])
    return [first] + [s for s in reversed(spans) if s < first]


def rows_per_cta(span: int, itemsize: int, backward: bool) -> int:
    """Rows of a slab a cluster-route CTA holds: K vectors a thread times
    its row lanes (csrc/group_norm.cu ``row_lanes``: the largest power of
    two of rows ``span`` channels wide that fits the block, so a CTA's
    rows are whole TMA boxes)."""
    tx = span * itemsize // 16
    lanes = 1 << ((CLUSTER_THREADS // tx).bit_length() - 1)
    return THREAD_VECTORS[backward] * lanes


def cluster_plan(batch: int, rows: int, c: int, num_groups: int,
                 itemsize: int, backward: bool,
                 capacity) -> Optional[ClusterPlan]:
    """The route of one GroupNorm kernel call: a :class:`ClusterPlan`
    for the cluster route, or None for the three-pass route.

    The cluster route takes a sample's ``rows`` x ``span`` slab in one
    cluster of at most 16 CTAs of :func:`rows_per_cta` rows each, each
    thread holding 16-byte vectors of one group: a group's channels must
    be a power-of-two count of whole vectors (``C / G`` of ``16 /
    itemsize`` channels each).  ``capacity``: ``{cluster size: clusters
    the card runs at once}`` of the direction's kernel (0 or absent: that
    size does not fit).  Spans in the order of :func:`_spans`; for each,
    the smallest cluster that holds the slab."""
    vec = 16 // itemsize
    cg = c // num_groups
    if (rows <= 0 or batch <= 0 or c % num_groups or cg % vec
            or not _pow2(cg // vec)):
        return None
    for span in _spans(c, cg, itemsize, backward):
        per = rows_per_cta(span, itemsize, backward)
        slabs = batch * (c // span)
        for cl in CLUSTER_SIZES:
            if (capacity.get(cl, 0) > 0 and cl * per >= rows
                    and slabs * cl < 2 ** 31):
                return ClusterPlan(span, cl, min(slabs, capacity[cl]))
    return None


_CAPACITY = {}


def _capacity(dev, dtype, backward: bool):
    """``{cluster size: clusters at once}`` of a direction's cluster
    kernel on ``dev`` (asked of the card once per device,
    dtype and direction)."""
    key = (dev.index, dtype, backward)
    if key not in _CAPACITY:
        fn = _build.function("group_norm", "apex_gn_cluster_capacity",
                             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        out = (ctypes.c_int * len(CLUSTER_SIZES))()
        with torch.cuda.device(dev):
            code = fn(int(backward), _build.FLOAT_CODES[dtype],
                      ctypes.addressof(out))
        if code != 0:
            raise RuntimeError(f"group_norm: CUDA error {code} sizing its "
                               f"clusters")
        _CAPACITY[key] = dict(zip(CLUSTER_SIZES, list(out)))
    return _CAPACITY[key]


@functools.lru_cache(maxsize=256)
def _plan_cached(dev_index, dtype, backward, batch, rows, c, num_groups):
    dev = torch.device("cuda", dev_index)
    return cluster_plan(batch, rows, c, num_groups, dtype.itemsize,
                        backward, _capacity(dev, dtype, backward))


def _route(x3, num_groups, backward, *others):
    """The plan of a call on the card, or None (three-pass): the cluster
    route also needs every (N, R, C) operand 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in (x3,) + others):
        return None
    n, rows, c = x3.shape
    return _plan_cached(x3.device.index or 0, x3.dtype, backward, n, rows,
                        c, num_groups)


#: (device, stream) -> the backward's int32 tickets, one a span, zero
#: between calls (the kernel leaves them zero)
_TICKETS = {}


def _tickets(dev, spans):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < spans:
        t = torch.zeros(max(spans, 64), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def _check_kernel_operands(name, x3, num_groups, *same):
    if not x3.is_cuda:
        raise ValueError(f"{name}: needs a CUDA tensor, got one on "
                         f"{x3.device}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (N, R, C) tensor")
    if x3.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"{name}: unsupported dtype {x3.dtype}")
    if x3.shape[2] % num_groups:
        raise ValueError(f"{name}: channels {x3.shape[2]} not divisible by "
                         f"groups {num_groups}")
    for t in same:
        if (t.shape != x3.shape or t.dtype != x3.dtype
                or not t.is_contiguous() or t.device != x3.device):
            raise ValueError(
                f"{name}: every (N, R, C) operand must match x "
                f"{tuple(x3.shape)} {x3.dtype} and be contiguous, got "
                f"{tuple(t.shape)} {t.dtype}")


def _vecs(x3, *vs):
    """The (C,) affine as contiguous fp32 on x's device (ones / zeros
    for a missing weight / bias): cast once here, not per element."""
    c = x3.shape[2]
    for v in vs[:2]:
        if v is not None and (v.numel() != c or v.device != x3.device):
            raise ValueError(f"per-channel operand of {tuple(v.shape)} on "
                             f"{v.device} for C={c} on {x3.device}")
    w, b = _affine(c, *vs, x3.device)
    return w.reshape(c).contiguous(), b.reshape(c).contiguous()


def _stat_operand(s, n, num_groups, device):
    if s.shape != (n, num_groups) or s.device != device:
        raise ValueError(f"statistics must be ({n}, {num_groups}) on "
                         f"{device}, got {tuple(s.shape)} on {s.device}")
    return s.float().contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_I64, _I32, _F32, _PTR = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p)


def group_norm_fwd_kernel(x3, weight, bias, num_groups: int,
                          eps: float = 1e-5, silu: bool = False):
    """B-16 on a CUDA ``(N, R, C)`` tensor: ``(y, mean, rstd)`` as the
    plain version's, by the route :func:`cluster_plan` picks."""
    _check_kernel_operands("group_norm_fwd", x3, num_groups)
    n, rows, c = x3.shape
    w, b = _vecs(x3, weight, bias)
    y = torch.empty_like(x3)
    mean = torch.empty(n, num_groups, dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    xt = _build.FLOAT_CODES[x3.dtype]
    plan = _route(x3, num_groups, False, y)
    if plan is not None:
        fn = _build.function("group_norm", "apex_gn_fwd_cluster",
                             [_PTR] * 6 + [_I64] + [_I32] * 6 + [
                                 _F32, _I32, _I32, _PTR])
        code = fn(x3.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), n, rows, c, num_groups,
                  plan.span, plan.cluster, plan.clusters, float(eps),
                  int(silu), xt, _stream(x3))
        _build.check(code, "group_norm_fwd")
        return y, mean, rstd
    vec, chunks, map_chunks = _geometry(x3, num_groups, y)
    part = torch.empty(n, chunks, 2, c, dtype=torch.float32,
                       device=x3.device)
    fn = _build.function("group_norm", "apex_gn_fwd",
                         [_PTR] * 7 + [_I64, _I64, _I32, _I32, _I32, _I32,
                                       _I32, _F32, _I32, _I32, _PTR])
    code = fn(x3.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
              mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), n, rows, c,
              num_groups, vec, chunks, map_chunks, float(eps), int(silu),
              xt, _stream(x3))
    _build.check(code, "group_norm_fwd_3pass")
    return y, mean, rstd


def group_norm_bwd_kernel(dy3, x3, weight, bias, mean, rstd,
                          num_groups: int, silu: bool = False):
    """B-17: ``(dx, dγ, dβ)`` as the plain version's (dγ, dβ fp32), by
    the route :func:`cluster_plan` picks."""
    dy3 = dy3.to(x3.dtype).contiguous()
    _check_kernel_operands("group_norm_bwd", x3, num_groups, dy3)
    n, rows, c = x3.shape
    w, b = _vecs(x3, weight, bias)
    mean = _stat_operand(mean, n, num_groups, x3.device)
    rstd = _stat_operand(rstd, n, num_groups, x3.device)
    dx = torch.empty_like(x3)
    dw = torch.empty(c, dtype=torch.float32, device=x3.device)
    db = torch.empty_like(dw)
    inv = 1.0 / float(rows * (c // num_groups))
    xt = _build.FLOAT_CODES[x3.dtype]
    plan = _route(x3, num_groups, True, dy3, dx)
    if plan is not None:
        ws = torch.empty(n, c, 2, dtype=torch.float32, device=x3.device)
        tickets = _tickets(x3.device, c // plan.span)
        fn = _build.function("group_norm", "apex_gn_bwd_cluster",
                             [_PTR] * 11 + [_I64] + [_I32] * 6 + [
                                 _F32, _I32, _I32, _PTR])
        code = fn(dy3.data_ptr(), x3.data_ptr(), w.data_ptr(), b.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
                  tickets.data_ptr(), n, rows, c, num_groups, plan.span,
                  plan.cluster, plan.clusters, inv, int(silu), xt,
                  _stream(x3))
        _build.check(code, "group_norm_bwd")
        return dx, dw, db
    vec, chunks, map_chunks = _geometry(x3, num_groups, dy3, dx)
    part = torch.empty(n, chunks, 2, c, dtype=torch.float32,
                       device=x3.device)
    coef = torch.empty(n, num_groups, 2, dtype=torch.float32,
                       device=x3.device)
    fn = _build.function("group_norm", "apex_gn_bwd",
                         [_PTR] * 11 + [_I64, _I64, _I32, _I32, _I32, _I32,
                                        _I32, _F32, _I32, _I32, _PTR])
    code = fn(dy3.data_ptr(), x3.data_ptr(), w.data_ptr(), b.data_ptr(),
              mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
              coef.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
              n, rows, c, num_groups, vec, chunks, map_chunks, inv,
              int(silu), xt, _stream(x3))
    _build.check(code, "group_norm_bwd_3pass")
    return dx, dw, db


# --------------------------------------------------------------------- #
# the autograd core (``_gn_pallas`` with its custom_vjp)
# --------------------------------------------------------------------- #
class _GroupNormFn(torch.autograd.Function):
    """The forward kernel, saving the ``(N, G)`` statistics; the backward
    kernel from them, dγ and dβ cast to the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x3, weight, bias, num_groups, eps, silu):
        y, mean, rstd = group_norm_fwd_kernel(x3, weight, bias, num_groups,
                                              eps, silu)
        ctx.save_for_backward(x3, weight, bias, mean, rstd)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x3, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = group_norm_bwd_kernel(dy, x3, weight, bias, mean, rstd,
                                           ctx.num_groups, ctx.silu)
        dw = dw.to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = db.to(bias.dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def group_norm(x, num_groups: int, weight=None, bias=None, *,
               eps: float = 1e-5, act: Optional[str] = None,
               implementation: Optional[str] = None):
    """GroupNorm over an ``(N, ..., C)`` channels-last tensor, optional
    fused SiLU (``act``: None or ``"silu"``).

    Differentiable in ``x``, ``weight`` and ``bias`` (gradients of the
    parameters in their own dtypes).  ``implementation`` as in
    :mod:`._dispatch`: the kernels for a CUDA tensor, the reference
    composition for a CPU one.
    """
    c = x.shape[-1]
    _check(c, num_groups, act)
    kernel = resolve_impl(implementation, x) == "kernel"
    if not kernel:
        return group_norm_reference(x, num_groups, weight, bias, eps=eps,
                                    act=act)
    # a strided x (say x.permute(0, 2, 3, 1) of a contiguous NCHW tensor)
    # is copied first, and its gradient flows back through the copy; that
    # of a torch.channels_last NCHW tensor is already dense
    x3 = x.contiguous().view(x.shape[0], -1, c)
    y = _GroupNormFn.apply(x3, weight, bias, int(num_groups), float(eps),
                           act == "silu")
    return y.view(x.shape)


class GroupNorm(nn.Module):
    """Module form (``apex.contrib.group_norm.GroupNorm``, channels last):
    parameters ``scale`` (ones) and ``bias`` (zeros) of ``num_channels``
    in ``dtype``, as the JAX module's ``scale`` / ``bias``."""

    def __init__(self, num_groups: int, num_channels: int, *,
                 epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True, act: Optional[str] = None,
                 dtype=torch.float32, device=None,
                 implementation: Optional[str] = None):
        super().__init__()
        _check(num_channels, num_groups, act)
        dev = resolve_device(device)
        self.num_groups, self.num_channels = int(num_groups), int(num_channels)
        self.epsilon, self.act = float(epsilon), act
        self.implementation = implementation
        for name, init, use in (("scale", torch.ones, use_scale),
                                ("bias", torch.zeros, use_bias)):
            self.register_parameter(name, nn.Parameter(init(
                num_channels, dtype=dtype, device=dev)) if use else None)

    def forward(self, x):
        return group_norm(x, self.num_groups, self.scale, self.bias,
                          eps=self.epsilon, act=self.act,
                          implementation=self.implementation)
