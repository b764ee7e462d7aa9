"""FusedAdam — Adam / AdamW over lists of tensors, updated in place.

Counterpart of ``apex_tpu/optim/fused_adam.py``.  The train state hands
the optimizer one flat buffer of fp32 masters per dtype group, so each
line of the dense step is one launch over every parameter at once
(apex's multi-tensor apply).

- ``adam_w_mode=True`` (default): decoupled weight decay (AdamW);
  ``False``: L2 regularisation added to the gradient.
- ``bias_correction`` on by default; one shared step count.
- ``moment_dtype`` stores dense moments in another dtype (default: the
  params').
- :meth:`FusedAdam.step` updates params and moments in place; with a
  device-side ``finite`` flag it keeps the old values on a non-finite
  step (step-or-skip) without a host sync.

``moment_format="fp8_block_scaled"`` stores both moments as float8 e4m3
codes with one fp32 scale per 256-element block (``moment_dtype`` is
ignored), as the JAX package does.  The state is laid out **per leaf**
(one leaf per parameter) exactly as the JAX package's ``_fp8_pad``: each
leaf's moments are padded on their own to a whole number of 256-blocks,
or of 512 such blocks once the leaf holds 16384 elements or more, so no
block spans two parameters.  Inside a leaf the elements run in the JAX
package's order: a linear layer's weight, ``(out, in)`` here, is the
transpose of the JAX ``(in, out)`` kernel, and its moments are kept in
the kernel's order, so a JAX state carries across code for code
(:func:`adam_state_from_jax`).  Every leaf of a buffer lives in one
padded buffer of codes and one of scales, with a table of offsets, so
one launch of the CUDA kernel (``csrc/fp8_adam.cu``, replacing the
Pallas ``_fp8_adam_kernel``) covers every leaf; :func:`fp8_adam_reference`
is its plain version, with the arithmetic of the JAX package's XLA path
(dequantize, update, requantize).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch import _build

__all__ = ["fused_adam", "FusedAdam", "FusedAdamState", "Leaf",
           "Fp8Moment", "Fp8Layout", "fp8_adam_reference", "fp8_adam_kernel",
           "adam_state_from_jax"]

# the JAX package's constants (apex_tpu/optim/fused_adam.py:51-58)
_FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0          # e4m3 finite max
_FP8_BLOCK = 256
_FP8_KERNEL_ROWS = 512
_FP8_KERNEL_MIN = _FP8_BLOCK * 64


def _fp8_pad(n: int) -> int:
    """Quantized-state length for ``n`` elements: whole 256-blocks, or
    whole chunks of 512 blocks once ``n >= 16384`` (the JAX package's
    ``_fp8_pad``, so that a state carries across 1:1)."""
    n = max(1, n)
    if n < _FP8_KERNEL_MIN:
        return -(-n // _FP8_BLOCK) * _FP8_BLOCK
    chunk = _FP8_BLOCK * _FP8_KERNEL_ROWS
    return -(-n // chunk) * chunk


@dataclasses.dataclass
class Fp8Moment:
    """One moment in fp8: ``q`` float8_e4m3fn codes, ``scale`` one fp32
    per 256 codes (the JAX package's ``{"q", "scale"}`` leaf)."""
    q: torch.Tensor
    scale: torch.Tensor


def _fp8_quant(x_flat: torch.Tensor) -> Fp8Moment:
    """Plain block quantization of a flat fp32 tensor, zero-padded to
    ``_fp8_pad``: ``scale = max(absmax / 448, 1e-30)`` per block, codes
    ``e4m3(x / scale)`` rounded to nearest even."""
    n = x_flat.shape[0]
    return _fp8_quant_blocks(torch.nn.functional.pad(
        x_flat, (0, _fp8_pad(n) - n)))


def _fp8_quant_blocks(x: torch.Tensor) -> Fp8Moment:
    """:func:`_fp8_quant` of a length that is whole 256-blocks."""
    xb = x.view(-1, _FP8_BLOCK)
    absmax = xb.abs().amax(dim=1, keepdim=True)
    # divide by a tensor: CUDA torch turns a division by a Python scalar
    # into a multiply by its reciprocal, which is not the JAX package's
    # (nor the kernel's) correctly rounded quotient
    scale = torch.maximum(absmax / torch.full_like(absmax, _FP8_MAX),
                          torch.full_like(absmax, 1e-30))
    return Fp8Moment((xb / scale).to(_FP8).reshape(-1), scale[:, 0])


def _fp8_dequant(st: Fp8Moment, n: int) -> torch.Tensor:
    """The first ``n`` values of a quantized moment, in fp32."""
    q = st.q.view(-1, _FP8_BLOCK).float()
    return (q * st.scale[:, None]).reshape(-1)[:n]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter of a flat buffer: ``numel`` elements, and for a
    linear layer's weight its ``(rows, cols)`` shape — its moments then
    run in the transposed order of the JAX ``(in, out)`` kernel."""
    numel: int
    rows_cols: Optional[Tuple[int, int]] = None


class Fp8Layout:
    """Where each leaf of a flat buffer lives in the padded fp8 state.

    ``src[i]``: the leaf's first element in the flat buffer (leaves are
    back to back in buffer order); ``dst[i]``: its first code, a
    multiple of 256; ``total``: codes in all (``total / 256`` scales).
    """

    # an item of the kernel is 32 blocks: a tile of 256 rows x 32
    # columns of a transposed leaf, or a run of up to 32 of a leaf's
    # blocks in order
    TILE_R, TILE_C, ITEM_BLOCKS = 256, 32, 32

    def __init__(self, leaves: Sequence[Leaf]):
        self.leaves = tuple(leaves)
        self.src, self.dst = [], []
        s = d = 0
        for leaf in self.leaves:
            self.src.append(s)
            self.dst.append(d)
            s += leaf.numel
            d += _fp8_pad(leaf.numel)
        self.numel, self.total = s, d
        self._tables = {}
        self._maps = {}

    def zeros(self, device) -> Fp8Moment:
        return Fp8Moment(
            torch.zeros(self.total, dtype=_FP8, device=device),
            torch.zeros(self.total // _FP8_BLOCK, dtype=torch.float32,
                        device=device))

    def _jax_order(self, i: int, x: torch.Tensor) -> torch.Tensor:
        rc = self.leaves[i].rows_cols
        return x if rc is None else x.view(rc).t().reshape(-1)

    def gather(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` (buffer order) as fp32 in the padded JAX order, pads
        zero."""
        out = torch.zeros(self.total, dtype=torch.float32,
                          device=flat.device)
        for i, leaf in enumerate(self.leaves):
            seg = flat[self.src[i]:self.src[i] + leaf.numel].float()
            out[self.dst[i]:self.dst[i] + leaf.numel] = self._jax_order(
                i, seg)
        return out

    def scatter(self, padded: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`gather`: buffer order, pads dropped."""
        out = torch.empty(self.numel, dtype=padded.dtype,
                          device=padded.device)
        for i, leaf in enumerate(self.leaves):
            seg = padded[self.dst[i]:self.dst[i] + leaf.numel]
            rc = leaf.rows_cols
            if rc is not None:
                seg = seg.view(rc[1], rc[0]).t().reshape(-1)
            out[self.src[i]:self.src[i] + leaf.numel] = seg
        return out

    def table(self, device) -> Tuple[torch.Tensor, int]:
        """The kernel's leaf table on ``device`` and its item count.

        One int64 row of 8 per leaf: first item, kind (0: buffer order;
        1: transposed, in tiles; 2: transposed, element by element),
        numel, src, first block, padded blocks, rows, cols.  A
        transposed leaf takes tiles of 256 x 32 when rows % 256 == 0
        and cols % 32 == 0, then items of up to 32 blocks for its padded
        blocks beyond numel; any other leaf takes items of up to 32
        blocks."""
        key = str(device)
        if key not in self._tables:
            rows, start = [], 0
            for i, leaf in enumerate(self.leaves):
                nblk = _fp8_pad(leaf.numel) // _FP8_BLOCK
                r, c = leaf.rows_cols or (0, 0)
                tiled = (leaf.rows_cols is not None
                         and r % self.TILE_R == 0 and c % self.TILE_C == 0)
                kind = 0 if leaf.rows_cols is None else (1 if tiled else 2)
                tiles = (r // self.TILE_R) * (c // self.TILE_C) if tiled else 0
                rest = nblk - (leaf.numel // _FP8_BLOCK if tiled else 0)
                rows.append([start, kind, leaf.numel, self.src[i],
                             self.dst[i] // _FP8_BLOCK, nblk, r, c])
                start += tiles + -(-rest // self.ITEM_BLOCKS)
            t = torch.tensor(np.asarray(rows, np.int64).reshape(-1, 8),
                             device=device)
            self._tables[key] = (t, start)
        return self._tables[key]


@dataclasses.dataclass
class FusedAdamState:
    count: torch.Tensor          # shared step count, int32 scalar
    exp_avg: List[Any]           # per buffer: a tensor, or an Fp8Moment
    exp_avg_sq: List[Any]
    layouts: Optional[List[Fp8Layout]] = None   # fp8: per buffer


def _select_(finite, new, old) -> None:
    """``old = finite ? new : old`` in place, without a host sync; fp8
    codes are selected as bytes."""
    if old.dtype == _FP8:
        new, old = new.view(torch.uint8), old.view(torch.uint8)
    torch.where(finite, new.to(old.dtype), old, out=old)


def fp8_adam_reference(g, p, m: Fp8Moment, v: Fp8Moment,
                       layout: Fp8Layout, sc: torch.Tensor,
                       finite: Optional[torch.Tensor], *, b1: float,
                       b2: float, eps: float, weight_decay: float,
                       adam_w_mode: bool) -> None:
    """Plain fp8 Adam step over one flat buffer, in place on ``p``,
    ``m`` and ``v``: the JAX package's XLA path (``fused_adam.py:
    283-307``) on every leaf — dequantize, update in fp32, requantize
    each 256-block; ``p += (-lr * step)`` in ``p``'s dtype.  ``sc``:
    fp32 ``[lr, bc1, bc2]`` on the device; ``finite``: a device bool or
    None.  Pads have g = p = 0 and stay 0."""
    lr, bc1, bc2 = sc[0], sc[1], sc[2]
    gf, pf = layout.gather(g), layout.gather(p)
    mf = _fp8_dequant(m, layout.total)
    vf = _fp8_dequant(v, layout.total)
    wd = weight_decay
    if not adam_w_mode and wd != 0.0:
        gf = gf + wd * pf
    m_new = b1 * mf + (1.0 - b1) * gf
    v_new = b2 * vf + (1.0 - b2) * gf.square()
    # the root in float64, rounded once to fp32: the correctly rounded
    # fp32 root of the JAX package and the kernel (torch's fp32 sqrt on
    # the CPU is not correctly rounded)
    root = (v_new / bc2).double().sqrt().float()
    step = m_new / (bc1 * (root + eps))
    if adam_w_mode and wd != 0.0:
        step = step + wd * pf
    upd = layout.scatter(-lr * step)
    p_new = p + upd.to(p.dtype)
    mq = _fp8_quant_blocks(m_new)
    vq = _fp8_quant_blocks(v_new)
    new = ((p, p_new), (m.q, mq.q), (m.scale, mq.scale), (v.q, vq.q),
           (v.scale, vq.scale))
    for old, nw in new:
        if finite is None:
            old.copy_(nw)
        else:
            _select_(finite, nw, old)


def fp8_adam_kernel(g, p, m: Fp8Moment, v: Fp8Moment, layout: Fp8Layout,
                    sc: torch.Tensor, finite: Optional[torch.Tensor], *,
                    b1: float, b2: float, eps: float, weight_decay: float,
                    adam_w_mode: bool) -> None:
    """The CUDA kernel (``csrc/fp8_adam.cu``) on one flat buffer: the
    same step as :func:`fp8_adam_reference`, one launch over every
    leaf; on a non-finite step it writes nothing."""
    if p.dtype not in _build.FLOAT_CODES:
        raise TypeError(f"unsupported parameter dtype {p.dtype}")
    dev = p.device
    for name, t in (("g", g), ("p", p), ("m.q", m.q), ("m.scale", m.scale),
                    ("v.q", v.q), ("v.scale", v.scale), ("sc", sc)):
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if g.dtype != p.dtype or g.numel() != layout.numel \
            or p.numel() != layout.numel:
        raise ValueError(
            f"g {g.dtype} {g.numel()} and p {p.dtype} {p.numel()} must "
            f"share the dtype and hold the layout's {layout.numel}")
    if m.q.dtype != _FP8 or m.q.numel() != layout.total \
            or m.scale.numel() != layout.total // _FP8_BLOCK:
        raise ValueError("moments do not match the layout")
    if sc.dtype != torch.float32 or sc.numel() != 3:
        raise ValueError("sc must be fp32 [lr, bc1, bc2]")
    if finite is not None and (finite.dtype != torch.bool
                               or finite.device != dev):
        raise ValueError(f"finite must be a bool on {dev}")
    table, items = layout.table(dev)
    if items == 0:
        return
    # the copy engines move fp32 g and p from 16-byte-aligned addresses;
    # a transposed leaf's tiles come by TMA through its tensor maps
    async_ok = (p.dtype == torch.float32 and g.data_ptr() % 16 == 0
                and p.data_ptr() % 16 == 0)
    maps = _fp8_maps(layout, g, p, m.q, v.q) if async_ok else None
    fn = _build.function("fp8_adam", "apex_fp8_adam", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = fn(g.data_ptr(), p.data_ptr(), m.q.data_ptr(),
              m.scale.data_ptr(), v.q.data_ptr(), v.scale.data_ptr(),
              table.data_ptr(), len(layout.leaves), items,
              None if maps is None else maps.data_ptr(), int(async_ok),
              sc.data_ptr(), None if finite is None else finite.data_ptr(),
              b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
              int(adam_w_mode), _build.DTYPE_CODES[p.dtype],
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fp8_adam")


def _fp8_maps(layout: Fp8Layout, g, p, mq, vq):
    """The kernel's TMA tensor maps of ``g``, ``p`` and the two moments'
    codes (four 128-byte maps a leaf, for its tiles), on the device;
    built on the host once per set of buffers (the train state keeps its
    buffers) and kept on the layout."""
    key = (g.data_ptr(), p.data_ptr(), mq.data_ptr(), vq.data_ptr(),
           str(p.device))
    maps = layout._maps.get(key)
    if maps is None:
        table, _ = layout.table("cpu")
        host = np.zeros(512 * len(layout.leaves), dtype=np.uint8)
        fn = _build.function("fp8_adam", "apex_fp8_adam_maps", [
            ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
        code = fn(g.data_ptr(), p.data_ptr(), mq.data_ptr(), vq.data_ptr(),
                  table.data_ptr(), len(layout.leaves), host.ctypes.data)
        if code != 0:
            raise RuntimeError(f"fp8_adam: tensor maps: CUDA error {code}")
        maps = torch.from_numpy(host).to(p.device)
        layout._maps = {key: maps}
    return maps


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    learning_rate: Union[float, Callable[[torch.Tensor], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    moment_dtype: Optional[Any] = None
    moment_format: str = "dense"

    @property
    def per_leaf(self) -> bool:
        """Whether :meth:`init` needs the buffers' leaves (fp8)."""
        return self.moment_format == "fp8_block_scaled"

    def init(self, params: List[torch.Tensor],
             leaves: Optional[List[Sequence[Leaf]]] = None
             ) -> FusedAdamState:
        """Zero moments beside ``params`` and a zero step count.

        fp8: ``leaves[i]`` lists the parameters of buffer ``params[i]``
        in order (default: the buffer is one leaf)."""
        device = params[0].device if params else None
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.per_leaf:
            if leaves is None:
                leaves = [[Leaf(p.numel())] for p in params]
            layouts = [Fp8Layout(ls) for ls in leaves]
            for p, lay in zip(params, layouts):
                if lay.numel != p.numel():
                    raise ValueError(
                        f"leaves hold {lay.numel} elements, the buffer "
                        f"{p.numel()}")
            return FusedAdamState(
                count, [lay.zeros(p.device) for p, lay in zip(params,
                                                               layouts)],
                [lay.zeros(p.device) for p, lay in zip(params, layouts)],
                layouts)

        def zeros(p):
            return torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
        return FusedAdamState(count, [zeros(p) for p in params],
                              [zeros(p) for p in params])

    def _scalars(self, count):
        """fp32 ``[lr, bc1, bc2]`` on the count's device, no host sync."""
        lr = self.learning_rate
        if callable(lr):
            lr = lr(count)
        c = count.float()
        if self.bias_correction:
            bc1 = 1.0 - torch.pow(self.b1, c)
            bc2 = 1.0 - torch.pow(self.b2, c)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=c.device)
        if not torch.is_tensor(lr):
            lr = torch.full((), lr, dtype=torch.float32, device=c.device)
        return torch.stack([lr.to(torch.float32).reshape(()), bc1, bc2])

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: FusedAdamState,
             params: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None,
             implementation: Optional[str] = None) -> None:
        """One Adam step in place on ``params`` and ``state``; with
        ``finite`` (a device bool) a non-finite step leaves every
        tensor as it was (the select of the JAX train state).  fp8
        moments take the kernel for CUDA buffers and the plain version
        for CPU ones (``implementation`` as in :mod:`..ops._dispatch`)."""
        count = state.count + 1
        sc = self._scalars(count)
        lr, bc1, bc2 = sc[0], sc[1], sc[2]
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        if state.layouts is not None:
            from apex_tpu_torch.ops._dispatch import resolve_impl
            for g, p, m, v, lay in zip(grads, params, state.exp_avg,
                                       state.exp_avg_sq, state.layouts):
                kernel = resolve_impl(implementation, p) == "kernel"
                run = fp8_adam_kernel if kernel else fp8_adam_reference
                run(g.to(p.dtype).contiguous(), p, m, v, lay, sc, finite,
                    b1=b1, b2=b2, eps=self.eps, weight_decay=wd,
                    adam_w_mode=self.adam_w_mode)
        else:
            for g, p, m, v in zip(grads, params, state.exp_avg,
                                  state.exp_avg_sq):
                gf = g.to(m.dtype)
                pf = p.to(m.dtype)
                if not self.adam_w_mode and wd != 0.0:
                    gf = gf + wd * pf
                m_new = b1 * m + (1.0 - b1) * gf
                v_new = b2 * v + (1.0 - b2) * gf.square()
                upd = m_new / (bc1 * ((v_new / bc2).sqrt() + self.eps))
                if self.adam_w_mode and wd != 0.0:
                    upd = upd + wd * pf
                p_new = p + (-lr * upd).to(p.dtype)
                for old, new in ((p, p_new), (m, m_new), (v, v_new)):
                    if finite is None:
                        old.copy_(new)
                    else:
                        _select_(finite, new, old)
        state.count = count if finite is None else torch.where(
            finite, count, state.count)


def fused_adam(learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True,
               moment_dtype: Optional[Any] = None,
               moment_format: str = "dense") -> FusedAdam:
    """Build the FusedAdam optimizer (the JAX package's signature);
    ``moment_dtype`` is ignored under ``"fp8_block_scaled"``."""
    if moment_format not in ("dense", "fp8_block_scaled"):
        raise ValueError(
            f"moment_format={moment_format!r} not in "
            "('dense', 'fp8_block_scaled')")
    if moment_format == "fp8_block_scaled":
        moment_dtype = None
    return FusedAdam(learning_rate, b1, b2, eps, weight_decay, adam_w_mode,
                     bias_correction, moment_dtype, moment_format)


def _fp8_from_numpy(leaf: Mapping, device) -> Fp8Moment:
    q = np.ascontiguousarray(leaf["q"]).view(np.uint8)
    return Fp8Moment(torch.from_numpy(q.copy()).view(_FP8).to(device),
                     torch.from_numpy(np.asarray(leaf["scale"],
                                                 np.float32)).to(device))


def adam_state_from_jax(opt: FusedAdam, count, exp_avg: Mapping[str, Any],
                        exp_avg_sq: Mapping[str, Any],
                        buffers: Sequence[Sequence[Tuple[str, Leaf]]],
                        params: Sequence[torch.Tensor]) -> FusedAdamState:
    """The port's state from a JAX ``FusedAdamState`` taken with the
    same ``moment_format``.

    ``exp_avg`` / ``exp_avg_sq``: the JAX leaves as numpy, keyed by the
    port's parameter names (``models.named_leaves_from_jax``): arrays in
    the JAX shapes (dense), or ``{"q", "scale"}`` (fp8: codes copied
    1:1 into the leaf's slot).  ``buffers[i]``: the ``(name, Leaf)``
    pairs of flat buffer ``params[i]`` in order (the train state's
    :meth:`~apex_tpu_torch.core.MixedPrecisionTrainState.leaves`)."""
    state = opt.init(list(params), [[lf for _, lf in b] for b in buffers])
    names = {n for b in buffers for n, _ in b}
    for src in (exp_avg, exp_avg_sq):
        if set(src) != names:
            raise ValueError(
                f"JAX moments for {sorted(set(src) ^ names)} do not match "
                "the parameters")
    for i, (buf, p) in enumerate(zip(buffers, params)):
        for dst_list, src in ((state.exp_avg, exp_avg),
                              (state.exp_avg_sq, exp_avg_sq)):
            dst = dst_list[i]
            if state.layouts is None:
                off = 0
                for name, leaf in buf:
                    a = np.asarray(src[name], np.float32)
                    if leaf.rows_cols is not None:
                        a = a.T
                    if a.size != leaf.numel:
                        raise ValueError(f"{name}: {a.size} elements, "
                                         f"want {leaf.numel}")
                    dst[off:off + leaf.numel] = torch.from_numpy(
                        np.ascontiguousarray(a).reshape(-1)).to(dst)
                    off += leaf.numel
                continue
            lay = state.layouts[i]
            for j, (name, leaf) in enumerate(buf):
                st = _fp8_from_numpy(src[name], p.device)
                npad = _fp8_pad(leaf.numel)
                if st.q.numel() != npad:
                    raise ValueError(f"{name}: {st.q.numel()} codes, want "
                                     f"{npad}")
                d = lay.dst[j]
                dst.q[d:d + npad] = st.q
                dst.scale[d // _FP8_BLOCK:(d + npad) // _FP8_BLOCK] = st.scale
    state.count = torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                               device=state.count.device)
    return state
