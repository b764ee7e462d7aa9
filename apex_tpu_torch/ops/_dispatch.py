"""Implementation and device dispatch for the port's ops.

Counterpart of ``apex_tpu/ops/_dispatch.py``.  Each op with a kernel
ships (a) a CUDA kernel written by hand for Hopper and (b) a plain
PyTorch composition with the same semantics — the reference the kernel
is tested against and the path for tensors on the CPU.

``implementation=`` accepted values:

- ``"auto"``   — the kernel for a CUDA tensor, the plain composition for
  a CPU tensor (the default);
- ``"kernel"`` — the CUDA kernel; raises for a tensor that is not on a
  CUDA device;
- ``"torch"``  — the plain composition on any device.

There is no environment override.  A CUDA tensor reaches the plain path
when the caller asks for it by name, or under ``"auto"`` when the op's
shapes lie outside its kernels' envelope: the shapes that the JAX
package's ``"auto"`` also sends to its XLA composition (its
``pallas_ok``) and that no kernel of the port takes.  Each op tests them
with one named predicate (``flash_kernel_ok``, ``paged_kernel_ok``),
and the route is logged once per shape, as the JAX package logs it.  It
is a check of shapes made before any launch: no build or launch error is
ever caught.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

__all__ = ["resolve_impl", "resolve_device"]

_VALID = ("auto", "kernel", "torch")
_logger = logging.getLogger("apex_tpu_torch.ops")
#: (op, shape) pairs whose route to the plain path has been logged
_ROUTED = set()


def resolve_impl(implementation: Optional[str], x: torch.Tensor, *,
                 inside: bool = True, op: str = "",
                 shape=None, why: str = "") -> str:
    """Resolve ``implementation`` for an op whose main input is ``x``:
    returns ``"kernel"`` or ``"torch"``.

    ``inside=False`` says the op's shapes are outside its kernels'
    envelope (its predicate): ``"auto"`` then resolves to ``"torch"`` on
    a CUDA tensor too, logging ``"<op>: falling back to the plain
    composition (<why>); <shape>"`` once per ``(op, shape)``, and
    ``"kernel"`` raises."""
    impl = implementation or "auto"
    if impl not in _VALID:
        raise ValueError(f"implementation={impl!r} not in {_VALID}")
    if impl == "auto":
        if not x.is_cuda:
            return "torch"
        if not inside:
            key = (op, shape, why)
            if key not in _ROUTED:
                _ROUTED.add(key)
                _logger.info("%s: falling back to the plain composition "
                             "(%s); %s", op, why, shape)
            return "torch"
        return "kernel"
    if impl == "kernel":
        if not x.is_cuda:
            raise ValueError(
                f"implementation='kernel' needs a CUDA tensor, got one on "
                f"{x.device}")
        if not inside:
            raise ValueError(f"{op}: no kernel takes {shape} ({why})")
    return impl


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises when the device is a CUDA one and CUDA is not
    available — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
