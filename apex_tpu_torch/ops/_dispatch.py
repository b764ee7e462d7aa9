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

There is no environment override: a CUDA tensor reaches the plain path
only when the caller asks for it by name.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_impl", "resolve_device"]

_VALID = ("auto", "kernel", "torch")


def resolve_impl(implementation: Optional[str], x: torch.Tensor) -> str:
    """Resolve ``implementation`` for an op whose main input is ``x``:
    returns ``"kernel"`` or ``"torch"``."""
    impl = implementation or "auto"
    if impl not in _VALID:
        raise ValueError(f"implementation={impl!r} not in {_VALID}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "torch"
    if impl == "kernel" and not x.is_cuda:
        raise ValueError(
            f"implementation='kernel' needs a CUDA tensor, got one on "
            f"{x.device}")
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
