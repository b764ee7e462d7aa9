"""Activation resolver shared by the MLP blocks.

Counterpart of ``resolve_activation`` in ``apex_tpu/ops/mlp.py``.  The
dense products around it are plain ``torch.nn.functional.linear`` calls
(``apex_tpu_torch.transformer.layers``), as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = ["resolve_activation"]


def resolve_activation(name: str, *, gelu_approximate: bool = False):
    """The activation function called ``name``.  Unknown names
    (including ``None``) raise: an unset activation silently becoming
    the identity would degrade a model with no error."""
    if name == "gelu":
        return functools.partial(
            F.gelu, approximate="tanh" if gelu_approximate else "none")
    if name == "relu":
        return F.relu
    if name == "silu":
        return F.silu
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(f"unknown activation {name!r}")
