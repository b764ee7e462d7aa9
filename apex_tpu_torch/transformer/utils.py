"""Small shared helpers (``apex_tpu/transformer/utils.py``; reference
``apex/transformer/utils.py``)."""

from __future__ import annotations

from typing import Tuple

__all__ = ["divide", "ensure_divisibility", "split_tensor_along_last_dim"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(
            f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x, num_partitions: int) -> Tuple:
    """Split the last dim into equal chunks (views)."""
    last = divide(x.shape[-1], num_partitions)
    return tuple(
        x[..., i * last:(i + 1) * last] for i in range(num_partitions))
