"""Utilities of the port."""

from apex_tpu_torch.utils.metrics import (
    Counters,
    MetricsWriter,
    counters,
    percentile_summary,
)

__all__ = ["Counters", "MetricsWriter", "counters", "percentile_summary"]
