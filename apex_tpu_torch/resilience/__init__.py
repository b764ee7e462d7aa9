"""Fault injection for the serving path."""

from apex_tpu_torch.resilience import faults

__all__ = ["faults"]
