"""Optimizers of the port."""

from apex_tpu_torch.optim.fused_adam import FusedAdam, FusedAdamState, fused_adam

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]
