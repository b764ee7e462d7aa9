"""Optimizers of the port."""

from apex_tpu_torch.optim.fused_adam import FusedAdam, FusedAdamState, fused_adam
from apex_tpu_torch.optim.fused_sgd import FusedSGD, FusedSgdState, fused_sgd

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam", "FusedSGD",
           "FusedSgdState", "fused_sgd"]
