"""Optimizers of the port."""

from apex_tpu_torch.optim.fused_adam import (
    FusedAdam,
    FusedAdamState,
    Fp8Layout,
    Fp8Moment,
    Leaf,
    adam_state_from_jax,
    fp8_adam_kernel,
    fp8_adam_reference,
    fused_adam,
)
from apex_tpu_torch.optim.fused_sgd import FusedSGD, FusedSgdState, fused_sgd

__all__ = ["FusedAdam", "FusedAdamState", "Fp8Layout", "Fp8Moment", "Leaf",
           "adam_state_from_jax", "fp8_adam_kernel", "fp8_adam_reference",
           "fused_adam", "FusedSGD", "FusedSgdState", "fused_sgd"]
