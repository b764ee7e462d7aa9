"""amp core of the port: precision policy, loss scaling, train state."""

from apex_tpu_torch.core.loss_scale import (
    DynamicLossScale,
    LossScaleState,
    NoOpLossScale,
    StaticLossScale,
    all_finite,
)
from apex_tpu_torch.core.precision import (
    PrecisionPolicy,
    cast_floating,
    norm_param_filter,
    tree_cast,
)
from apex_tpu_torch.core.train_state import (
    MixedPrecisionTrainState,
    parameter_leaves,
)

__all__ = [
    "DynamicLossScale", "LossScaleState", "NoOpLossScale",
    "StaticLossScale", "all_finite", "PrecisionPolicy", "cast_floating",
    "norm_param_filter", "tree_cast", "MixedPrecisionTrainState",
    "parameter_leaves",
]
