"""Optimizers of the port, each ``init(params)`` / ``step(grads, state,
params, finite)`` in place over the train state's flat buffers
(``per_leaf`` ones also take each buffer's parameters at ``init``), and
the multi-tensor and clipping helpers.  The reference's class names are
aliases of the factory functions, as in ``apex_tpu/optim/__init__.py``."""

from apex_tpu_torch.optim._multi_tensor import (
    global_grad_clip_coef,
    per_tensor_l2_norms,
    tree_axpby,
    tree_l2_norm,
    tree_scale,
)
from apex_tpu_torch.optim.clip import clip_by_global_norm, clip_grad_norm
from apex_tpu_torch.optim.fused_adagrad import FusedAdagradState, fused_adagrad
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
from apex_tpu_torch.optim.fused_lamb import FusedLambState, fused_lamb
from apex_tpu_torch.optim.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLambState,
    fused_mixed_precision_lamb,
)
from apex_tpu_torch.optim.fused_novograd import (
    FusedNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optim.fused_sgd import FusedSGD, FusedSgdState, fused_sgd
from apex_tpu_torch.optim.larc import larc

# the reference's class names, onto the factory functions (apex_tpu/optim/
# __init__.py:34-40); FusedAdam and FusedSGD stay the port's classes,
# which take the factory functions' arguments in order
FusedLAMB = fused_lamb
FusedNovoGrad = fused_novograd
FusedAdagrad = fused_adagrad
LARC = larc
FusedMixedPrecisionLamb = fused_mixed_precision_lamb

__all__ = ["FusedAdam", "FusedAdamState", "Fp8Layout", "Fp8Moment", "Leaf",
           "adam_state_from_jax", "fp8_adam_kernel", "fp8_adam_reference",
           "fused_adam", "FusedSGD", "FusedSgdState", "fused_sgd",
           "fused_lamb", "FusedLambState", "FusedLAMB",
           "fused_novograd", "FusedNovoGradState", "FusedNovoGrad",
           "fused_adagrad", "FusedAdagradState", "FusedAdagrad",
           "larc", "LARC",
           "fused_mixed_precision_lamb", "FusedMixedPrecisionLambState",
           "FusedMixedPrecisionLamb",
           "clip_grad_norm", "clip_by_global_norm",
           "tree_l2_norm", "per_tensor_l2_norms", "tree_scale", "tree_axpby",
           "global_grad_clip_coef"]
