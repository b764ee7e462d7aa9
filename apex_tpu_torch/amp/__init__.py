"""``amp`` frontend of the port (apex ``amp.initialize`` parity): the opt
levels O0–O3, O1's per-op casting (:mod:`~apex_tpu_torch.amp.o1`) and
its op lists (:mod:`~apex_tpu_torch.amp.lists`)."""

from apex_tpu_torch.amp import o1
from apex_tpu_torch.amp.frontend import (
    initialize,
    load_state_dict,
    master_params,
    scale_loss,
    state_dict,
)
from apex_tpu_torch.amp.lists import (
    FP32_FUNCS,
    HALF_FUNCS,
    PROMOTE_FUNCS,
    classify_op,
    deregister_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.core.precision import PrecisionPolicy

__all__ = ["initialize", "scale_loss", "master_params", "state_dict",
           "load_state_dict", "PrecisionPolicy", "HALF_FUNCS",
           "FP32_FUNCS", "PROMOTE_FUNCS", "classify_op",
           "register_half_function", "register_float_function",
           "register_promote_function", "deregister_function", "o1"]
