"""``amp`` frontend of the port (apex ``amp.initialize`` parity)."""

from apex_tpu_torch.amp.frontend import (
    initialize,
    load_state_dict,
    master_params,
    scale_loss,
    state_dict,
)
from apex_tpu_torch.core.precision import PrecisionPolicy

__all__ = ["initialize", "scale_loss", "master_params", "state_dict",
           "load_state_dict", "PrecisionPolicy"]
