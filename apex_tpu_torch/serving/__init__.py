"""Continuous-batching serving over the dense KV cache.

The slotted engine (:mod:`~apex_tpu_torch.serving.engine`), its slot
pool (:mod:`~apex_tpu_torch.serving.cache`), the bounded FIFO scheduler
(:mod:`~apex_tpu_torch.serving.scheduler`) and the threaded front end
(:mod:`~apex_tpu_torch.serving.api`).  Greedy decoding through the
engine is token-identical to :func:`apex_tpu_torch.models.generate`.
"""

from apex_tpu_torch.serving.api import (
    InferenceServer,
    RequestFailed,
    RequestHandle,
    ServerClosed,
)
from apex_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    Engine,
    StepOutput,
    sample_dynamic,
)
from apex_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    Scheduler,
    StepEvent,
)

__all__ = [
    "InferenceServer", "RequestFailed", "RequestHandle", "ServerClosed",
    "DEFAULT_BUCKETS", "Engine", "StepOutput", "sample_dynamic",
    "QueueFull", "Request", "Scheduler", "StepEvent",
]
