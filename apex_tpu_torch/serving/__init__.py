"""Continuous-batching serving over the dense KV cache or the paged pool.

The slotted and paged engines (:mod:`~apex_tpu_torch.serving.engine`),
the slot pool and the page allocator, digests and prefix trie
(:mod:`~apex_tpu_torch.serving.cache`), the bounded FIFO scheduler
(:mod:`~apex_tpu_torch.serving.scheduler`) and the threaded front end
(:mod:`~apex_tpu_torch.serving.api`).  Greedy decoding through the
engine is token-identical to :func:`apex_tpu_torch.models.generate`.
A paged engine or server spans ``tp`` tensor ranks with ``mesh=`` /
``tp=`` (:func:`tp_mesh`).
"""

from apex_tpu_torch.serving.api import (
    InferenceServer,
    RequestFailed,
    RequestHandle,
    ServerClosed,
)
from apex_tpu_torch.serving.cache import (
    BlockAllocator,
    BlockExhausted,
    PrefixTrie,
    chain_digests,
)
from apex_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    Engine,
    PagedEngine,
    StepOutput,
    prompt_lookup_draft,
    sample_dynamic,
    tp_mesh,
)
from apex_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    Scheduler,
    StepEvent,
)

__all__ = [
    "InferenceServer", "RequestFailed", "RequestHandle", "ServerClosed",
    "BlockAllocator", "BlockExhausted", "PrefixTrie", "chain_digests",
    "DEFAULT_BUCKETS", "Engine", "PagedEngine", "StepOutput",
    "prompt_lookup_draft", "sample_dynamic", "tp_mesh",
    "QueueFull", "Request", "Scheduler", "StepEvent",
]
