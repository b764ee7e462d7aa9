"""Continuous batching: bounded FIFO queue + slot-level admission.

Counterpart of ``apex_tpu/serving/scheduler.py``.  At every step
boundary the scheduler (1) refills free slots from the queue in FIFO
order — gated on the engine's ``can_admit`` (the paged engine's free
pages) — then (2) runs one engine step and routes each produced token
to its request, evicting tenants that finished (eos or budget).  A paged
engine's :class:`~apex_tpu_torch.serving.engine.StepOutput` may carry
several tokens per slot (speculative decoding) and slots it preempted,
which are requeued at the front.
A long generation and a short one share the batch, and the short one's
slot is reused the step after it finishes.

Thread-safety: ``submit`` may be called from any thread (the queue has
its own lock); ``run_step`` must be called from the single thread that
owns the engine (the :class:`~apex_tpu_torch.serving.api.
InferenceServer` worker).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving.engine import StepOutput
from apex_tpu_torch.utils.metrics import counters

__all__ = ["Request", "Scheduler", "QueueFull", "StepEvent"]


class QueueFull(RuntimeError):
    """The bounded request queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One generation request (host object).

    ``top_k=None``/``0`` disables truncation, ``top_p=None``/``1.0``
    disables the nucleus filter, ``eos_id=None`` disables eos stopping,
    ``seed`` derives the request's own sampling key.  ``deadline`` is in
    seconds from acceptance (``None`` = unbounded).  ``retries`` and
    ``accepted_at`` are serving-loop bookkeeping.
    """

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    deadline: Optional[float] = None
    uid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    # the accepted prompt and budget, for fault-recovery requeues
    prompt0: Optional[np.ndarray] = None
    budget0: int = 0
    retries: int = 0
    accepted_at: float = -1.0


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One token routed to one request at a step boundary."""

    request: Request
    token: int
    finished: bool


class Scheduler:
    """Bounded-queue continuous batcher over one
    :class:`~apex_tpu_torch.serving.engine.Engine`."""

    def __init__(self, engine, *, queue_capacity: int = 64):
        if queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}")
        self.engine = engine
        self.queue_capacity = int(queue_capacity)
        self._queue: Deque[Request] = deque()
        self._lock = threading.Lock()
        self._uid = itertools.count()
        # host shadow of slot occupancy: item writes by the worker only
        self._slots: List[Optional[Request]] = [None] * engine.max_slots
        self._admit_failures: List[Tuple[Request, BaseException]] = []
        #: tenants the engine preempted for pages (requeued, no retry spent)
        self.preempts = 0

    # ------------------------------------------------------------ intake
    def submit(self, request: Request) -> Request:
        """Enqueue (FIFO); raises :class:`QueueFull` at capacity and
        ``ValueError`` for a request the engine can never admit."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        self.engine.validate_request(
            prompt.shape[0], request.max_new_tokens,
            request.temperature, request.top_k, request.top_p)
        request.prompt = prompt
        # originals, for fault-recovery requeues
        request.prompt0 = prompt
        request.budget0 = int(request.max_new_tokens)
        with self._lock:
            if len(self._queue) >= self.queue_capacity:
                raise QueueFull(
                    f"request queue at capacity "
                    f"({self.queue_capacity}); retry after a drain")
            request.uid = next(self._uid)
            request.accepted_at = time.monotonic()
            self._queue.append(request)
        return request

    def requeue(self, request: Request) -> None:
        """Put an accepted request back at the queue's front; its next
        admission prefills ``original prompt ++ tokens so far`` with the
        remaining budget.  ``ValueError`` if the continuation no longer
        fits (the caller fails the request)."""
        prompt = np.asarray(request.prompt0, np.int32)
        if request.tokens:
            prompt = np.concatenate(
                [prompt, np.asarray(request.tokens, np.int32)])
        budget = int(request.budget0) - len(request.tokens)
        self.engine.validate_request(
            prompt.shape[0], budget, request.temperature,
            request.top_k, request.top_p)
        request.prompt = prompt
        request.max_new_tokens = budget
        with self._lock:
            self._queue.appendleft(request)

    def expire_queued(self, now: Optional[float] = None) -> List[Request]:
        """Remove and return queued requests past their deadline."""
        now = time.monotonic() if now is None else now
        expired: List[Request] = []
        with self._lock:
            keep: Deque[Request] = deque()
            for req in self._queue:
                if req.deadline is not None \
                        and now - req.accepted_at > req.deadline:
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        return expired

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def occupancy(self) -> float:
        return self.active_count / self.engine.max_slots

    def has_work(self) -> bool:
        return self.active_count > 0 or self.queue_depth > 0

    # ------------------------------------------------------------- steps
    def _admit_from_queue(self) -> int:
        """Fill free slots FIFO; returns the number admitted.  The queue
        head must also pass the engine's token gate (``can_admit``); a
        head that does not blocks the queue rather than being overtaken
        (counter ``serving.admit_blocked``).  A
        :class:`~apex_tpu_torch.resilience.faults.TransientError` during
        one admission is retried from the queue's front once, then
        recorded on :meth:`take_admit_failures`."""
        admitted = 0
        for slot, occupant in enumerate(self._slots):
            if occupant is not None:
                continue
            with self._lock:
                if not self._queue:
                    break
                head = self._queue[0]
                if not self.engine.can_admit(head.prompt.shape[0],
                                             head.max_new_tokens,
                                             prompt=head.prompt):
                    counters.inc("serving.admit_blocked")
                    break
                req = self._queue.popleft()
            try:
                faults.inject("serving.admit")
                self.engine.admit(
                    slot, req.prompt, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k or 0,
                    top_p=req.top_p, eos_id=req.eos_id, seed=req.seed)
            except faults.TransientError as exc:
                counters.inc("serving.admit_fault")
                if req.retries < 1:
                    req.retries += 1
                    with self._lock:
                        self._queue.appendleft(req)
                else:
                    self._admit_failures.append((req, exc))
                break
            self._slots[slot] = req
            admitted += 1
        return admitted

    def take_admit_failures(self) -> List[Tuple[Request, BaseException]]:
        """Drain requests whose admission failed terminally."""
        failed, self._admit_failures = self._admit_failures, []
        return failed

    def evict(self, slot: int) -> Optional[Request]:
        """Release ``slot`` and return its tenant (engine thread only)."""
        req = self._slots[slot]
        if req is None:
            return None
        self.engine.release(slot)
        self._slots[slot] = None
        return req

    def run_step(self) -> List[StepEvent]:
        """One step boundary: admit → decode → route/evict.  Returns the
        tokens produced this step (empty when idle)."""
        self._admit_from_queue()
        if self.active_count == 0:
            return []
        out = self.engine.step()
        if isinstance(out, StepOutput):
            tokens, finished, _emitted, preempted, counts = out
        else:
            (tokens, finished), counts, preempted = out, None, ()
        for slot in preempted:
            req = self._slots[slot]
            if req is None:
                continue
            # the engine already freed the slot; preemption is
            # scheduling, not failure, so no retry is spent
            self._slots[slot] = None
            self.preempts += 1
            counters.inc("serving.preempt")
            try:
                self.requeue(req)
            except ValueError as exc:        # unresumable continuation
                self._admit_failures.append((req, exc))
        events: List[StepEvent] = []
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            n_emit = 1 if counts is None else int(counts[slot])
            row = tokens[slot]
            for j in range(n_emit):
                tok = int(row[j]) if np.ndim(row) else int(row)
                fin = bool(finished[slot]) and j == n_emit - 1
                req.tokens.append(tok)
                events.append(StepEvent(req, tok, fin))
                if fin:
                    self.engine.release(slot)
                    self._slots[slot] = None
        return events

    def drain(self) -> List[StepEvent]:
        """Run steps until queue and slots are empty (synchronous
        convenience for tests and batch scripts)."""
        events: List[StepEvent] = []
        while self.has_work():
            events.extend(self.run_step())
        return events

    def cancel_queued(self) -> List[Request]:
        """Drop every not-yet-admitted request (shutdown path)."""
        with self._lock:
            dropped = list(self._queue)
            self._queue.clear()
        return dropped
