"""Threaded front end: submit → handle, streaming tokens, metrics.

Counterpart of ``apex_tpu/serving/api.py`` for the dense KV cache.
:class:`InferenceServer` owns one worker thread that runs the
engine/scheduler loop (all device work on that thread); client threads
talk to it only through the bounded queue and per-request
:class:`RequestHandle` streams.  Throughput, occupancy, queue depth and
latency percentiles flow through
:class:`~apex_tpu_torch.utils.metrics.MetricsWriter` every
``metrics_interval`` steps.

Usage::

    server = InferenceServer(model, max_slots=4)
    with server:                       # starts (and warms up) the loop
        h = server.submit([1, 2, 3], max_new_tokens=16)
        for tok in h.stream():
            ...
        full = h.result()

The model carries its weights (a ``torch.nn.Module`` on the serving
device), so there is no separate ``params`` argument.  The paged KV
cache, tensor parallelism, prefix sharing, speculative decoding,
graceful drain and the fleet router come with later slices (ROADMAP.md
A-3 and A-5).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving.engine import DEFAULT_BUCKETS, Engine
from apex_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from apex_tpu_torch.utils.metrics import (
    MetricsWriter,
    counters,
    percentile_summary,
)

__all__ = ["InferenceServer", "RequestHandle", "ServerClosed",
           "RequestFailed"]

_SENTINEL = object()


class ServerClosed(RuntimeError):
    """TERMINAL: the server shut down (or its worker died) before the
    request finished.  Also raised by ``submit`` on a stopped server."""


class RequestFailed(RuntimeError):
    """TERMINAL: this one request failed (deadline, repeated faults, an
    unresumable continuation) while the server keeps serving."""


class RequestHandle:
    """Client-side view of one in-flight request.

    :meth:`stream` and :meth:`result` raise ``TimeoutError`` (retryable:
    no token yet), :class:`RequestFailed` or :class:`ServerClosed`
    (terminal).  The terminal error is recorded before clients are
    woken, so a shutdown never surfaces as a bare timeout.
    """

    def __init__(self, request: Request):
        self._request = request
        self._stream: "queue_mod.Queue" = queue_mod.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def _deliver(self, token: int, finished: bool) -> None:
        self._stream.put(int(token))
        if finished:
            self._stream.put(_SENTINEL)
            self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._stream.put(_SENTINEL)
        self._done.set()

    def _cancel(self) -> None:
        self._fail(ServerClosed(
            "server shut down before the request finished"))

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are produced; ends at eos/budget."""
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"no token within {timeout}s (request still "
                    f"live — retryable)") from None
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished; returns every produced token."""
        if not self._done.wait(timeout):
            raise TimeoutError("request still decoding (retryable)")
        if self._error is not None:
            raise self._error
        return list(self._request.tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def tokens_so_far(self) -> List[int]:
        return list(self._request.tokens)


class InferenceServer:
    """Continuous-batching inference server over one model.

    ``submit`` blocks while the queue is full (``block=False`` raises
    :class:`~apex_tpu_torch.serving.scheduler.QueueFull` instead).
    ``shutdown(wait=True)`` serves everything accepted, then stops;
    ``wait=False`` cancels queued and in-flight requests.  A
    :class:`~apex_tpu_torch.resilience.faults.TransientError` during a
    step evicts the slots it names (all when it names none) and
    requeues each tenant once, continuing from its streamed prefix; a
    second fault fails just that request.  Deadlines are enforced in
    the queue and mid-decode.  Any other exception kills the worker and
    cancels every client (root cause on :attr:`error`).
    """

    def __init__(self, model, *, max_slots: int = 4,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: int = 0, queue_capacity: int = 64,
                 metrics: Optional[MetricsWriter] = None,
                 metrics_interval: int = 32, kv_cache: str = "dense"):
        if kv_cache == "paged":
            raise NotImplementedError(
                "kv_cache='paged' comes with ROADMAP.md A-3, the paged "
                "serving slice")
        if kv_cache != "dense":
            raise ValueError(
                f"kv_cache={kv_cache!r} not in ('dense', 'paged')")
        self.engine = Engine(
            model, max_slots=max_slots,
            prompt_buckets=(DEFAULT_BUCKETS if prompt_buckets is None
                            else prompt_buckets),
            prefill_chunk=prefill_chunk)
        self.scheduler = Scheduler(self.engine,
                                   queue_capacity=queue_capacity)
        self.metrics = metrics
        self.metrics_interval = max(1, int(metrics_interval))
        self._handles: dict = {}          # id(request) -> RequestHandle
        self._wakeup = threading.Condition()
        self._stop = False
        self._drain_on_stop = True
        self._started_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._steps = 0
        self._step_attempts = 0
        self._tokens_emitted = 0
        self._window_tokens = 0
        self._window_t0: Optional[float] = None
        self._last_emit_step = -1
        self._requeues = 0
        self._failed_requests = 0
        self._deadline_expired = 0
        self._lat_lock = threading.Lock()
        self._ttft: deque = deque(maxlen=2048)
        self._step_times: deque = deque(maxlen=4096)
        #: the exception that killed the worker loop, if any
        self.error: Optional[BaseException] = None

    # ---------------------------------------------------------- lifecycle
    def start(self, *, warmup: bool = True) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if warmup:
            self.engine.warmup()
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._serve, name="apex-tpu-torch-serving", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, *, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        if self._thread is None:
            return
        with self._wakeup:
            self._stop = True
            self._drain_on_stop = wait
            self._wakeup.notify_all()
        self._thread.join(timeout)
        self._thread = None

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(wait=exc_type is None)

    # ------------------------------------------------------------- intake
    def submit(self, prompt, *, max_new_tokens: int,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               eos_id: Optional[int] = None, seed: int = 0,
               deadline: Optional[float] = None, block: bool = True,
               timeout: Optional[float] = None) -> RequestHandle:
        """Enqueue one request; returns its :class:`RequestHandle`.
        ``deadline`` bounds the request's total latency (seconds from
        acceptance); ``timeout`` bounds only this call's wait for queue
        space."""
        request = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            top_k=top_k, top_p=top_p, eos_id=eos_id, seed=int(seed),
            deadline=None if deadline is None else float(deadline))
        # reachable by the worker BEFORE the request enters the queue: a
        # fast worker may finish a one-token request before submit returns
        handle = RequestHandle(request)
        self._handles[id(request)] = handle
        submit_deadline = None if timeout is None \
            else time.monotonic() + timeout
        try:
            while True:
                with self._wakeup:
                    if self._stop or self._thread is None:
                        raise ServerClosed("server is not running")
                    try:
                        self.scheduler.submit(request)
                        self._wakeup.notify_all()
                        return handle
                    except QueueFull:
                        if not block:
                            raise
                        remaining = None if submit_deadline is None \
                            else submit_deadline - time.monotonic()
                        if remaining is not None and remaining <= 0:
                            raise
                        self._wakeup.wait(
                            0.05 if remaining is None
                            else min(0.05, remaining))
        except BaseException:
            self._handles.pop(id(request), None)
            raise

    # ------------------------------------------------------------- worker
    def _serve(self) -> None:
        try:
            while True:
                with self._wakeup:
                    while (not self.scheduler.has_work()
                           and not self._stop):
                        self._wakeup.wait(0.1)
                    if self._stop and (not self._drain_on_stop
                                       or not self.scheduler.has_work()):
                        break
                self._expire_deadlines()
                if not self.scheduler.has_work():
                    continue
                try:
                    attempt = self._step_attempts
                    self._step_attempts += 1
                    faults.inject("serving.step", step=attempt)
                    t_step0 = time.monotonic()
                    events = self.scheduler.run_step()
                    with self._lat_lock:
                        self._step_times.append(
                            time.monotonic() - t_step0)
                except faults.TransientError as exc:
                    self._recover_step(exc)
                    with self._wakeup:
                        self._wakeup.notify_all()
                    continue
                for req, exc in self.scheduler.take_admit_failures():
                    failure = RequestFailed(
                        f"admission failed twice for request "
                        f"{req.uid}: {exc}")
                    failure.__cause__ = exc
                    self._fail_request(req, failure)
                self._steps += 1
                now = time.monotonic()
                if self._window_t0 is None:
                    self._window_t0 = now
                for ev in events:
                    self._tokens_emitted += 1
                    self._window_tokens += 1
                    if len(ev.request.tokens) == 1:
                        with self._lat_lock:
                            self._ttft.append(now - ev.request.accepted_at)
                    handle = self._handles.get(id(ev.request))
                    if handle is not None:
                        handle._deliver(ev.token, ev.finished)
                        if ev.finished:
                            self._handles.pop(id(ev.request), None)
                with self._wakeup:
                    self._wakeup.notify_all()
                if self.metrics is not None \
                        and self._steps % self.metrics_interval == 0:
                    self._emit_metrics(now)
        except BaseException as exc:    # noqa: BLE001 — clients must not hang
            with self._wakeup:
                self.error = exc
                self._stop = True
                self._wakeup.notify_all()
        finally:
            with self._wakeup:
                error = self.error
            for req in self.scheduler.cancel_queued():
                handle = self._handles.pop(id(req), None)
                if handle is not None:
                    handle._cancel()
            for slot, req in enumerate(self.scheduler._slots):
                if req is None:
                    continue
                if error is None:
                    self.engine.release(slot)
                self.scheduler._slots[slot] = None
                handle = self._handles.pop(id(req), None)
                if handle is not None:
                    handle._cancel()
            if self.metrics is not None \
                    and self._steps != self._last_emit_step:
                self._emit_metrics(time.monotonic())

    # ----------------------------------------------------- fault recovery
    def _fail_request(self, req: Request, failure: RequestFailed) -> None:
        self._failed_requests += 1
        counters.inc("serving.request_failed")
        handle = self._handles.pop(id(req), None)
        if handle is not None:
            handle._fail(failure)

    def _recover_step(self, exc: "faults.TransientError") -> None:
        """Evict the poisoned slots; requeue each tenant once."""
        counters.inc("serving.step_fault")
        poisoned = getattr(exc, "slots", None)
        for slot, req in enumerate(list(self.scheduler._slots)):
            if req is None:
                continue
            if poisoned is not None and slot not in poisoned:
                continue
            self.scheduler.evict(slot)
            cause: BaseException = exc
            if req.retries < 1:
                req.retries += 1
                try:
                    self.scheduler.requeue(req)
                    self._requeues += 1
                    counters.inc("serving.requeue")
                    continue
                except ValueError as ve:
                    cause = ve
            failure = RequestFailed(
                f"request {req.uid} evicted by a step fault and not "
                f"requeueable (retries={req.retries}): {cause}")
            failure.__cause__ = cause
            self._fail_request(req, failure)

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        for req in self.scheduler.expire_queued(now):
            self._deadline_expired += 1
            counters.inc("serving.deadline_expired")
            self._fail_request(req, RequestFailed(
                f"request {req.uid} deadline ({req.deadline}s) "
                f"expired in queue"))
        for slot, req in enumerate(list(self.scheduler._slots)):
            if req is None or req.deadline is None:
                continue
            if now - req.accepted_at > req.deadline:
                self.scheduler.evict(slot)
                self._deadline_expired += 1
                counters.inc("serving.deadline_expired")
                self._fail_request(req, RequestFailed(
                    f"request {req.uid} deadline ({req.deadline}s) "
                    f"expired after {len(req.tokens)} tokens"))

    # ---------------------------------------------------------- telemetry
    def latency_summary(self) -> Dict[str, float]:
        """p50/p99 of time to first token (s) and step time (ms)."""
        with self._lat_lock:
            ttft = list(self._ttft)
            step_times = list(self._step_times)
        out: Dict[str, float] = {}
        out.update(percentile_summary(ttft, "ttft_p50_s", "ttft_p99_s"))
        out.update(percentile_summary(
            step_times, "step_ms_p50", "step_ms_p99", scale=1e3))
        return out

    def _emit_metrics(self, now: float) -> None:
        dt = max(now - (self._window_t0 or now), 1e-9)
        payload = {
            "tokens_per_sec": self._window_tokens / dt,
            "occupancy": self.scheduler.occupancy,
            "queue_depth": self.scheduler.queue_depth,
            "tokens_total": self._tokens_emitted,
            "requeues": self._requeues,
            "failed_requests": self._failed_requests,
            "deadline_expired": self._deadline_expired,
        }
        payload.update(self.latency_summary())
        self.metrics(self._steps, payload)
        self.metrics.drain()
        self._last_emit_step = self._steps
        self._window_tokens = 0
        self._window_t0 = now

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness probe: ``status`` is ``"serving"``,
        ``"stopped"`` or ``"failed"``; counters double as a soak's
        scoreboard."""
        now = time.monotonic()
        with self._wakeup:
            alive = self._thread is not None and self._thread.is_alive()
            stopping = self._stop
            error = self.error
        if error is not None:
            status = "failed"
        elif not alive or stopping:
            status = "stopped"
        else:
            status = "serving"
        return {
            "status": status,
            "ready": status == "serving",
            "uptime_s": (0.0 if self._started_at is None
                         else now - self._started_at),
            "steps": self._steps,
            "queue_depth": self.scheduler.queue_depth,
            "occupancy": self.scheduler.occupancy,
            "tokens_emitted": self._tokens_emitted,
            "requeues": self._requeues,
            "failed_requests": self._failed_requests,
            "deadline_expired": self._deadline_expired,
            "error": None if error is None else repr(error),
        }

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def tokens_emitted(self) -> int:
        return self._tokens_emitted
