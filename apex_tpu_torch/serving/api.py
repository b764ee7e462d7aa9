"""Threaded front end: submit → handle, streaming tokens, metrics.

Counterpart of ``apex_tpu/serving/api.py``, over the dense KV cache
(``kv_cache="dense"``) or the paged pool (``kv_cache="paged"``, the
:class:`~apex_tpu_torch.serving.engine.PagedEngine`).
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

    server = InferenceServer(model, kv_cache="paged", max_slots=8,
                             prefill_chunk=128, share_prefixes=True,
                             spec_tokens=3, kv_dtype="int8")

The model carries its weights (a ``torch.nn.Module`` on the serving
device), so there is no separate ``params`` argument.

Tensor parallelism (``kv_cache="paged"`` with ``tp=`` or ``mesh=``):
every tensor rank builds the model on the serving mesh and its own
server, and calls ``start`` / ``shutdown``; requests enter on tensor
rank 0, whose worker thread schedules.  Its engine records the calls
that change engine state — admissions, releases (preemptions, evictions
and finished requests) and each step — and broadcasts the record of a
step, before running it, over the tensor group's gloo group; the worker
threads of the other ranks replay each record on their engines, so
every rank runs the same step with the same host state, and none of
them schedules.  ``health()`` and the metrics carry
``chips_per_replica``, ``mesh_shape`` and the per-chip throughput.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from apex_tpu_torch.core.mesh import TENSOR_AXIS
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    Engine,
    PagedEngine,
)
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


class _RecordingEngine:
    """Tensor rank 0's engine under tensor parallelism: the calls that
    change engine state are recorded (after they succeed; a step before
    it runs), and a step first broadcasts the record since the last one
    to the other tensor ranks (:meth:`InferenceServer._follow` replays
    it).  Every other attribute is the engine's."""

    def __init__(self, engine, channel: "_Channel"):
        self._engine = engine
        self._channel = channel
        self._calls: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def admit(self, slot, prompt, **kw):
        self._engine.admit(slot, prompt, **kw)
        self._calls.append(("admit", (slot, np.asarray(prompt)), kw))

    def release(self, slot):
        self._engine.release(slot)
        self._calls.append(("release", (slot,), {}))

    def step(self):
        self._channel.send(self._calls + [("step", (), {})])
        self._calls = []
        return self._engine.step()

    def close(self) -> None:
        """The last record: what is left, then stop."""
        self._channel.send(self._calls + [("stop", (), {})])
        self._calls = []


class _Channel:
    """Records from tensor rank 0 to the others, over the tensor group's
    gloo group (``broadcast_object_list``)."""

    def __init__(self, mesh):
        self.group = mesh.host_group(TENSOR_AXIS)
        self.src = mesh.line(TENSOR_AXIS)[0]

    def send(self, record) -> None:
        dist.broadcast_object_list([record], src=self.src, group=self.group)

    def receive(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


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
                 metrics_interval: int = 32, kv_cache: str = "dense",
                 block_size: int = 0, pool_tokens: Optional[int] = None,
                 admit_headroom: Optional[int] = None,
                 share_prefixes: bool = False, spec_tokens: int = 0,
                 spec_ngram: int = 3, kv_dtype: Optional[str] = None,
                 tp: int = 0, mesh: Optional[Any] = None):
        if kv_cache == "paged":
            if prompt_buckets is not None:
                raise ValueError(
                    "prompt_buckets only applies to kv_cache='dense' — "
                    "chunked prefill admits any prompt length; tune "
                    "prefill_chunk and pool_tokens instead")
            if tp and mesh is not None:
                # mesh may be a Mesh or an int (the engine takes both):
                # its tensor width must agree with an explicit tp
                mesh_tp = (mesh if isinstance(mesh, int)
                           else dict(getattr(mesh, "shape", {}) or {}).get(
                               TENSOR_AXIS, 1))
                if mesh_tp != tp:
                    raise ValueError(
                        f"tp={tp} disagrees with mesh ({TENSOR_AXIS} axis "
                        f"{mesh_tp}) — pass one or make them match")
            # chunked prefill needs a width; 0 maps to the default
            self.engine: Any = PagedEngine(
                model, max_slots=max_slots, block_size=block_size,
                pool_tokens=pool_tokens, prefill_chunk=prefill_chunk or 32,
                admit_headroom=admit_headroom,
                share_prefixes=share_prefixes, spec_tokens=spec_tokens,
                spec_ngram=spec_ngram, kv_dtype=kv_dtype,
                mesh=(mesh if mesh is not None
                      else (tp if tp and tp > 1 else None)))
        elif kv_cache == "dense":
            if (tp and tp > 1) or mesh is not None:
                raise ValueError(
                    "tp / mesh require kv_cache='paged' — tensor-parallel "
                    "serving shards the paged pool on its kv_heads axis; "
                    "the dense slab engine is single-chip")
            if share_prefixes or spec_tokens:
                raise ValueError(
                    "share_prefixes / spec_tokens require kv_cache='paged' "
                    "— the dense slab has no page pool to share and no "
                    "multi-token step to verify drafts in")
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype requires kv_cache='paged' — quantized KV "
                    "pages live in the paged pool; the dense slab stores "
                    "K/V in the model's compute dtype")
            self.engine = Engine(
                model, max_slots=max_slots,
                prompt_buckets=(DEFAULT_BUCKETS if prompt_buckets is None
                                else prompt_buckets),
                prefill_chunk=prefill_chunk)
        else:
            raise ValueError(
                f"kv_cache={kv_cache!r} not in ('dense', 'paged')")
        #: tensor rank of this server (0 schedules) and the record
        #: channel to the other ranks (tp > 1 only)
        self.tp_rank, self._channel = 0, None
        if getattr(self.engine, "tp", 1) > 1:
            mesh = self.engine.mesh
            self.tp_rank = mesh.axis_rank(TENSOR_AXIS)
            self._channel = _Channel(mesh)
            if self.tp_rank == 0:
                self.engine = _RecordingEngine(self.engine, self._channel)
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
        target = self._follow if self.tp_rank else self._serve
        self._thread = threading.Thread(
            target=target, name="apex-tpu-torch-serving", daemon=True)
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
        if self.tp_rank:
            raise ValueError(
                f"requests enter on tensor rank 0; this server is tensor "
                f"rank {self.tp_rank}, which follows its records")
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
    def _follow(self) -> None:
        """A tensor rank other than 0: replay rank 0's records until its
        stop record."""
        try:
            while True:
                for name, args, kw in self._channel.receive():
                    if name == "stop":
                        return
                    getattr(self.engine, name)(*args, **kw)
                    if name == "step":
                        self._steps += 1
        except BaseException as exc:    # noqa: BLE001 — surfaced by health
            with self._wakeup:
                self.error = exc
                self._stop = True

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
            if self._channel is not None:
                self.engine.close()

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
        chips = self._chips()
        payload = {
            "tokens_per_sec": self._window_tokens / dt,
            # per chip: a tensor-parallel replica divides by its width,
            # so 1 x M and M x 1 deployments compare at equal chips
            "tokens_per_sec_per_chip": self._window_tokens / dt / chips,
            "chips_per_replica": chips,
            "occupancy": self.scheduler.occupancy,
            "queue_depth": self.scheduler.queue_depth,
            "tokens_total": self._tokens_emitted,
            "requeues": self._requeues,
            "failed_requests": self._failed_requests,
            "deadline_expired": self._deadline_expired,
            "preempts": self.scheduler.preempts,
        }
        payload.update(self.latency_summary())
        payload.update(self._pool_gauges(numeric=True))
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
        out = {
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
            "preempts": self.scheduler.preempts,
            "error": None if error is None else repr(error),
            "chips_per_replica": self._chips(),
            **self._pool_gauges(numeric=False),
        }
        mesh_shape = getattr(self.engine, "mesh_shape", None)
        if mesh_shape is not None:
            out["mesh_shape"] = mesh_shape
        return out

    def _chips(self) -> int:
        return int(getattr(self.engine, "chips_per_replica", 1))

    def _pool_gauges(self, numeric: bool) -> Dict[str, Any]:
        """The paged pool's gauges (empty for the dense engine): pages in
        use and total, live tokens, shared pages, copy-on-write forks,
        the storage width in bits (and its name, ``kv_dtype``, for
        :meth:`health`), and the draft accept rate when speculation is
        configured."""
        eng = self.engine
        if not eng.paged:
            return {}
        out: Dict[str, Any] = {
            "blocks_in_use": eng.blocks_in_use,
            "blocks_total": eng.blocks_total,
            "live_tokens": eng.live_tokens,
            "shared_blocks": eng.shared_blocks,
            "cow_forks": eng.cow_forks,
            "kv_bits": eng.kv_bits,
        }
        if not numeric:
            out["kv_dtype"] = eng.kv_dtype
        if eng.spec_tokens:
            out["spec_accept_rate"] = eng.spec_accept_rate
        return out

    def prefix_hit_blocks(self, prompt) -> int:
        """Pages of ``prompt``'s prefix resident in this server's trie
        (0 for the dense engine or with sharing off)."""
        fn = getattr(self.engine, "prefix_hit_blocks", None)
        return 0 if fn is None else int(fn(prompt))

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def tokens_emitted(self) -> int:
        return self._tokens_emitted
