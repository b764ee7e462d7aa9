"""Lightweight metrics: event counters, ordered scalar rows, percentiles.

Counterpart of the parts of ``apex_tpu/utils/metrics.py`` the serving
and training paths use.  PyTorch has no in-jit callbacks, so rows are
emitted from the host; :class:`MetricsWriter` still stages them by step
and drains them to its sink in step order, merging a step's rows
key-wise.
"""

from __future__ import annotations

import bisect
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counters", "counters", "MetricsWriter", "percentile_summary",
           "loss_scale_tallies"]

_logger = logging.getLogger("apex_tpu_torch.metrics")


class Counters:
    """Thread-safe named monotone counters (fault firings, serving
    requeues, ...), read by health probes and reports."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        """Add ``n`` to ``name`` (created at 0); returns the new value."""
        with self._lock:
            value = self._counts.get(name, 0) + int(n)
            self._counts[name] = value
            return value

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: process-wide default counter set
counters = Counters()


class MetricsWriter:
    """Collects scalar rows keyed by step; :meth:`drain` hands them to
    the sink (default: the package logger) in ascending step order and
    appends them to ``history``.  Per step, rows merge key-wise with the
    first emission winning; a row for an already drained step is
    dropped.  Thread-safe."""

    def __init__(self, sink: Optional[Callable[[int, Dict[str, float]],
                                               None]] = None):
        self.history: List[Tuple[int, Dict[str, float]]] = []
        self._sink = sink
        self._pending: Dict[int, Dict[str, float]] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        self._drain_lock = threading.Lock()

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        step = int(step)
        row = {k: float(v) for k, v in metrics.items()}
        with self._lock:
            if step in self._seen:
                return
            staged = self._pending.get(step)
            self._pending[step] = row if staged is None \
                else {**row, **staged}

    def drain(self) -> List[Tuple[int, Dict[str, float]]]:
        """Release staged rows in step order; returns them."""
        with self._drain_lock:
            with self._lock:
                rows = sorted(self._pending.items())
                self._pending.clear()
                self._seen.update(step for step, _ in rows)
            for step, row in rows:
                bisect.insort(self.history, (step, row),
                              key=lambda r: r[0])
                if self._sink is not None:
                    self._sink(step, row)
                else:
                    _logger.info("step %d %s", step, " ".join(
                        f"{k}={v:.6g}" for k, v in row.items()))
            return rows


def percentile_summary(values, p50_key: str, p99_key: str, *,
                       scale: float = 1.0) -> Dict[str, float]:
    """p50/p99 of a snapshot of samples (empty dict without samples);
    ``scale`` converts units (1e3: seconds to milliseconds)."""
    if not values:
        return {}
    arr = np.asarray(values, np.float64) * scale
    return {p50_key: float(np.percentile(arr, 50)),
            p99_key: float(np.percentile(arr, 99))}


def loss_scale_tallies(loss_scale_state) -> Dict[str, int]:
    """The loss scaler's device-side event tallies as counter names:
    ``amp.loss_scale.growth`` (steps that grew the scale) and
    ``amp.loss_scale.backoff`` (skipped, non-finite steps).  Reads the
    device, so call it outside the step, when the numbers are wanted."""
    growth, backoff = (int(v) for v in loss_scale_state.events.tolist())
    return {"amp.loss_scale.growth": growth,
            "amp.loss_scale.backoff": backoff}
