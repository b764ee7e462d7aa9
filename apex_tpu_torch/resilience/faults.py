"""Deterministic, seedable fault injection — the serving sites.

Counterpart of the parts of ``apex_tpu/resilience/faults.py`` that the
scheduler and the server call: :func:`inject` at the ``serving.step``
and ``serving.admit`` sites, and the :class:`TransientError` family the
serving loop recovers from.  A :class:`FaultPlan` names which fault
fires at which site on which step; whether a spec fires is a pure
function of ``(plan.seed, spec index, site, step)``, so a failing run
replays exactly.  Plans are scoped with :func:`active`.  The training
sites, the other fault kinds (I/O, NaN, slow, preempt) and the
environment entry point come with ROADMAP.md A-6.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple

from apex_tpu_torch.utils.metrics import counters

__all__ = ["TransientError", "TransientStepError", "FaultSpec",
           "FaultPlan", "active", "inject"]


class TransientError(RuntimeError):
    """A failure the raiser declares RETRYABLE: state is intact and the
    operation may be re-attempted."""


class TransientStepError(TransientError):
    """Retryable serving-step failure (``kind="transient"``); ``slots``
    names the poisoned slots, ``None`` means every active slot."""

    def __init__(self, message: str = "injected transient step fault",
                 slots: Optional[Sequence[int]] = None):
        super().__init__(message)
        self.slots = None if slots is None else tuple(int(s) for s in slots)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: where (``site``), what (``kind``; the serving sites
    take ``transient``) and when (``step``, ``every``, ``prob``;
    AND-combined, none = every call), at most ``times`` firings;
    ``slots`` names the slots a transient fault poisons."""

    site: str
    kind: str
    step: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    times: Optional[int] = None
    slots: Optional[Tuple[int, ...]] = None

    KINDS = ("transient",)
    #: the JAX package's training-side sites, not ported yet
    DEFERRED_SITES = ("train.step", "train.compute", "checkpoint.save",
                      "data.next")

    def __post_init__(self):
        if self.site in self.DEFERRED_SITES:
            raise NotImplementedError(
                f"fault site {self.site!r} comes with ROADMAP.md A-6")
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {self.KINDS}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")

    def matches(self, site: str, step: int, seed: int, index: int) -> bool:
        if site != self.site:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.every is not None and step % self.every != 0:
            return False
        if self.prob is not None:
            key = f"{seed}:{index}:{site}:{step}".encode()
            if zlib.crc32(key) / 2.0 ** 32 >= self.prob:
                return False
        return True


class FaultPlan:
    """A seedable schedule of :class:`FaultSpec` firings; holds the
    per-spec fire counts and per-site call counters (the implicit step
    of a site that passes none).  Thread-safe."""

    def __init__(self, faults: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.faults = tuple(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._fired: Dict[int, int] = {}
        self._site_calls: Dict[str, int] = {}

    def fire_count(self, spec_index: int) -> int:
        with self._lock:
            return self._fired.get(spec_index, 0)

    def _arm(self, site: str, step: Optional[int]):
        with self._lock:
            if step is None:
                step = self._site_calls.get(site, 0)
                self._site_calls[site] = step + 1
            hits = []
            for i, spec in enumerate(self.faults):
                if not spec.matches(site, int(step), self.seed, i):
                    continue
                if spec.times is not None \
                        and self._fired.get(i, 0) >= spec.times:
                    continue
                self._fired[i] = self._fired.get(i, 0) + 1
                hits.append(spec)
            return step, hits


_plan_lock = threading.Lock()
_plan: Optional[FaultPlan] = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scope ``plan`` as the process-wide active plan."""
    global _plan
    with _plan_lock:
        prev, _plan = _plan, plan
    try:
        yield plan
    finally:
        with _plan_lock:
            _plan = prev


def inject(site: str, step: Optional[int] = None) -> None:
    """Fire the active plan's faults for ``site`` at ``step`` (the
    site's own call count when ``None``): a firing ``transient`` spec
    raises :class:`TransientStepError`.  Without a plan: a no-op."""
    with _plan_lock:
        plan = _plan
    if plan is None:
        return
    step, hits = plan._arm(site, step)
    for spec in hits:
        counters.inc(f"fault.{spec.kind}")
        raise TransientStepError(
            f"injected transient fault at {site!r} (step {step})",
            slots=spec.slots)
