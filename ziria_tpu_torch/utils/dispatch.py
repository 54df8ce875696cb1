"""Batch geometry helpers and dispatch counters (counterpart of
ziria_tpu/utils/dispatch.py: the geometry helpers :81-100, ``record``
:150, ``record_gauge`` :174, ``timed`` :193 and ``count_dispatches``
:214).

:func:`count_dispatches` counts the instrumented sites a block fires:
every :func:`record` (or :func:`timed` block) inside it adds one to
its label, every :func:`record_gauge` keeps the level's high-water
mark. The same events feed any active ``telemetry.collect`` registry,
and every :func:`timed` block is a span of any active
``telemetry.tracing`` trace (and, under ``annotate_device``, a
``torch.profiler.record_function`` range, which is how
``utils/programs`` attributes kernels to sites). When nothing collects
or traces, each emitter costs one truthiness check.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from ziria_tpu_torch.utils import telemetry as _tm

_LOCK = threading.Lock()          # guards _ACTIVE mutation only
_ACTIVE: List["DispatchCount"] = []


def _idle() -> bool:
    return not (_ACTIVE or _tm._REGISTRIES or _tm._TRACES)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def pow2_bucket(n: int, min_bucket: int) -> int:
    """Power-of-two size bucket with a floor (symbol buckets floor at
    4, capture buckets at 512)."""
    return max(int(min_bucket), pow2_ceil(n))


def pad_lanes(lanes: Sequence) -> list:
    """Pad a non-empty lane list to the next power-of-two count by
    repeating lane 0. The batch shapes then match the reference's lane
    for lane; callers read only the first ``len(lanes)`` results."""
    lanes = list(lanes)
    return lanes + [lanes[0]] * (pow2_ceil(len(lanes)) - len(lanes))


class DispatchCount:
    """What one :func:`count_dispatches` block saw: ``counts`` per
    site, ``times`` (wall seconds) per :func:`timed` site, ``gauges``
    the high-water mark per :func:`record_gauge` label."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: Counter = Counter()
        self.times: Counter = Counter()
        self.gauges: Dict[str, float] = {}

    def _add(self, label: str, n: int, seconds: Optional[float]) -> None:
        with self._lock:
            self.counts[label] += n
            if seconds is not None:
                self.times[label] += seconds

    def _gauge(self, label: str, value: float) -> None:
        with self._lock:
            if value > self.gauges.get(label, float("-inf")):
                self.gauges[label] = value

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def record(label: str = "dispatch", n: int = 1,
           seconds: Optional[float] = None) -> None:
    """Report ``n`` dispatches at an instrumented site (with the wall
    time the call took, from :func:`timed`)."""
    if _idle():
        return
    for c in tuple(_ACTIVE):
        c._add(label, n, seconds)
    if _tm._REGISTRIES:
        _tm.dispatch_event(label, n, seconds)


def record_gauge(label: str, value: float) -> None:
    """Report the current level of an instrumented quantity (the
    streaming receiver's chunks in flight)."""
    if _idle():
        return
    for c in tuple(_ACTIVE):
        c._gauge(label, value)
    _tm.gauge_sample(label, value)


@contextmanager
def timed(label: str = "dispatch"):
    """``with timed("rx.stream_chunk"): ...``: one dispatch at the site
    plus the block's wall time (on the host clock: on the card, the
    launch time, not the device's); under an active trace also a span
    of that name."""
    if _idle():
        yield
        return
    with _tm.span(label):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            record(label, seconds=time.perf_counter() - t0)


@contextmanager
def count_dispatches():
    """``with count_dispatches() as d:``: afterwards ``d.total`` is the
    number of instrumented dispatches the block fired and ``d.counts``
    the per-label breakdown."""
    c = DispatchCount()
    with _LOCK:
        _ACTIVE.append(c)
    try:
        yield c
    finally:
        with _LOCK:
            _ACTIVE.remove(c)
