"""Metrics registry behind the receivers' counters (counterpart of the
parts of ziria_tpu/utils/telemetry.py that the streaming receiver
touches: ``collect`` :494, ``observe`` :554, ``count`` :567, and the
registry's counters, gauges and histograms).

:func:`collect` activates a :class:`MetricsRegistry` for a block; every
:func:`count`, :func:`observe` and gauge sample recorded while it is
active lands in it. When nothing collects, every emitter costs one
truthiness check. There are no spans and no trace export.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

_LOCK = threading.Lock()      # guards (de)activation only
_REGISTRIES: Tuple["MetricsRegistry", ...] = ()

DISPATCH_COUNTER = "ziria_dispatches_total"
DISPATCH_HISTOGRAM = "ziria_dispatch_seconds"
GAUGE_METRIC = "ziria_gauge"


class CounterMetric:
    """Monotonic event counter."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """A level: the last and the largest value set."""

    __slots__ = ("_lock", "last", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.last: Optional[float] = None
        self.max = -math.inf

    def set(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.last = v
            self.max = max(self.max, v)


class Histogram:
    """Observations' exact count, sum, min and max."""

    __slots__ = ("_lock", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)


class MetricsRegistry:
    """Thread-safe name+labels -> metric map, get-or-create."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, str]):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.setdefault(key, cls())
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(labels)} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, **labels: str) -> CounterMetric:
        return self._get(CounterMetric, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(Histogram, name, labels)

    def counters(self) -> Dict[str, int]:
        """{name: value} of the unlabelled counters."""
        with self._lock:
            return {k[0]: m.value for k, m in self._metrics.items()
                    if isinstance(m, CounterMetric) and not k[1]}


@contextmanager
def collect(registry: Optional[MetricsRegistry] = None):
    """Activate a :class:`MetricsRegistry` for the block; yields it."""
    global _REGISTRIES
    r = registry if registry is not None else MetricsRegistry()
    with _LOCK:
        _REGISTRIES = _REGISTRIES + (r,)
    try:
        yield r
    finally:
        with _LOCK:
            lst = list(_REGISTRIES)
            del lst[len(lst) - 1 - lst[::-1].index(r)]
            _REGISTRIES = tuple(lst)


def dispatch_event(label: str, n: int = 1,
                   seconds: Optional[float] = None) -> None:
    """One instrumented dispatch site firing: its counter, and a latency
    observation when the site is timed."""
    for r in _REGISTRIES:
        r.counter(DISPATCH_COUNTER, site=label).inc(n)
        if seconds is not None:
            r.histogram(DISPATCH_HISTOGRAM, site=label).observe(seconds)


def gauge_sample(label: str, value: float) -> None:
    """One level sample into every active registry."""
    for r in _REGISTRIES:
        r.gauge(GAUGE_METRIC, site=label).set(value)


def observe(name: str, value: float) -> None:
    """One histogram observation into every active registry."""
    for r in _REGISTRIES:
        r.histogram(name).observe(value)


def count(name: str, n: int = 1) -> None:
    """An event counter into every active registry."""
    for r in _REGISTRIES:
        r.counter(name).inc(n)
