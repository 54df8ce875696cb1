"""Metrics registry behind the receivers' counters and the server's
scrape page (counterpart of the metrics half of
ziria_tpu/utils/telemetry.py: the log-bucket ``Histogram`` :87,
``CounterMetric``, the time-series ``Gauge``, ``MetricsRegistry``
:219-317 with ``snapshot`` and the Prometheus ``exposition``,
``collect`` :494, ``observe`` :554 and ``count`` :567).

:func:`collect` activates a :class:`MetricsRegistry` for a block; every
:func:`count`, :func:`observe` and gauge sample recorded while it is
active lands in it. When nothing collects, every emitter costs one
truthiness check. Histograms keep the reference's power-of-two buckets,
so a quantile, a summary and the exposition text are the reference's
for the same observations. There are no spans and no trace export.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_LOCK = threading.Lock()      # guards (de)activation only
_REGISTRIES: Tuple["MetricsRegistry", ...] = ()

DISPATCH_COUNTER = "ziria_dispatches_total"
DISPATCH_HISTOGRAM = "ziria_dispatch_seconds"
GAUGE_METRIC = "ziria_gauge"


def _bucket_exp(v: float) -> int:
    """The exponent e with v in (2**(e-1), 2**e], for v > 0."""
    m, e = math.frexp(v)
    if m == 0.5:
        e -= 1
    return e


class Histogram:
    """Power-of-two log-bucket histogram: bucket e holds observations in
    (2**(e-1), 2**e], non-positive values one underflow bucket. Exact
    count, sum, min and max ride along; :meth:`quantile` is an upper
    bound on the true quantile, never more than twice it."""

    __slots__ = ("_lock", "_buckets", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: Dict[Optional[int], int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        e = _bucket_exp(v) if v > 0.0 else None
        with self._lock:
            self._buckets[e] = self._buckets.get(e, 0) + 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def _sorted_buckets(self) -> List[Tuple[Optional[int], int]]:
        return sorted(self._buckets.items(),
                      key=lambda kv: -math.inf if kv[0] is None else kv[0])

    def quantile(self, q: float) -> Optional[float]:
        """The upper edge of the bucket holding the rank-ceil(qN)
        observation, capped at the exact max; None when empty."""
        with self._lock:
            n = self.count
            if not n:
                return None
            rank = min(n, max(1, math.ceil(q * n)))
            c = 0
            for e, k in self._sorted_buckets():
                c += k
                if c >= rank:
                    if e is None:
                        return min(0.0, self.max)
                    return min(math.ldexp(1.0, e), self.max)
        return self.max

    def summary(self, scale: float = 1.0,
                ndigits: int = 6) -> Dict[str, Any]:
        """count, exact mean and max, p50/p90/p99 bounds, scaled (1e3
        for ms)."""
        if not self.count:
            return {"count": 0}

        def r(v):
            return round(v * scale, ndigits)
        return {"count": self.count, "mean": r(self.sum / self.count),
                "p50": r(self.quantile(0.50)), "p90": r(self.quantile(0.90)),
                "p99": r(self.quantile(0.99)), "max": r(self.max)}

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """(upper edge, count) per occupied bucket, ascending."""
        with self._lock:
            return [(0.0 if e is None else math.ldexp(1.0, e), k)
                    for e, k in self._sorted_buckets()]


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
    """A level over time: the last ``maxlen`` (monotonic seconds, value)
    samples, and the exact last and largest value."""

    __slots__ = ("_lock", "samples", "last", "max")

    def __init__(self, maxlen: int = 4096) -> None:
        self._lock = threading.Lock()
        self.samples: deque = deque(maxlen=maxlen)
        self.last: Optional[float] = None
        self.max = -math.inf

    def set(self, value: float, t: Optional[float] = None) -> None:
        v = float(value)
        with self._lock:
            self.samples.append((time.perf_counter() if t is None else t, v))
            self.last = v
            self.max = max(self.max, v)


def _metric_key(name: str, labels: Dict[str, str]):
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f'{k}="{v}"' for k, v in labels)


def _sanitize(name: str) -> str:
    """The Prometheus metric-name charset ([a-zA-Z0-9_:])."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


class MetricsRegistry:
    """Thread-safe name+labels -> metric map, get-or-create; readable
    as plain dicts (:meth:`snapshot`) or Prometheus text
    (:meth:`exposition`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, str]):
        key = _metric_key(name, labels)
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

    def metrics(self) -> List[Tuple[Tuple[str, Tuple], Any]]:
        """[((name, labels), metric)], sorted."""
        with self._lock:
            return sorted(self._metrics.items(), key=lambda kv: kv[0])

    def find(self, name: str, **labels: str):
        """The metric at name+labels, or None (never creates)."""
        return self._metrics.get(_metric_key(name, labels))

    def counters(self) -> Dict[str, int]:
        """{name: value} of the unlabelled counters."""
        with self._lock:
            return {k[0]: m.value for k, m in self._metrics.items()
                    if isinstance(m, CounterMetric) and not k[1]}

    def snapshot(self) -> Dict[str, Any]:
        """{name{labels}: value}: counters as ints, gauges as {last,
        max, samples}, histograms as their summaries."""
        out: Dict[str, Any] = {}
        for (name, labels), m in self.metrics():
            key = name + ("{%s}" % _label_str(labels) if labels else "")
            if isinstance(m, CounterMetric):
                out[key] = m.value
            elif isinstance(m, Gauge):
                with m._lock:
                    out[key] = {"last": m.last, "max": m.max,
                                "samples": [[round(t, 6), v]
                                            for t, v in m.samples]}
            else:
                out[key] = m.summary()
        return out

    def exposition(self) -> str:
        """Prometheus text: counters and gauges one sample each,
        histograms the cumulative ``_bucket{le=}``, ``_sum`` and
        ``_count`` series at the power-of-two edges."""
        by_name: Dict[str, List[Tuple[Tuple, Any]]] = {}
        for (name, labels), m in self.metrics():
            by_name.setdefault(name, []).append((labels, m))
        lines: List[str] = []
        for name, entries in sorted(by_name.items()):
            pname = _sanitize(name)
            kind = entries[0][1]
            typ = ("counter" if isinstance(kind, CounterMetric)
                   else "gauge" if isinstance(kind, Gauge) else "histogram")
            lines.append(f"# TYPE {pname} {typ}")
            for labels, m in entries:
                ls = _label_str(labels)
                if isinstance(m, CounterMetric):
                    lines.append(f"{pname}{{{ls}}} {m.value}" if ls
                                 else f"{pname} {m.value}")
                elif isinstance(m, Gauge):
                    v = m.last if m.last is not None else "NaN"
                    lines.append(f"{pname}{{{ls}}} {v}" if ls
                                 else f"{pname} {v}")
                else:
                    cum = 0
                    for edge, k in m.bucket_counts():
                        cum += k
                        le = f'le="{edge!r}"'
                        full = f"{ls},{le}" if ls else le
                        lines.append(f"{pname}_bucket{{{full}}} {cum}")
                    full = f"{ls},le=\"+Inf\"" if ls else 'le="+Inf"'
                    lines.append(f"{pname}_bucket{{{full}}} {m.count}")
                    sfx = f"{{{ls}}}" if ls else ""
                    lines.append(f"{pname}_sum{sfx} {m.sum!r}")
                    lines.append(f"{pname}_count{sfx} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


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
    if not _REGISTRIES:
        return
    t = time.perf_counter()
    for r in _REGISTRIES:
        r.gauge(GAUGE_METRIC, site=label).set(value, t)


def observe(name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
    """One histogram observation into every active registry."""
    for r in _REGISTRIES:
        r.histogram(name, **(labels or {})).observe(value)


def count(name: str, n: int = 1,
          labels: Optional[Dict[str, str]] = None) -> None:
    """An event counter into every active registry, one series per
    label set."""
    for r in _REGISTRIES:
        r.counter(name, **(labels or {})).inc(n)
