"""Runtime telemetry: span traces and a metrics registry behind every
dispatch site (counterpart of ziria_tpu/utils/telemetry.py: the
log-bucket ``Histogram`` :87, ``CounterMetric``, the time-series
``Gauge``, ``MetricsRegistry`` :219-317 with ``snapshot`` and the
Prometheus ``exposition``, ``Trace`` :323, ``span`` :422, ``tracing``
:472, ``collect`` :494, ``env_trace_path`` :509, ``observe`` :554,
``count`` :567 and ``record_compile`` :586).

- **Span tracing.** :func:`tracing` activates a :class:`Trace`;
  :func:`span` (and every ``dispatch.timed`` site) records nested,
  per-thread spans with monotonic timestamps. :meth:`Trace.export`
  writes the reference's Chrome trace-event JSON (complete ``X`` spans,
  ``C`` counter tracks, ``compile`` events, top-level riders), which
  Perfetto, ``chrome://tracing`` and ``tools/trace_report.py`` read.
  ``Trace(annotate_device=True)`` also opens a
  ``torch.profiler.record_function`` range per span, so a concurrent
  ``torch.profiler`` capture shows the same labels.
- **Metrics.** :func:`collect` activates a :class:`MetricsRegistry`;
  every :func:`count`, :func:`observe` and gauge sample recorded while
  it is active lands in it. Histograms keep the reference's
  power-of-two buckets, so a quantile, a summary and the exposition
  text are the reference's for the same observations.
- **Compile events.** The port's only compiles are the nvcc builds of
  ``cuda_build``; each reports itself through :func:`record_compile`
  as a span in the ``compile`` category. The reference's
  ``jax.monitoring`` listener (:615-647) has no counterpart: eager
  torch compiles nothing else.

When nothing traces or collects, every emitter costs one truthiness
check.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_LOCK = threading.Lock()      # guards (de)activation only
_TRACES: Tuple["Trace", ...] = ()
_REGISTRIES: Tuple["MetricsRegistry", ...] = ()

DISPATCH_COUNTER = "ziria_dispatches_total"
DISPATCH_HISTOGRAM = "ziria_dispatch_seconds"
GAUGE_METRIC = "ziria_gauge"
COMPILE_COUNTER = "ziria_compile_events_total"
COMPILE_HISTOGRAM = "ziria_compile_seconds"


def active() -> bool:
    """True when any trace or registry is collecting."""
    return bool(_TRACES or _REGISTRIES)


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


class Trace:
    """Chrome trace-event collector. Spans land as complete (``X``)
    events with microsecond timestamps relative to the trace's own
    monotonic epoch, gauges as counter (``C``) tracks, compile events
    in the ``compile`` category. :meth:`export` writes the standard
    ``{"traceEvents": [...]}`` object."""

    def __init__(self, annotate_device: bool = False) -> None:
        self.annotate_device = annotate_device
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._meta: Dict[str, Any] = {}
        self._epoch = time.perf_counter()
        self._pid = os.getpid()

    def _ts(self, t: float) -> float:
        return (t - self._epoch) * 1e6          # us, trace-relative

    def add_event(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def complete(self, name: str, t0: float, dur_s: float,
                 tid: Optional[int] = None, args: Optional[dict] = None,
                 cat: str = "host") -> None:
        """A finished span: began at monotonic ``t0``, ran ``dur_s``."""
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": self._ts(t0), "dur": dur_s * 1e6,
              "pid": self._pid,
              "tid": threading.get_ident() if tid is None else tid}
        if args:
            ev["args"] = args
        self.add_event(ev)

    def instant(self, name: str, args: Optional[dict] = None,
                cat: str = "host") -> None:
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "ts": self._ts(time.perf_counter()), "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self.add_event(ev)

    def counter(self, name: str, value: float) -> None:
        """One sample of a counter track (a gauge level over time)."""
        self.add_event({"name": name, "ph": "C",
                        "ts": self._ts(time.perf_counter()),
                        "pid": self._pid, "args": {"value": value}})

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def set_metadata(self, key: str, value: Any) -> None:
        """A top-level key of the exported object (the format ignores
        unknown keys; ``tools/trace_report.py`` reads ``siteCosts`` and
        ``devicePeaks``)."""
        with self._lock:
            self._meta[key] = value

    def to_json(self) -> Dict[str, Any]:
        obj: Dict[str, Any] = {"traceEvents": self.events(),
                               "displayTimeUnit": "ms"}
        with self._lock:
            obj.update(self._meta)
        return obj

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """The trace as a Chrome trace-event object, written to
        ``path`` when given."""
        obj = self.to_json()
        if path:
            with open(path, "w") as f:
                json.dump(obj, f)
        return obj


@contextmanager
def span(name: str, args: Optional[dict] = None):
    """``with span("rx.stream_chunk"): ...``: the block as one span in
    every active trace; under a trace built with
    ``annotate_device=True`` also a ``torch.profiler.record_function``
    range of the same name. Free when no trace is active."""
    traces = _TRACES
    if not traces:
        yield
        return
    ann = None
    if any(t.annotate_device for t in traces):
        import torch
        ann = torch.profiler.record_function(name)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        for t in traces:
            t.complete(name, t0, dur, args=args)


def _without_last(sinks: Tuple, x) -> Tuple:
    """``sinks`` minus its last occurrence of ``x`` (nested activations
    of one object stay balanced)."""
    for i in range(len(sinks) - 1, -1, -1):
        if sinks[i] is x:
            return sinks[:i] + sinks[i + 1:]
    return sinks


@contextmanager
def tracing(path: Optional[str] = None, annotate_device: bool = False,
            trace: Optional[Trace] = None):
    """Activate a :class:`Trace` (a fresh one, or ``trace``) for the
    block; on exit deactivate it and, with ``path``, export it there,
    also when the block raised."""
    global _TRACES
    t = trace if trace is not None else Trace(
        annotate_device=annotate_device)
    with _LOCK:
        _TRACES = _TRACES + (t,)
    try:
        yield t
    finally:
        with _LOCK:
            _TRACES = _without_last(_TRACES, t)
        if path:
            t.export(path)


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
            _REGISTRIES = _without_last(_REGISTRIES, r)


def env_trace_path() -> Optional[str]:
    """ZIRIA_TRACE (the CLI's ``--trace`` writes it for one
    invocation): a path means "trace this run and export the Chrome
    trace there"."""
    return os.environ.get("ZIRIA_TRACE") or None


def dispatch_event(label: str, n: int = 1,
                   seconds: Optional[float] = None) -> None:
    """One instrumented dispatch site firing: its counter, and a latency
    observation when the site is timed."""
    for r in _REGISTRIES:
        r.counter(DISPATCH_COUNTER, site=label).inc(n)
        if seconds is not None:
            r.histogram(DISPATCH_HISTOGRAM, site=label).observe(seconds)


def gauge_sample(label: str, value: float) -> None:
    """One level sample: a time-series point in every active registry
    and a counter-track event in every active trace."""
    if not (_TRACES or _REGISTRIES):
        return
    t = time.perf_counter()
    for r in _REGISTRIES:
        r.gauge(GAUGE_METRIC, site=label).set(value, t)
    for tr in _TRACES:
        tr.counter(label, value)


def observe(name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
    """One histogram observation into every active registry."""
    for r in _REGISTRIES:
        r.histogram(name, **(labels or {})).observe(value)


def count(name: str, n: int = 1, total: Optional[float] = None,
          labels: Optional[Dict[str, str]] = None) -> None:
    """An event counter into every active registry, one series per
    label set; with the caller's cumulative ``total``, also a
    counter-track sample in every active trace."""
    for r in _REGISTRIES:
        r.counter(name, **(labels or {})).inc(n)
    if total is not None:
        for tr in _TRACES:
            tr.counter(name, total)


def record_compile(label: str, seconds: Optional[float] = None,
                   n: int = 1, args: Optional[dict] = None) -> None:
    """A compile event: with ``seconds``, a span of the ``compile``
    category ending now; without, an instant marker carrying ``n``.
    Registries get the counter and, when timed, the latency
    histogram."""
    if not (_TRACES or _REGISTRIES):
        return
    now = time.perf_counter()
    for t in _TRACES:
        if seconds:
            t.complete(label, now - seconds, seconds, cat="compile",
                       args=args)
        else:
            a = dict(args or {})
            a.setdefault("count", n)
            t.instant(label, args=a, cat="compile")
    for r in _REGISTRIES:
        r.counter(COMPILE_COUNTER, event=label).inc(n)
        if seconds:
            r.histogram(COMPILE_HISTOGRAM, event=label).observe(seconds)
