"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read. The arithmetic is copied from the port's
``utils/programs.attribute`` at commit 33779fc (busy time as the union of
kernel, copy and memset intervals; each device event attributed to the
annotation ranges open on its host thread at its launch), extended to
keep every enclosing range, not only the innermost, and to label the
device's idle gaps by the host range open across them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(iv):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _merged(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """One profiled window: ``events`` are the Chrome trace's
    ``traceEvents``; ``window`` the name of the annotation range around
    the whole window. Times are microseconds."""

    def __init__(self, events: List[Dict], window: str):
        self.gpu: List[Dict] = []
        self.ranges: Dict[object, List[Dict]] = {}
        by_corr: Dict[object, Dict] = {}
        by_ext: Dict[object, Dict] = {}
        self.win = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            a = ev.get("args") or {}
            if cat in GPU_CATS:
                self.gpu.append(ev)
                continue
            if cat in ("cuda_runtime", "cuda_driver") and "correlation" in a:
                by_corr[a["correlation"]] = ev
            if cat in ("cpu_op", "user_annotation") and "External id" in a:
                by_ext.setdefault(a["External id"], ev)
            if cat == "user_annotation":
                if ev.get("name") == window:
                    self.win = ev
                    continue
                self.ranges.setdefault(ev.get("tid"), []).append(
                    {"name": ev["name"], "ts": float(ev["ts"]),
                     "end": float(ev["ts"]) + float(ev.get("dur", 0.0))})
        # each device event's launch point on the host
        self.launch: Dict[int, Tuple[object, float]] = {}
        for i, ev in enumerate(self.gpu):
            a = ev.get("args") or {}
            host = by_corr.get(a.get("correlation")) or \
                by_ext.get(a.get("External id"))
            if host is not None:
                self.launch[i] = (host.get("tid"), float(host["ts"]))
        if self.win is not None:
            self.w0 = float(self.win["ts"])
            self.w1 = max([self.w0 + float(self.win.get("dur", 0.0))]
                          + [self._end(ev) for ev in self.gpu])
        else:
            self.w0 = min([float(ev["ts"]) for ev in self.gpu] or [0.0])
            self.w1 = max([self._end(ev) for ev in self.gpu] or [0.0])

    @staticmethod
    def _end(ev) -> float:
        return float(ev["ts"]) + float(ev.get("dur", 0.0))

    # ----------------------------------------------------------- windows

    @property
    def window_s(self) -> float:
        return max(self.w1 - self.w0, 0.0) / 1e6

    @property
    def busy_s(self) -> float:
        return _union([(float(ev["ts"]), self._end(ev)) for ev in self.gpu],
                      self.w0, self.w1) / 1e6

    def device_events(self) -> int:
        """Kernels, copies and memsets in the window."""
        return len(self.gpu)

    # ------------------------------------------------------- attribution

    def enclosing(self, i: int) -> List[str]:
        """Names of the host ranges open at device event i's launch."""
        if i not in self.launch:
            return []
        tid, t = self.launch[i]
        return [r["name"] for r in self.ranges.get(tid, [])
                if r["ts"] <= t <= r["end"]]

    def device_s_under(self, span: str) -> float:
        """Device seconds of the events launched inside a range named
        `span` (at any depth)."""
        return sum(float(ev.get("dur", 0.0)) for i, ev in enumerate(self.gpu)
                   if span in self.enclosing(i)) / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(float(ev.get("dur", 0.0)) for ev in self.gpu
                   if ev.get("cat") == "kernel" and rx.search(ev["name"])) \
            / 1e6

    # --------------------------------------------------------- breakdown

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time: [name, seconds]."""
        tot: Dict[str, float] = {}
        for ev in self.gpu:
            tot[ev["name"]] = tot.get(ev["name"], 0.0) \
                + float(ev.get("dur", 0.0)) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps of the device in the window, each named
        by the innermost host range open across its middle (summed by
        name): [name, seconds]."""
        busy = _merged([(max(float(ev["ts"]), self.w0),
                         min(self._end(ev), self.w1)) for ev in self.gpu])
        gaps, t = [], self.w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        tot: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [r for rs in self.ranges.values() for r in rs
                     if r["ts"] <= mid <= r["end"]]
            name = min(open_, key=lambda r: r["end"] - r["ts"])["name"] \
                if open_ else "(no host range)"
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


def window_trace(events: List[Dict], window: str) -> Optional[Trace]:
    t = Trace(events, window)
    return t if t.gpu else None
