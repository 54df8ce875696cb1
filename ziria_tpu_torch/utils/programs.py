"""The program observatory on ``torch.profiler``: where the card's time
goes, dispatch site by dispatch site (counterpart of
ziria_tpu/utils/programs.py: ``peaks_for`` :79, ``roofline`` :90,
``note_site`` :227, ``observing`` :241, ``cost_of`` :264, ``coverage``
:385, ``run_driver`` :417 and ``main``, the ``programs`` subcommand).

The reference lowers each jitted program and reads XLA's cost analysis.
Eager torch has no program to lower, so the port profiles the real run:

- **Profile.** :meth:`Observatory.profile` runs a block under
  ``torch.profiler`` (CPU activity, and CUDA on the card) with every
  ``dispatch.timed`` site and ``telemetry.span`` open as a
  ``record_function`` range. Each CUDA kernel, copy and memset goes to
  the innermost range open on the host thread when it was launched
  (through the launch's correlation id, else the external id of the op
  that launched it). Per site: launches, copies, device ms, host ms and
  calls (from the telemetry spans), and the top kernels by name with
  their share of the site's device time. For the whole window: the
  device's busy share (the union of its kernel, copy and memset
  intervals over the block's wall window) and idle share, both under
  the profiler, whose recording stretches the host's part of the
  window; ``--batch`` also sets the busy time against the block's
  unprofiled time.
- **Cost.** :func:`cost_of` runs one call: bytes are its tensor inputs
  read once and its tensor outputs written once (``PERF.md``'s
  convention); FLOPs come from ``torch.utils.flop_counter
  .FlopCounterMode``, which counts matrix products, convolutions and
  attention only, so elementwise arithmetic, reductions, scans,
  gathers, FFTs and the hand-written CUDA kernels count zero there.
  :func:`note_site` lets a site report its callable and argument
  shapes to an active observatory; :meth:`Observatory.analyze` costs
  each noted call of the driver on zero tensors of those shapes, and
  the report gives each its :func:`roofline` over its site's mean time
  a call.
- **Coverage.** :func:`discovered_sites` finds every string label that
  ``ziria_tpu_torch/`` passes to ``dispatch.timed``, ``dispatch.record``
  or a guarded dispatch, by an AST scan, so a site a later change adds
  shows up as uncovered until the driver reaches it.
- **Peaks.** :data:`DEVICE_PEAKS` holds the H100 SXM5 (NVIDIA's
  datasheet: HBM3 3.35 TB/s, FP32 67 TFLOP/s), keyed by
  ``torch.cuda.get_device_name()``; an unknown card gets absolute
  numbers and no percentages.

CLI: ``python -m ziria_tpu_torch programs [--json] [--platform cpu]
[--trace-dir DIR] [--batch]`` runs :func:`run_driver` (every dispatch
surface once at a tiny geometry) or, with ``--batch``, one 128-capture
``receive_many`` batch at full width (default and ``fused_demap``) and
one 128-frame ``decode_data_batch_fxp`` batch, each also timed
unprofiled, and prints the per-site table.
"""

from __future__ import annotations

import ast
import json
import os
import re
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ------------------------------------------------------------ device peaks

DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {"hbm_gbps": 3350.0, "peak_tflops": 67.0},
}

#: torch.cuda.get_device_name() spellings -> DEVICE_PEAKS key
_DEVICE_KIND_KEYS = {
    "nvidia h100 80gb hbm3": "h100",
    "h100": "h100",
}


def peaks_for(device_kind: Optional[str]) -> Optional[Dict[str, float]]:
    """The peak entry of a card name, or None for a card not in
    :data:`DEVICE_PEAKS` (its consumers then omit the percentages)."""
    if not device_kind:
        return None
    k = str(device_kind).strip().lower()
    key = _DEVICE_KIND_KEYS.get(k, k if k in DEVICE_PEAKS else None)
    return DEVICE_PEAKS.get(key) if key else None


def roofline(seconds: float, bytes_accessed: Optional[float] = None,
             flops: Optional[float] = None,
             device_kind: Optional[str] = None) -> Dict[str, float]:
    """Achieved GB/s and GFLOP/s of one call moving ``bytes_accessed``
    and doing ``flops`` in ``seconds``, with the share of the card's
    peak when it is in :data:`DEVICE_PEAKS`."""
    out: Dict[str, float] = {}
    if not seconds or seconds <= 0:
        return out
    peaks = peaks_for(device_kind)
    if bytes_accessed:
        gbps = bytes_accessed / seconds / 1e9
        out["achieved_gbps"] = round(gbps, 3)
        if peaks:
            out["pct_hbm_peak"] = round(100 * gbps / peaks["hbm_gbps"], 3)
    if flops:
        gflops = flops / seconds / 1e9
        out["achieved_gflops"] = round(gflops, 3)
        if peaks:
            out["pct_flops_peak"] = round(
                100 * gflops / 1e3 / peaks["peak_tflops"], 4)
    return out


# ------------------------------------------------------------------ cost


def _tensors(x) -> List:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def cost_of(fn: Any, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """One call of ``fn``: ``bytes_accessed`` (tensor inputs read once,
    tensor outputs written once), ``argument_bytes``, ``output_bytes``
    and ``flops`` as ``FlopCounterMode`` counts them (matrix products,
    convolutions, attention; nothing else)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    arg_b = _nbytes((args, kwargs))
    out_b = _nbytes(out)
    return {"flops": float(fc.get_total_flops()),
            "bytes_accessed": float(arg_b + out_b),
            "argument_bytes": float(arg_b), "output_bytes": float(out_b)}


def _skeleton(x: Any) -> Any:
    """Shape, dtype and device of every tensor in a call argument (the
    buffer is never held); anything else passes through."""
    import torch

    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return type(x)(_skeleton(e) for e in x)
    return x


def _zeros(sk: Any) -> Any:
    import torch

    if isinstance(sk, tuple) and len(sk) == 4 and sk[0] == "tensor":
        return torch.zeros(sk[1], dtype=sk[2], device=sk[3])
    if isinstance(sk, (tuple, list)):
        return type(sk)(_zeros(e) for e in sk)
    return sk


def _sig(args: Tuple, kwargs: Dict) -> str:
    def one(a):
        if isinstance(a, tuple) and len(a) == 4 and a[0] == "tensor":
            return f"{str(a[2]).replace('torch.', '')}{a[1]}"
        return repr(a)
    return ",".join([one(a) for a in args]
                    + [f"{k}={one(v)}" for k, v in sorted(kwargs.items())])


@dataclass
class ProgramNote:
    """A call a site reported: its callable and argument skeleton."""
    label: str
    fn: Any
    args: Tuple
    kwargs: Dict[str, Any]
    calls: int = 0


# ----------------------------------------------------- kernel attribution

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(anns: List[Dict], points: List[Tuple[float, int]]):
    """For each (time, index) point, the name of the innermost range of
    `anns` (one thread's properly nested ranges) open at that time."""
    anns = sorted(anns, key=lambda a: (a["ts"], -a["dur"]))
    out = {}
    stack: List[Dict] = []
    i = 0
    for t, idx in sorted(points):
        while i < len(anns) and anns[i]["ts"] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < anns[i]["ts"]:
                stack.pop()
            stack.append(anns[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out[idx] = stack[-1]["name"] if stack else None
    return out


def attribute(events: List[Dict], window: Optional[str] = None,
              top: int = 3) -> Dict[str, Any]:
    """Per-site device accounting of a Chrome trace of
    ``torch.profiler`` (its ``traceEvents``): every GPU event goes to
    the innermost ``user_annotation`` range open at its launch. With
    ``window`` (the name of a range around the whole block), the busy
    and idle share of the device over that range and the GPU work that
    ended after it."""
    cpu_by_corr: Dict[Any, Dict] = {}
    cpu_by_ext: Dict[Any, Dict] = {}
    anns: Dict[Any, List[Dict]] = {}
    gpu: List[Dict] = []
    win = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        a = ev.get("args") or {}
        if cat in GPU_CATS:
            gpu.append(ev)
            continue
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in a:
            cpu_by_corr[a["correlation"]] = ev
        if cat in ("cpu_op", "user_annotation") and "External id" in a:
            cpu_by_ext.setdefault(a["External id"], ev)
        if cat == "user_annotation":
            if window is not None and ev.get("name") == window:
                win = ev
                continue
            anns.setdefault(ev.get("tid"), []).append(
                {"name": ev["name"], "ts": float(ev["ts"]),
                 "dur": float(ev.get("dur", 0.0))})
    # each GPU event's launch point on the host: (thread, time)
    launch: Dict[int, Tuple[Any, float]] = {}
    for i, ev in enumerate(gpu):
        a = ev.get("args") or {}
        host = cpu_by_corr.get(a.get("correlation")) or \
            cpu_by_ext.get(a.get("External id"))
        if host is not None:
            launch[i] = (host.get("tid"), float(host["ts"]))
    site_of: Dict[int, Optional[str]] = {}
    for tid, rows in anns.items():
        pts = [(t, i) for i, (th, t) in launch.items() if th == tid]
        site_of.update(_innermost(rows, pts))
    sites: Dict[str, Dict[str, Any]] = {}
    for i, ev in enumerate(gpu):
        name = site_of.get(i) or ("(no site)" if i in launch
                                  else "(unattributed)")
        s = sites.setdefault(name, {"launches": 0, "copies": 0,
                                    "device_ms": 0.0, "_k": {}})
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        s["device_ms"] += dur_ms
        if ev.get("cat") == "kernel":
            s["launches"] += 1
        else:
            s["copies"] += 1
        s["_k"][ev["name"]] = s["_k"].get(ev["name"], 0.0) + dur_ms
    for s in sites.values():
        ks = sorted(s.pop("_k").items(), key=lambda kv: -kv[1])[:top]
        tot = s["device_ms"] or 1e-12
        s["top_kernels"] = [{"name": k, "ms": v, "share": v / tot}
                            for k, v in ks]
    out: Dict[str, Any] = {
        "sites": sites,
        "kernels": sum(1 for ev in gpu if ev.get("cat") == "kernel"),
        "gpu_events": len(gpu),
        "kernel_names": _count_names(gpu),
    }
    if win is not None:
        w0 = float(win["ts"])
        w1 = max([w0 + float(win.get("dur", 0.0))]
                 + [float(ev["ts"]) + float(ev.get("dur", 0.0))
                    for ev in gpu])
        busy = _union([(float(ev["ts"]), float(ev["ts"])
                        + float(ev.get("dur", 0.0))) for ev in gpu],
                      w0, w1)
        wall = max(w1 - w0, 1e-9)
        out.update(window_ms=wall / 1e3, busy_ms=busy / 1e3,
                   busy_share=busy / wall, idle_share=1.0 - busy / wall)
    return out


def _count_names(gpu: List[Dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ev in gpu:
        if ev.get("cat") == "kernel":
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def _union(iv: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(iv):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def kernel_count(report: Dict[str, Any], pattern: str,
                 exclude: Optional[str] = None) -> int:
    """Kernel launches of a profile whose name matches the regular
    expression ``pattern`` (and not ``exclude``)."""
    return sum(n for k, n in report.get("kernel_names", {}).items()
               if re.search(pattern, k)
               and not (exclude and re.search(exclude, k)))


# ------------------------------------------------------------ observatory

WINDOW = "programs.window"


class Observatory:
    """Notes calls while active (:func:`observing`, :func:`note_site`)
    and profiles blocks (:meth:`profile`); each profile's report lands
    in ``profiles`` under its name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.notes: Dict[Tuple[str, str], ProgramNote] = {}
        self.profiles: Dict[str, Dict[str, Any]] = {}

    def _note(self, label: str, fn: Any, args: Tuple,
              kwargs: Dict[str, Any]) -> None:
        key = (label, _sig(args, kwargs))
        with self._lock:
            n = self.notes.get(key)
            if n is None:
                n = self.notes[key] = ProgramNote(label, fn, args, kwargs)
            n.calls += 1

    def analyze(self) -> List[Dict[str, Any]]:
        """One cost record per noted (site, argument shapes): the call
        run again on zero tensors of those shapes under :func:`cost_of`.
        A call that fails yields an ``error`` record."""
        out = []
        for (label, sig), n in sorted(self.notes.items(),
                                      key=lambda kv: kv[0]):
            rec: Dict[str, Any] = {"label": label, "in_shapes": sig,
                                   "calls": n.calls}
            try:
                rec.update(cost_of(n.fn, *_zeros(n.args),
                                   **{k: _zeros(v)
                                      for k, v in n.kwargs.items()}))
            except Exception as e:      # noqa: BLE001 - reported
                rec["error"] = repr(e)
            out.append(rec)
        return out

    @contextmanager
    def profile(self, name: str, device="cuda",
                trace_dir: Optional[str] = None):
        """Run the block under ``torch.profiler`` (CUDA activity on a
        CUDA ``device``), every site a ``record_function`` range; on
        exit attribute its GPU events (:func:`attribute`) and its host
        spans, into ``self.profiles[name]``, with the kernel wrappers'
        launch counters' delta over the block (``launch_counters``).
        With ``trace_dir`` the profiler's Chrome trace is kept there as
        ``<name>.pt.trace.json``."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ziria_tpu_torch.ops import viterbi_cuda, viterbi_fused
        from ziria_tpu_torch.utils import telemetry

        def launches():
            return {**viterbi_cuda.LAUNCHES, **viterbi_fused.LAUNCHES}

        dev = torch.device(device)
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(dev)
        before = launches()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof, \
                telemetry.tracing(annotate_device=True) as tr:
            with torch.profiler.record_function(WINDOW):
                yield self
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        after = launches()
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"{name}.pt.trace.json")
        else:
            fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
            os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            if not trace_dir:
                os.unlink(path)
        rep = attribute(events, window=WINDOW)
        host: Dict[str, Dict[str, float]] = {}
        for ev in tr.events():
            if ev.get("ph") == "X" and ev.get("cat") == "host":
                h = host.setdefault(ev["name"], {"calls": 0, "host_ms": 0.0})
                h["calls"] += 1
                h["host_ms"] += ev["dur"] / 1e3
        for label, h in host.items():
            rep["sites"].setdefault(label, {"launches": 0, "copies": 0,
                                            "device_ms": 0.0,
                                            "top_kernels": []}).update(h)
        rep["wall_ms"] = wall * 1e3
        rep["device"] = str(dev)
        rep["launch_counters"] = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        if trace_dir:
            rep["trace_path"] = path
        self.profiles[name] = rep


_LOCK = threading.Lock()
_ACTIVE: Tuple[Observatory, ...] = ()


def note_site(label: str, fn: Any, *args: Any, **kwargs: Any) -> None:
    """Report a site's callable and call shapes to every active
    observatory (shapes only, never the buffers). Free when none is
    active: one truthiness check."""
    if not _ACTIVE:
        return
    sk = tuple(_skeleton(a) for a in args)
    kw = {k: _skeleton(v) for k, v in kwargs.items()}
    for o in _ACTIVE:
        o._note(label, fn, sk, kw)


@contextmanager
def observing():
    """Activate a new :class:`Observatory` for the block; yields it."""
    global _ACTIVE
    o = Observatory()
    with _LOCK:
        _ACTIVE = _ACTIVE + (o,)
    try:
        yield o
    finally:
        with _LOCK:
            lst = list(_ACTIVE)
            for i in range(len(lst) - 1, -1, -1):
                if lst[i] is o:
                    del lst[i]
                    break
            _ACTIVE = tuple(lst)


# ------------------------------------------------------- site discovery

#: callees whose string-literal arguments name a dispatch site
SITE_CALLS = ("timed", "record", "guarded", "_guarded_decode")
_LABEL = re.compile(r"^[a-z_][a-z0-9_]*(\.[a-z0-9_]+)+$")


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def discovered_sites(root: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every dispatch-site label under ``root`` (default: this
    package): a string literal shaped ``module.name`` passed to a call
    of ``timed``, ``record``, ``guarded`` or ``_guarded_decode``."""
    root = root or _package_root()
    out: List[Dict[str, Any]] = []
    seen = set()
    for d, _dirs, files in sorted(os.walk(root)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(d, fname)
            try:
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else \
                    fn.attr if isinstance(fn, ast.Attribute) else None
                if name not in SITE_CALLS:
                    continue
                for a in node.args:
                    if isinstance(a, ast.Constant) and isinstance(
                            a.value, str) and _LABEL.match(a.value) \
                            and a.value not in seen:
                        seen.add(a.value)
                        out.append({"label": a.value,
                                    "file": os.path.relpath(
                                        path, os.path.dirname(root)),
                                    "line": node.lineno})
    return out


def coverage(seen_labels, sites: Optional[List[Dict]] = None
             ) -> Dict[str, List[str]]:
    """``{"covered", "uncovered", "undiscovered"}``: the discovered
    labels the run reached, those it did not (a blind spot of the
    driver, not an error) and labels it reached that the scan missed."""
    sites = discovered_sites() if sites is None else sites
    seen = set(seen_labels)
    labels = [s["label"] for s in sites]
    return {"covered": sorted(lb for lb in labels if lb in seen),
            "uncovered": sorted(lb for lb in labels if lb not in seen),
            "undiscovered": sorted(seen - set(labels))}


# ---------------------------------------------------------------- drivers


def run_driver(device="cuda") -> None:
    """Every dispatch surface once at a tiny geometry: per-capture and
    batched receive, the staged and fused link, the channel, the BER
    paths, a stream (and its degraded twin under an injected fatal
    fault), a fleet (and its degraded twin), and the fixed-point
    batch."""
    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.phy import channel, link
    from ziria_tpu_torch.phy.wifi import rx, rx_fxp, tx
    from ziria_tpu_torch.phy.wifi.params import RATES, n_symbols
    from ziria_tpu_torch.utils import faults

    rng = np.random.default_rng(23)
    n_bytes = 12
    rates = [6, 54]
    psdus = [rng.integers(0, 256, n_bytes).astype(np.uint8)
             for _ in rates]
    caps = [np.concatenate(
        [np.zeros((50, 2), np.float32),
         tx.encode_frame(p, m, add_fcs=True, device=device).cpu().numpy()])
        for p, m in zip(psdus, rates)]
    rx.receive(caps[0], device=device)
    framebatch.receive_many(caps, check_fcs=True, device=device)
    kw = dict(snr_db=30.0, cfo=1e-4, delay=12, seed=5, add_fcs=True,
              check_fcs=True, device=device)
    link.loopback_many(psdus, rates, fused=False, batched_tx=True, **kw)
    link.loopback_many(psdus, rates, fused=True, **kw)
    channel.impair_one(caps[0], 30.0, 1e-4, 3, 7, 0, out_len=1024,
                       device=device)
    pb = np.stack(psdus)
    link.loopback_ber_bits(pb, rates[0], 8.0, 7, device=device)
    link.sweep_ber(pb, (rates[0],), (8.0,), (7,), device=device)
    # ziria: lint-ignore[R6] the reference serve test's stream geometry, profiled as that test runs it, not a tuned surface
    geo = dict(chunk_len=4096, frame_len=1024, max_frames_per_chunk=8,
               check_fcs=True, device=device)
    stream, _starts = link.stream_many(
        psdus, rates, snr_db=30.0, cfo=1e-4, delay=60, seed=8,
        add_fcs=True, tail=1024, device=device)
    streams, _st = link.stream_many_multi(
        [psdus[:1], psdus[1:]], [rates[:1], rates[1:]], snr_db=30.0,
        cfo=1e-4, delay=60, seed=9, add_fcs=True, tail=1024,
        device=device)
    framebatch.receive_stream(stream, streaming=True, **geo)
    framebatch.receive_streams(streams, multi=True, **geo)
    # the degraded scans: an injected fatal fault at each scan site
    with faults.inject(
            faults.FaultSpec("rx.stream_chunk", "fatal", calls=(0,)),
            faults.FaultSpec("rx.stream_chunk_multi", "fatal",
                             calls=(0,))):
        framebatch.receive_stream(stream, streaming=True, **geo)
        framebatch.receive_streams(streams, multi=True, **geo)
    # the fixed-point batch: two aligned frames at 54 Mbit/s
    rate = RATES[54]
    n_sym = n_symbols(n_bytes, rate)
    frames = tx.encode_batch(pb, 54, device=device)
    rx_fxp.decode_data_batch_fxp(rx_fxp.quantize_frame(frames), rate,
                                 n_sym, 8 * n_bytes)


#: the --batch geometry: chip_smoke.py's end-to-end batch
BATCH, BATCH_BYTES, BATCH_SNR_DB = 128, 1000, 25.0
FXP_MBPS, FXP_SNR_DB = 54, 30.0
BATCH_SEED = 20261016
#: unprofiled timed calls of each --batch block (the median is kept)
UNPROFILED_REPS = 3


def batch_captures(rng, device) -> List[np.ndarray]:
    """BATCH captures, BATCH / 8 a rate, each a BATCH_BYTES PSDU (FCS
    included) behind a random offset, with a random CFO and complex AWGN
    at BATCH_SNR_DB."""
    from ziria_tpu_torch.phy.wifi import params, tx

    sigma = np.sqrt(10 ** (-BATCH_SNR_DB / 10) / 2)
    caps = []
    for k in range(BATCH):
        m = params.RATE_MBPS_ORDER[k % 8]
        body = rng.integers(0, 256, BATCH_BYTES - 4).astype(np.uint8)
        s = tx.encode_frame(body, m, add_fcs=True, device=device)
        s = s.cpu().numpy()
        off = int(rng.integers(16, 4000))
        eps = float(rng.uniform(-0.01, 0.01))
        z = np.zeros(off + s.shape[0] + 200, np.complex128)
        z[off:off + s.shape[0]] = s[:, 0] + 1j * s[:, 1]
        z *= np.exp(1j * eps * np.arange(z.size))
        z += sigma * (rng.normal(size=z.size) + 1j * rng.normal(size=z.size))
        caps.append(np.stack([z.real, z.imag], -1).astype(np.float32))
    return caps


def fxp_batch(rng, device):
    """BATCH aligned Q11 frames of a BATCH_BYTES PSDU at FXP_MBPS with
    AWGN at FXP_SNR_DB: (frames, rate, n_sym, PSDU bits)."""
    import torch

    from ziria_tpu_torch.phy.wifi import rx_fxp, tx
    from ziria_tpu_torch.phy.wifi.params import RATES, n_symbols

    rate = RATES[FXP_MBPS]
    n_sym = n_symbols(BATCH_BYTES, rate)
    psdus = rng.integers(0, 256, (BATCH, BATCH_BYTES)).astype(np.uint8)
    frames = tx.encode_batch(psdus, FXP_MBPS, device=device).cpu().numpy()
    sigma = np.sqrt(10 ** (-FXP_SNR_DB / 10) / 2)
    frames += (sigma * rng.normal(size=frames.shape)).astype(np.float32)
    q = rx_fxp.quantize_frame(torch.from_numpy(frames).to(device))
    return q, rate, n_sym, np.unpackbits(psdus, axis=1, bitorder="little")


def _unprofiled_ms(fn, device) -> float:
    """Median host-clock ms of UNPROFILED_REPS calls of ``fn``, each
    synchronized before and after on a CUDA ``device``."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    ms = []
    for _ in range(UNPROFILED_REPS):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def profile_batches(obs: Observatory, device,
                    trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """Profile the --batch blocks into ``obs``: ``receive_many`` on the
    BATCH captures (default and ``fused_demap``) and the fixed-point
    batch, each after one unprofiled warm-up call. The profiler's
    recording slows the host, so each block is also timed unprofiled
    (:func:`_unprofiled_ms`) and its profile gains ``unprofiled_ms``,
    ``window_over_unprofiled`` and ``idle_share_unprofiled``: one minus
    the device's busy ms under the profiler over the unprofiled ms.
    Returns each block's PSDUs-right count."""
    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.phy.wifi import rx_fxp

    rng = np.random.default_rng(BATCH_SEED)
    caps = batch_captures(rng, device)
    q, rate, n_sym, bits = fxp_batch(rng, device)
    runs = {
        "receive_many": lambda: framebatch.receive_many(
            caps, check_fcs=True, device=device),
        "receive_many_fused": lambda: framebatch.receive_many(
            caps, check_fcs=True, fused_demap=True, device=device),
        "fxp_batch": lambda: rx_fxp.decode_data_batch_fxp(
            q, rate, n_sym, 8 * BATCH_BYTES),
    }
    right = {}
    for name, fn in runs.items():
        fn()
        plain_ms = _unprofiled_ms(fn, device)
        with obs.profile(name, device, trace_dir):
            out = fn()
        pr = obs.profiles[name]
        pr.update(unprofiled_ms=plain_ms,
                  window_over_unprofiled=pr["window_ms"] / plain_ms,
                  idle_share_unprofiled=max(
                      0.0, 1.0 - pr["busy_ms"] / plain_ms))
        if name == "fxp_batch":
            right[name] = int((out[0].cpu().numpy() == bits).all(1).sum())
        else:
            right[name] = sum(bool(r.ok and r.crc_ok) for r in out)
    return right


def collect_programs(device="cuda", batch: bool = False,
                     trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """The one-call sweep: the driver (or the --batch blocks) under an
    observatory, each profile attributed, and the sites the run reached
    against the discovered ones. The driver's noted calls are costed
    (``costs``); the --batch blocks' are not, since costing reruns each
    on zero tensors of the full-width shapes."""
    import torch

    from ziria_tpu_torch.utils import dispatch

    dev = torch.device(device)
    with observing() as obs, dispatch.count_dispatches() as d:
        if batch:
            right = profile_batches(obs, dev, trace_dir=trace_dir)
        else:
            right = None
            with obs.profile("driver", dev, trace_dir):
                run_driver(device=dev)
    sites = discovered_sites()
    cov = coverage(d.counts, sites)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    costs = [] if batch else obs.analyze()
    for c in costs:
        c["roofline"] = _cost_roofline(c, obs.profiles["driver"], kind)
    report = {
        "device": str(dev), "device_kind": kind,
        "devicePeaks": peaks_for(kind),
        "profiles": obs.profiles, "costs": costs,
        "dispatch_counts": dict(d.counts),
        "sites_discovered": len(sites),
        "sites_covered": len(cov["covered"]),
        "uncovered": cov["uncovered"],
        "undiscovered": cov["undiscovered"],
        "device_peaks": DEVICE_PEAKS,
    }
    if right is not None:
        report["right"] = right
    return report


def _cost_roofline(cost: Dict[str, Any], prof: Dict[str, Any],
                   kind: Optional[str]) -> Dict[str, float]:
    """:func:`roofline` of a noted call over its site's mean time a call
    in the profile: device ms on the card, host ms on the CPU."""
    s = prof["sites"].get(cost["label"], {})
    calls = s.get("calls", 0)
    if "error" in cost or not calls:
        return {}
    ms = s["device_ms"] if kind else s.get("host_ms", 0.0)
    return roofline(ms / calls / 1e3, cost["bytes_accessed"],
                    cost["flops"], kind)


def _format_table(report: Dict[str, Any]) -> str:
    lines = []
    for name, rep in report["profiles"].items():
        share = rep.get("busy_share")
        lines.append(
            f"== {name}: wall {rep['wall_ms']:.3f} ms"
            + (f", device busy {100 * share:.1f}% idle "
               f"{100 * rep['idle_share']:.1f}% under the profiler"
               if share is not None else "")
            + (f"; unprofiled {rep['unprofiled_ms']:.3f} ms, idle "
               f"{100 * rep['idle_share_unprofiled']:.1f}%"
               if "unprofiled_ms" in rep else "")
            + f", {rep['kernels']} kernels")
        lines.append(f"{'site':<34} {'calls':>6} {'host_ms':>10} "
                     f"{'launches':>8} {'device_ms':>10}  top kernel")
        for label, s in sorted(rep["sites"].items(),
                               key=lambda kv: -kv[1]["device_ms"]):
            top = s["top_kernels"][0]["name"][:48] if s["top_kernels"] \
                else ""
            lines.append(f"{label:<34} {s.get('calls', 0):>6} "
                         f"{s.get('host_ms', 0.0):>10.3f} "
                         f"{s['launches']:>8} {s['device_ms']:>10.3f}  {top}")
    for c in report["costs"]:
        r = c.get("roofline", {})
        lines.append(
            f"cost {c['label']} x{c['calls']}: "
            + (c["error"] if "error" in c else
               f"{c['bytes_accessed']:.0f} B, {c['flops']:.0f} FLOP"
               + "".join(f", {k} {v}" for k, v in r.items())))
    lines.append(f"{report['sites_covered']}/{report['sites_discovered']} "
                 f"dispatch sites covered"
                 + (f"; uncovered: {', '.join(report['uncovered'])}"
                    if report["uncovered"] else ""))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m ziria_tpu_torch programs``: the driver (or the
    --batch blocks) under ``torch.profiler``, printed as a per-site
    table or, with --json, one JSON report."""
    import argparse

    p = argparse.ArgumentParser(
        prog="ziria_tpu_torch programs",
        description="program observatory: per-site launches, device and "
                    "host time under torch.profiler")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the CPU; with no card it "
                        "raises unless --platform=cpu is given")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="keep each profile's torch.profiler Chrome trace "
                        "under DIR")
    p.add_argument("--batch", action="store_true",
                   help="profile one 128-capture receive_many batch at "
                        "full width (default and fused_demap) and the "
                        "128-frame decode_data_batch_fxp batch in place "
                        "of the driver")
    args = p.parse_args(argv)
    from ziria_tpu_torch.phy.wifi.rx import check_device
    dev = check_device(args.platform, "programs --platform")
    report = collect_programs(dev, batch=args.batch,
                              trace_dir=args.trace_dir)
    print(json.dumps(report, default=str) if args.json
          else _format_table(report))
    return 0
