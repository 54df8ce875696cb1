"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration (``benchmark/configs/<config>.json``) names the entry that
drives the port (``benchmark/entries/<entry>.py``); its traffic mix is a
data file (``benchmark/traffic/<traffic>.json``) read by the one
generator; each per-layer metric is a reader of its own
(``benchmark/metrics/<metric>.py``). All are found by name, so a new
configuration, mix, entry or metric is a new file and a new entry in
``BENCHMARK.json``.

A run: builds or loads the port's kernel library (in the checkout's
``ziria_tpu_torch/csrc/build/``), makes the traffic from ``--seed``,
warms the cell's own shapes (all of this is ``setup_s``, from process
start), then calls the entry in a closed loop for ``--seconds``. With
``--trace 1`` it then runs a few more calls under ``torch.profiler``,
with the port's spans as profiler ranges, and reports the per-layer
metrics; with ``--trace 0`` the end-to-end ones. After the window the
port's state is freed and its answers are compared (``benchmark/check``).
The last lines of standard error give each number compared with its
limit; the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ziria_tpu")
WINDOW = "bench.window"
PROFILED_CALLS = {"batch": 4, "step": 8}


def process_start() -> float:
    """Wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = process_start()


def load_file(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, by file name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(spec: dict, workload: str):
    """(workload entry, configuration file, traffic mix) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"run.py: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    return wl, load_json(ROOT, cfg["file"]), \
        load_json(HERE, "traffic", f"{wl['traffic']}.json")


def metrics_of(spec: dict, workload: str, trace: bool):
    """The metric entries this cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def percentile(xs, q: float) -> float:
    """The q-th percentile (0-100) of xs, linear between ranks."""
    s = sorted(xs)
    k = (len(s) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


class Context:
    """What a per-layer metric reader reads: the traced calls' profiler
    trace, the port's dispatch counts over the measured window and over
    the traced calls, and the entry with its calls."""

    def __init__(self, entry, window_calls, traced_calls, window_counts,
                 traced_counts, trace):
        self.entry = entry
        self.window_calls = window_calls
        self.traced_calls = traced_calls
        self.window_counts = window_counts
        self.traced_counts = traced_counts
        self.trace = trace


def profiled(entry, n: int, device):
    """n calls under torch.profiler, the port's spans as ranges."""
    import torch
    from ziria_tpu_torch.utils import dispatch, telemetry

    from benchmark.trace import window_trace

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    first = len(entry.calls)
    with torch.profiler.profile(activities=acts) as prof, \
            telemetry.tracing(annotate_device=True), \
            dispatch.count_dispatches() as counts:
        with torch.profiler.record_function(WINDOW):
            for _ in range(n):
                with torch.profiler.record_function("bench.call"):
                    entry.call()
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return entry.calls[first:], counts, window_trace(events, WINDOW)


def run(args, device="cuda", require_card=True, overrides=None):
    """One run; returns (result line, compared numbers, the window's
    calls, seconds and set-up marks). `overrides`
    (tests): {"config": {...}, "mix": {...}} merged over the files."""
    # every kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    import torch

    spec = load_json(ROOT, "BENCHMARK.json")
    wl, cfg, mix = cell(spec, args.workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < wl["chips"]):
        raise SystemExit(
            f"run.py: {args.workload} needs {wl['chips']} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = {"torch_imported": time.time() - T_START}
    if on_card:
        torch.cuda.init()
        marks["cuda_ready"] = time.time() - T_START
        from ziria_tpu_torch import cuda_build
        cuda_build.build_all()
        marks["kernels_loaded"] = time.time() - T_START
    entry = load_file("entries", cfg["entry"]).Entry(cfg, mix, args.seed, dev)
    marks["traffic_made"] = time.time() - T_START
    entry.warm()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - T_START
    marks["warm"] = setup_s

    from ziria_tpu_torch.utils import dispatch

    first = len(entry.calls)
    work = 0
    with dispatch.count_dispatches() as window_counts:
        t0 = time.perf_counter()
        while True:
            work += entry.call()
            if time.perf_counter() - t0 >= args.seconds:
                break
        if not args.trace:
            work += entry.close()
        t1 = time.perf_counter()
    window_calls = entry.calls[first:]
    traced_calls = traced_counts = trace = None
    if args.trace:
        n = PROFILED_CALLS[entry.unit]
        traced_calls, traced_counts, trace = profiled(entry, n, dev) \
            if on_card else (entry.calls[-n:], window_counts, None)
        entry.close()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    metrics = {}
    wanted = metrics_of(spec, args.workload, bool(args.trace))
    if args.trace:
        ctx = Context(entry, window_calls, traced_calls, window_counts,
                      traced_counts, trace)
        for m in wanted:
            v = load_file("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  "rx_samples_per_s": work / (t1 - t0)}
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    entry.release()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    verdict = entry.check()

    from benchmark import check
    numbers = verdict["numbers"]
    result = {
        "correct": check.verdict(numbers),
        "attempted": verdict["attempted"],
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": peak,
                   "power_limit": power_limit() if on_card else None},
    }
    ms = sorted((c["t1"] - c["t0"]) * 1e3 for c in window_calls)
    window = {"calls": len(window_calls), "seconds": t1 - t0,
              "unit": entry.unit, "setup_marks_s": marks,
              "call_ms_quartiles": [ms[len(ms) // 4], ms[len(ms) // 2],
                                    ms[3 * len(ms) // 4]]}
    if args.trace and trace is not None:
        result["device"].update(busy_s=trace.busy_s,
                                window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_gaps(10)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in numbers}
    return result, numbers, window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(ROOT, "BENCHMARK.json")) or \
            not os.path.isdir(os.path.join(ROOT, "ziria_tpu_torch")):
        print("run.py: the checkout has no port (ziria_tpu_torch/) beside "
              "BENCHMARK.json", file=sys.stderr)
        return 2
    result, numbers, window = run(args)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found} (the JAX package or "
              f"JAX); no result", file=sys.stderr)
        return 3
    print(f"window: {json.dumps(window)}", file=sys.stderr)
    for n, v, lim in numbers:
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT    # the checkout, not benchmark/: no module shadowing
    sys.exit(main())
