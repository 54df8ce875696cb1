"""The port's program observatory (``utils/programs``) on the CPU: the
driver reaches every discovered dispatch site, ``roofline`` and
``peaks_for`` keep the reference's arithmetic with the H100 row, the
kernel attribution of a ``torch.profiler`` Chrome trace (the card's
event kinds, built by hand since the CPU has none), a profiled block's
host spans and noted costs, and the ``programs`` subcommand.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.utils import programs as R_programs
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import tx
from ziria_tpu_torch.runtime import cli
from ziria_tpu_torch.utils import dispatch, programs

H100 = "NVIDIA H100 80GB HBM3"


def test_driver_covers_every_discovered_site():
    sites = programs.discovered_sites()
    labels = [s["label"] for s in sites]
    assert len(labels) == len(set(labels))
    for lb in ("rx.acquire_many", "rx.stream_chunk", "rx.stream_decode",
               "link.fused", "link.sweep", "execute.scan_bulk",
               "hybrid.device_block", "externals.viterbi_windowed"):
        assert lb in labels, lb
    with dispatch.count_dispatches() as d:
        programs.run_driver("cpu")
    cov = programs.coverage(d.counts, sites)
    assert cov["undiscovered"] == []
    # the compiler's sites run under the CLI (test_torch_compiler_*,
    # test_torch_chunked, test_torch_framebatch_many)
    assert cov["uncovered"] == ["chunked.replay", "chunked.step",
                                "execute.scan_bulk",
                                "execute.scan_rem",
                                "externals.viterbi_scan",
                                "externals.viterbi_windowed",
                                "framebatch.step", "hybrid.device_block"]


def test_roofline_and_peaks_keep_the_reference_arithmetic(monkeypatch):
    assert programs.peaks_for(H100) == {"hbm_gbps": 3350.0,
                                        "peak_tflops": 67.0}
    assert programs.peaks_for("  nvidia h100 80gb hbm3 ") is not None
    for kind in (None, "", "v5e", "NVIDIA A100-SXM4-80GB"):
        assert programs.peaks_for(kind) is None, kind
    monkeypatch.setattr(R_programs, "DEVICE_PEAKS",
                        dict(programs.DEVICE_PEAKS))
    monkeypatch.setattr(R_programs, "_DEVICE_KIND_KEYS",
                        dict(programs._DEVICE_KIND_KEYS))
    for args in ((1e-3, 3.35e9, 67e9), (2.5e-4, 1e6, None),
                 (0.0, 1e6, 1e6), (1e-3, None, 5e12), (1e-2, 0, 0)):
        for kind in (H100, None, "v5e"):
            assert programs.roofline(*args, device_kind=kind) == \
                R_programs.roofline(*args, device_kind=kind), (args, kind)
    full = programs.roofline(1e-3, 3.35e9, 67e9, H100)
    assert full["pct_hbm_peak"] == 100.0 and full["pct_flops_peak"] == 100.0


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def test_attribution_of_a_profiler_trace():
    """Kernels go to the innermost site range open at their launch, by
    correlation id or else by the external id of the op that launched
    them; the busy share is the union of GPU intervals over the
    window."""
    evs = [
        _ev(programs.WINDOW, "user_annotation", 0, 1000),
        _ev("rx.acquire_many", "user_annotation", 10, 400),
        _ev("sync.fir_valid", "user_annotation", 20, 100),
        _ev("aten::mul", "cpu_op", 30, 10, **{"External id": 7}),
        _ev("cudaLaunchKernel", "cuda_runtime", 31, 2, correlation=70),
        _ev("cudaLaunchKernel", "cuda_runtime", 200, 2, correlation=71),
        _ev("rx.decode_mixed", "user_annotation", 500, 300, tid=2,
            **{"External id": 9}),
        _ev("cudaLaunchKernel", "cuda_runtime", 510, 2, tid=2,
            correlation=72),
        _ev("cudaMemcpyAsync", "cuda_runtime", 900, 2, correlation=73),
        # GPU side: two overlapping kernels, one by external id only
        _ev("mul_kernel", "kernel", 100, 50, tid=7, correlation=70),
        _ev("sum_kernel", "kernel", 140, 30, tid=7, correlation=71),
        _ev("acs_kernel<0, 2>", "kernel", 600, 200, tid=7,
            **{"External id": 9}),
        _ev("traceback_kernel<float>", "kernel", 805, 100, tid=7,
            correlation=72),
        _ev("Memcpy DtoH", "gpu_memcpy", 950, 100, tid=8, correlation=73),
        _ev("stray", "kernel", 990, 5, tid=7, correlation=99),
    ]
    rep = programs.attribute(evs, window=programs.WINDOW)
    s = rep["sites"]
    assert s["sync.fir_valid"]["launches"] == 1
    assert s["sync.fir_valid"]["device_ms"] == pytest.approx(0.05)
    assert s["rx.acquire_many"]["launches"] == 1       # sum_kernel
    assert s["rx.decode_mixed"]["launches"] == 2
    assert s["rx.decode_mixed"]["top_kernels"][0]["name"] == \
        "acs_kernel<0, 2>"
    assert s["rx.decode_mixed"]["top_kernels"][0]["share"] == \
        pytest.approx(2 / 3)
    assert s["(no site)"] == dict(s["(no site)"], launches=0, copies=1)
    assert s["(unattributed)"]["launches"] == 1
    assert rep["kernels"] == 5 and rep["gpu_events"] == 6
    # busy: [100,170) + [600,800) + [805,905) + [950,1050) (which holds
    # [990,995)) in the window [0,1050), its end the last GPU event's
    assert rep["window_ms"] == pytest.approx(1.05)
    assert rep["busy_ms"] == pytest.approx(0.47)
    assert rep["idle_share"] == pytest.approx(1 - 0.47 / 1.05)
    assert programs.kernel_count(rep, r"acs_kernel<", r"fused") == 1
    assert programs.kernel_count(rep, r"traceback_kernel") == 1


def _captures(n):
    rng = np.random.default_rng(9)
    return [np.concatenate([np.zeros((40, 2), np.float32),
                            tx.encode_frame(rng.integers(0, 256, 12)
                                            .astype(np.uint8), m,
                                            device="cpu").numpy()])
            for m in (6, 54)[:n]]


def test_profile_reports_host_spans_and_noted_costs():
    caps = _captures(2)
    with programs.observing() as obs:
        with obs.profile("batch", "cpu"):
            framebatch.receive_many(caps, device="cpu")
    rep = obs.profiles["batch"]
    assert rep["kernels"] == 0 and rep["busy_ms"] == 0.0
    assert rep["idle_share"] == 1.0 and rep["wall_ms"] > 0
    for label in ("rx.acquire_many", "rx.acquire_pad", "sync.fir_valid",
                  "sync.sliding_sum", "rx.signal_scan", "rx.gather",
                  "rx.decode_mixed"):
        assert rep["sites"][label]["calls"] >= 1, label
        assert rep["sites"][label]["host_ms"] > 0, label
    assert rep["sites"]["sync.fir_valid"]["calls"] == 4
    costs = obs.analyze()
    assert [c["label"] for c in costs] == ["rx.acquire_many"]
    assert "error" not in costs[0]
    assert costs[0]["argument_bytes"] >= 2 * 512 * 2 * 4
    assert costs[0]["bytes_accessed"] > costs[0]["argument_bytes"]
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    c = programs.cost_of(torch.mm, a, b)
    assert c["flops"] == 2 * 8 * 16 * 4
    assert c["bytes_accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_programs_subcommand_prints_its_report(capsys, monkeypatch):
    caps = _captures(1)
    monkeypatch.setattr(programs, "run_driver", lambda device: (
        framebatch.receive_many(caps, device=device)))
    assert cli.main(["programs", "--json", "--platform=cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(rep["profiles"]) == {"driver"}
    assert rep["device_kind"] is None and rep["devicePeaks"] is None
    assert rep["sites_discovered"] == len(programs.discovered_sites())
    assert "rx.acquire_many" in rep["dispatch_counts"]
    costs = rep["costs"]
    assert [c["label"] for c in costs] == ["rx.acquire_many"]
    assert costs[0]["roofline"]["achieved_gbps"] > 0
    assert "pct_hbm_peak" not in costs[0]["roofline"]
    out = programs._format_table(rep)
    assert out.startswith("== driver: wall") and "dispatch sites covered" \
        in out and "rx.acquire_many" in out
    assert "cost rx.acquire_many x1: " in out and "achieved_gbps" in out


def test_entry_points_default_to_the_card():
    """Observatory.profile, run_driver and collect_programs run on the
    card unless the caller asks for the CPU, as every port entry point
    does (the tests above pass "cpu")."""
    import inspect
    for fn in (programs.Observatory.profile, programs.run_driver,
               programs.collect_programs):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
