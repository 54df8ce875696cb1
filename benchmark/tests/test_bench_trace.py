"""The trace arithmetic on a hand-built profiler trace."""

import pytest

from benchmark.trace import Trace, window_trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _events():
    return [
        _x("user_annotation", "bench.window", 0.0, 1000.0),
        _x("user_annotation", "rx.decode_mixed", 100.0, 300.0),
        _x("user_annotation", "rx.inner", 150.0, 50.0),
        _x("user_annotation", "rx.signal_scan", 500.0, 400.0),
        # launches on the host, their device events by correlation
        _x("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 300.0, 5.0, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 600.0, 5.0, correlation=3),
        _x("kernel", "void acs_kernel<F32, 2>", 200.0, 100.0, tid=7,
           correlation=1),
        _x("kernel", "elementwise", 250.0, 100.0, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 650.0, 50.0, tid=7, correlation=3),
    ]


def test_busy_window_attribution_and_gaps():
    t = window_trace(_events(), "bench.window")
    assert t.window_s == pytest.approx(1000e-6)
    # union of [200, 350) and [650, 700)
    assert t.busy_s == pytest.approx(200e-6)
    assert t.device_events() == 3
    # both kernels launched inside rx.decode_mixed, one also in rx.inner
    assert t.device_s_under("rx.decode_mixed") == pytest.approx(200e-6)
    assert t.device_s_under("rx.inner") == pytest.approx(100e-6)
    assert t.device_s_under("rx.signal_scan") == pytest.approx(50e-6)
    assert t.kernel_s(r"acs_kernel|traceback_kernel") == pytest.approx(100e-6)
    assert t.top_ops(2) == [["void acs_kernel<F32, 2>", pytest.approx(1e-4)],
                            ["elementwise", pytest.approx(1e-4)]]
    gaps = dict(t.idle_gaps())
    # [0, 200): mid 100 in rx.decode_mixed; [350, 650): mid 500 opens
    # rx.signal_scan; [700, 1000): mid 850 in rx.signal_scan
    assert gaps["rx.decode_mixed"] == pytest.approx(200e-6)
    assert gaps["rx.signal_scan"] == pytest.approx(600e-6)


def test_no_device_events_reads_nothing():
    assert window_trace(_events()[:4], "bench.window") is None
    assert Trace([], "w").busy_s == 0.0
