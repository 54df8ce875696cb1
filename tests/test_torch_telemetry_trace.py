"""The trace half of the port's telemetry (``Trace``, ``span``,
``tracing``, ``record_compile``, ``dispatch.timed`` as a span) against
the JAX package's, on the CPU: the same recorded sequence exports the
same Chrome trace (schema and event sequence; timestamps are not
compared), ``tools/trace_report.py`` summarizes the port's trace as the
reference's, ``annotate_device`` opens ``torch.profiler`` ranges, an
nvcc build is a compile event, and the CLI's ``--trace`` and
``--metrics-dump`` run as the reference's.
"""

import importlib.util
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.runtime import cli as R_cli
from ziria_tpu.utils import dispatch as R_dispatch, telemetry as R_tm
from ziria_tpu_torch import cuda_build
from ziria_tpu_torch.runtime import cli
from ziria_tpu_torch.runtime.buffers import StreamSpec, write_stream
from ziria_tpu_torch.utils import dispatch, telemetry

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
#: event keys whose values are clock readings or process identities
CLOCK_KEYS = ("ts", "dur", "pid", "tid")


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(TOOLS, "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(tm, disp, path):
    """One fixed sequence of spans, counters and compile events."""
    with tm.tracing(path) as tr:
        with disp.timed("rx.sync"):
            with tm.span("inner", args={"k": 1}):
                pass
        disp.record_gauge("rx.stream_inflight", 2)
        tm.count("rx.stream_frames", 3, total=3)
        tm.count("rx.untracked", 1)
        tm.record_compile("nvcc:viterbi.cu", seconds=0.25,
                          args={"library": "libviterbi.so"})
        tm.record_compile("cache_growth:x", n=2)
        with disp.timed("rx.gather"):
            pass
        tr.set_metadata("siteCosts", {"rx.sync": {"bytes_accessed": 1.0,
                                                  "flops": 2.0}})
    return json.load(open(path))


def _shape(obj):
    """The trace without its clock readings: top-level keys, then each
    event's keys and non-clock values in order."""
    evs = [{k: v for k, v in e.items() if k not in CLOCK_KEYS}
           for e in obj["traceEvents"]]
    keys = [sorted(e) for e in obj["traceEvents"]]
    return sorted(obj), evs, keys


def test_trace_schema_and_sequence_equal_the_reference(tmp_path):
    got = _record(telemetry, dispatch, str(tmp_path / "port.json"))
    want = _record(R_tm, R_dispatch, str(tmp_path / "ref.json"))
    assert _shape(got) == _shape(want)
    phases = [e["ph"] for e in got["traceEvents"]]
    assert phases == ["X", "X", "C", "C", "X", "i", "X"]
    for e in got["traceEvents"]:
        assert isinstance(e["ts"], float) and e["pid"] == os.getpid()
    inner, outer = got["traceEvents"][:2]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    tr = _trace_report()
    s_got, t_got = tr.summarize_file(str(tmp_path / "port.json"))
    s_want, t_want = tr.summarize_file(str(tmp_path / "ref.json"))
    assert set(s_got) == set(s_want)
    for part in s_got:
        if isinstance(s_got[part], dict):
            assert set(s_got[part]) == set(s_want[part]), part
    assert t_got.splitlines()[0] == t_want.splitlines()[0]
    assert "rx.sync" in t_got and "nvcc:viterbi.cu" in t_got


def test_timed_is_a_span_and_a_profiler_range(monkeypatch):
    """Idle, ``timed`` records nothing and opens no span; under a trace
    built with ``annotate_device`` it is a span and a ``record_function``
    range that torch.profiler sees."""
    def boom(*a, **k):
        raise AssertionError("span opened while idle")

    with monkeypatch.context() as m:
        m.setattr(telemetry, "span", boom)
        with dispatch.timed("rx.sync"):
            pass
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            telemetry.tracing(annotate_device=True) as tr:
        with dispatch.timed("rx.sync"):
            torch.ones(4).sum()
        with telemetry.span("sync.fir_valid"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"rx.sync", "sync.fir_valid"} <= names
    assert [e["name"] for e in tr.events()] == ["rx.sync", "sync.fir_valid"]
    with telemetry.tracing() as tr2:
        pass
    assert tr2.events() == [] and not telemetry.active()


def test_nvcc_build_is_a_compile_event(tmp_path, monkeypatch):
    """A (stand-in) nvcc run inside a trace and a registry: a compile
    span named after the source, with its library, and the compile
    counter; a cached library compiles nothing."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb')"
                    ".write(b'so')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    builds = cuda_build.COUNTS["builds"]
    with telemetry.tracing() as tr, telemetry.collect() as reg:
        info = cuda_build.build_all()
        again = cuda_build.build_all()
    assert again["viterbi"]["log"] == "cached"
    assert cuda_build.COUNTS["builds"] == builds + 1
    evs = [e for e in tr.events() if e.get("cat") == "compile"]
    assert [e["name"] for e in evs] == ["nvcc:viterbi.cu"]
    assert evs[0]["ph"] == "X" and evs[0]["dur"] > 0
    assert evs[0]["args"]["library"] == os.path.basename(
        info["viterbi"]["path"])
    c = reg.find(telemetry.COMPILE_COUNTER, event="nvcc:viterbi.cu")
    assert c is not None and c.value == 1


def test_cli_trace_and_metrics_dump_as_the_reference(tmp_path, capsys):
    inf = str(tmp_path / "in.dbg")
    write_stream(StreamSpec(ty="bit", path=inf),
                 np.random.default_rng(0).integers(0, 2, 64)
                 .astype(np.uint8))
    spans = {}
    for name, mod, extra in (("port", cli, ["--platform=cpu"]),
                             ("ref", R_cli, [])):
        path = str(tmp_path / f"{name}.json")
        assert mod.main(["--prog=scramble", f"--input-file-name={inf}",
                         "--input-type=bit", "--output-type=bit",
                         f"--output-file-name={tmp_path}/{name}.dbg",
                         "--backend=jit", f"--trace={path}",
                         "--metrics-dump", *extra]) == 0
        assert os.environ.get("ZIRIA_TRACE") is None
        err = capsys.readouterr().err
        assert "telemetry trace written to" in err
        assert "metrics exposition" in err
        obj = json.load(open(path))
        spans[name] = {e["name"] for e in obj["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") == "host"}
        _trace_report().summarize_file(path)
    assert spans["port"] and spans["ref"]
    assert spans["port"] <= {"execute.scan_bulk", "execute.scan_rem"}
    assert spans["ref"] <= {"execute.scan_bulk", "execute.scan_rem"}
    with pytest.raises(SystemExit, match="ZIRIA_CHAOS"):
        os.environ["ZIRIA_CHAOS"] = "s:explode"
        try:
            cli.main(["--prog=scramble", f"--input-file-name={inf}",
                      "--platform=cpu"])
        finally:
            del os.environ["ZIRIA_CHAOS"]
