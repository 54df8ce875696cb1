"""The port's CLI run and serve surface against the JAX package's, on
the CPU: the ``--chaos`` grammar and the plan's firing record, the
checkpoint files, every ``--prog`` pipeline (``scramble`` exact,
``fir`` within 1e-6, the FFTs and ``wifi_tx_sym_*`` within 1e-4), the
scoped ``ZIRIA_*`` knob flags, ``--profile`` / ``--profile-trace``, and
``serve`` with ``--snapshot-dir`` and ``--recover``.
"""

import collections
import contextlib
import io
import json
import os

import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.runtime import cli as R_cli, resilience as R_res, \
    serve as R_serve
from ziria_tpu.utils import faults as R_faults
from ziria_tpu_torch.phy.wifi.params import RATES
from ziria_tpu_torch.runtime import cli, resilience, serve
from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
    write_stream
from ziria_tpu_torch.utils import faults

Carry = collections.namedtuple("Carry", "tail offset emitted watermark")
CHAOS_OK = (
    "rx.stream_chunk:transient",
    "seed=7;rx.*:fatal:calls=0+2+5;link.fused:delay:every=3,delay=0.002",
    "serve.push:nan_slab:p=0.25,frac=0.5;serve.push:truncate:count=2",
    "a:hang:p=0.5,delay=0.01; b:channel:profile=urban,every=2",
    "journal.write:io_torn:calls=1;snap.*:io_enospc:every=4,count=1",
    "seed=3;;x:transient:p=0.1,count=3;seed=9",
)
CHAOS_BAD = ("justasite", "s:explode:every=2", "s:transient:every",
             "s:transient:wat=1", "s:transient:every=1,p=0.5",
             "s:channel:profile=nope", "seed=x")


def _error(fn, text):
    try:
        fn(text)
    except ValueError as e:
        return str(e)
    return None


def test_chaos_specs_and_checkpoint_files_as_the_reference(tmp_path,
                                                           monkeypatch):
    for text in CHAOS_OK:
        specs, seed = faults.parse_chaos_spec(text)
        r_specs, r_seed = R_faults.parse_chaos_spec(text)
        assert seed == r_seed
        assert [tuple(s) for s in specs] == [tuple(s) for s in r_specs]
    for text in CHAOS_BAD:
        err = _error(faults.parse_chaos_spec, text)
        assert err is not None and err == _error(R_faults.parse_chaos_spec,
                                                 text), text
    monkeypatch.setenv("ZIRIA_CHAOS", CHAOS_OK[1])
    assert faults.env_chaos() == faults.parse_chaos_spec(CHAOS_OK[1])
    monkeypatch.delenv("ZIRIA_CHAOS")
    assert faults.env_chaos() is None
    # one plan, the same calls, the same firing record in both packages
    specs, seed = faults.parse_chaos_spec(
        "seed=4;rx.*:transient:p=0.3;link.fused:fatal:every=3")
    r_specs, _ = R_faults.parse_chaos_spec(
        "seed=4;rx.*:transient:p=0.3;link.fused:fatal:every=3")
    plan, r_plan = faults.FaultPlan(specs, seed), \
        R_faults.FaultPlan(r_specs, seed)
    for i in range(40):
        site = ("rx.sync", "rx.gather", "link.fused")[i % 3]
        kinds = faults.DISPATCH_KINDS
        a, b = plan.decide(site, kinds), r_plan.decide(site, kinds)
        assert (a is None) == (b is None) and (a is None or a[1] == b[1])
    assert plan.total_fired == r_plan.total_fired > 0
    assert plan.fired_sites() == r_plan.fired_sites()
    # checkpoint files: atomic writes read back across packages; a torn
    # write lands whole and fails at restore on its CRC
    tail = np.arange(64, dtype=np.float32).reshape(32, 2)
    carry = Carry(tail, 4096, 3, 100)
    for save, load, other in ((resilience.save_checkpoint,
                               resilience.load_checkpoint,
                               R_res.load_checkpoint),
                              (R_res.save_checkpoint, R_res.load_checkpoint,
                               resilience.load_checkpoint)):
        p = str(tmp_path / f"ck-{save.__module__}.bin")
        save(p, resilience.checkpoint_carry(carry, seen=(5, 9)))
        for ld in (load, other):
            st = ld(p)
            np.testing.assert_array_equal(np.asarray(st.tail), tail)
            assert (st.offset, st.emitted, sorted(st.seen)) == \
                (4096, 3, [5, 9])
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    p = str(tmp_path / "torn.bin")
    with faults.inject(faults.FaultSpec("checkpoint.write", "io_torn",
                                        calls=(0,))):
        resilience.save_checkpoint(p, resilience.checkpoint_carry(carry))
    with pytest.raises(resilience.CarryCheckpointError):
        resilience.load_checkpoint(p)


def _run_prog(mod, name, ity, oty, xs, tmp_path, extra=()):
    inf = str(tmp_path / f"{name}.in.dbg")
    outf = str(tmp_path / f"{name}.{mod.__name__}.dbg")
    write_stream(StreamSpec(ty=ity, path=inf), xs)
    argv = [f"--prog={name}", f"--input-file-name={inf}",
            f"--input-type={ity}", f"--output-file-name={outf}",
            f"--output-type={oty}", *extra]
    assert mod.main(argv) == 0
    return read_stream(StreamSpec(ty=oty, path=outf))


def _both_progs(name, ity, oty, xs, tmp_path):
    got = _run_prog(cli, name, ity, oty, xs, tmp_path, ["--platform=cpu"])
    want = _run_prog(R_cli, name, ity, oty, xs, tmp_path)
    assert got.shape == want.shape and got.shape[0] > 0, name
    return got, want


def test_progs_equal_the_reference(tmp_path, capsys):
    rng = np.random.default_rng(3)
    assert cli.main(["--list-progs"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == sorted(R_cli.PROGS) == sorted(cli.PROGS)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    got, want = _both_progs("scramble", "bit", "bit", bits, tmp_path)
    np.testing.assert_array_equal(got, want)
    x = rng.normal(size=256).astype(np.float32)
    got, want = _both_progs("fir", "float32", "float32", x, tmp_path)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    iq = rng.integers(-1, 2, (256, 2)).astype(np.int16)
    for name in ("fft64", "ifft64"):
        got, want = _both_progs(name, "complex16", "float32", iq, tmp_path)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(SystemExit, match="unknown prog"):
        cli.main(["--prog=nope", "--platform=cpu"])


def test_wifi_tx_symbols_equal_the_reference_at_every_rate(tmp_path):
    rng = np.random.default_rng(4)
    for m in sorted(RATES):
        bits = rng.integers(0, 2, 3 * RATES[m].n_dbps).astype(np.uint8)
        got, want = _both_progs(f"wifi_tx_sym_{m}", "bit", "float32", bits,
                                tmp_path)
        assert got.shape == (3 * 80 * 2,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"{m} Mbit/s")


KNOBS = {"--fused-demap": ("ZIRIA_FUSED_DEMAP", "1"),
         "--no-batched-acquire": ("ZIRIA_BATCHED_ACQUIRE", "0"),
         "--batched-tx": ("ZIRIA_BATCHED_TX", "1"),
         "--no-streaming-rx": ("ZIRIA_STREAMING_RX", "0"),
         "--multi-stream=3": ("ZIRIA_MULTI_STREAM", "3"),
         "--no-fused-link": ("ZIRIA_FUSED_LINK", "0"),
         "--rx-sco-track": ("ZIRIA_RX_SCO_TRACK", "1"),
         "--chaos=seed=2;rx.sync:transient:every=9": (
             "ZIRIA_CHAOS", "seed=2;rx.sync:transient:every=9"),
         "--max-retries=5": ("ZIRIA_MAX_RETRIES", "5"),
         "--channel-profile=urban,flat": ("ZIRIA_CHANNEL_PROFILE",
                                          "urban,flat")}


def test_knob_flags_are_checked_and_scoped(tmp_path, monkeypatch):
    """Each of the ten knob flags writes its variable for the run only
    (an exported value comes back after it); --chaos,
    --channel-profile and --max-retries are checked before the run."""
    bits = np.random.default_rng(5).integers(0, 2, 64).astype(np.uint8)
    inf = str(tmp_path / "in.dbg")
    write_stream(StreamSpec(ty="bit", path=inf), bits)
    base = ["--prog=scramble", f"--input-file-name={inf}",
            "--input-type=bit", f"--output-file-name={tmp_path}/o.dbg",
            "--output-type=bit", "--platform=cpu"]
    seen = {}
    real = cli._run_cmd

    def spy(args):
        seen.update({v: os.environ.get(v) for v, _ in KNOBS.values()})
        return real(args)

    monkeypatch.setattr(cli, "_run_cmd", spy)
    monkeypatch.setenv("ZIRIA_FUSED_DEMAP", "0")
    for var, _ in KNOBS.values():
        if var != "ZIRIA_FUSED_DEMAP":
            monkeypatch.delenv(var, raising=False)
    for flag, (var, want) in KNOBS.items():
        seen.clear()
        assert cli.main(base + [flag]) == 0, flag
        assert seen[var] == want, flag
        assert os.environ.get(var) == (
            "0" if var == "ZIRIA_FUSED_DEMAP" else None), flag
    for flag, what in (("--chaos=s:explode", "--chaos"),
                       ("--channel-profile=nope", "--channel-profile"),
                       ("--max-retries=-1", "--max-retries")):
        seen.clear()
        with pytest.raises(SystemExit, match=what):
            cli.main(base + [flag])
        assert not seen, flag


def test_profile_and_profile_trace_keep_the_output(tmp_path, capsys):
    """--profile times each stage apart and --profile-trace writes a
    torch.profiler trace naming the dispatch sites; the output is the
    plain run's."""
    src = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "scrambler.zir")
    inf = os.path.join(os.path.dirname(src), "golden", "scrambler.infile")
    outs = {}
    for name, extra in (("plain", []), ("profile", ["--profile"]),
                        ("trace", [f"--profile-trace={tmp_path}/pt"])):
        outf = str(tmp_path / f"{name}.dbg")
        assert cli.main([f"--src={src}", f"--input-file-name={inf}",
                         f"--output-file-name={outf}", "--platform=cpu",
                         *extra]) == 0
        outs[name] = open(outf).read()
        if name == "profile":
            rows = cli.LAST_RUN["profile"]
            assert rows and rows[0]["backend"] == "jit"
            assert rows[0]["items_in"] > 0 and rows[0]["host_ms"] > 0
            assert rows[0]["cuda_ms"] is None
            assert "profile: 1 stage(s)" in capsys.readouterr().err
    assert outs["plain"] == outs["profile"] == outs["trace"]
    path = cli.LAST_RUN["profile_trace"]
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert "execute.scan_rem" in names or "execute.scan_bulk" in names


def _serve_report(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_reports_equal_the_reference_and_recover(tmp_path):
    argv = ["--lanes", "2", "--sessions", "3", "--frames", "1",
            "--snapshot-every", "1"]
    reps = {}
    for name, mod, extra in (("port", serve, ["--platform=cpu"]),
                             ("ref", R_serve, [])):
        d = str(tmp_path / name)
        reps[name] = [_serve_report(mod, argv + extra + ["--snapshot-dir",
                                                         d]),
                      _serve_report(mod, argv + extra + ["--snapshot-dir",
                                                         d, "--recover"])]
    for got, want in zip(reps["port"], reps["ref"]):
        assert set(got) == set(want)
        assert set(got["stats"]) == set(want["stats"])
        assert got["frames"] == want["frames"] == 3
        assert got["stats"] == want["stats"]
        assert got["chunk_latency_ms"]["count"] == \
            want["chunk_latency_ms"]["count"]
        st = got["stats"]
        assert st["admitted"] == st["closed"] == 3 and st["frames"] == 3
    assert reps["port"][1]["stats"]["restarts"] == 1
