"""The port's crash durability (runtime/durability: the journal, the
snapshots, the frame rider; runtime/resilience checkpoint files; the
io chaos seam) and recovery (``ServeRuntime.recover``) against the JAX
package's, on the CPU: the scenarios of the reference's
``tests/test_durability.py``, on-disk bytes compared across packages, a
journal and a snapshot directory written by each package and read (and
recovered) by the other, and a crash of the port's real fleet recovered
with every session's frames equal to its lone receiver's.
"""

import base64
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet import GEO, fleet_streams, same_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_serve import Stub
from ziria_tpu.runtime import durability as jdur, resilience as jres, \
    serve as jserve
from ziria_tpu.utils import faults as jfaults
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.runtime import durability, resilience, serve
from ziria_tpu_torch.utils import faults, telemetry

PORT = (serve, resilience, durability)
REF = (jserve, jres, jdur)


def _segment_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_journal_rotation_reopen_prune_and_bytes(tmp_path):
    dirs = {}
    for name, dur in (("port", durability), ("ref", jdur)):
        jd = str(tmp_path / name)
        j = dur.Journal(jd, segment_records=3)
        for i in range(7):
            assert j.append({"ev": "t", "i": i, "sid": "s"}) == i + 1
        dirs[name] = jd
    # byte for byte the reference's segments
    assert _segment_bytes(dirs["port"]) == _segment_bytes(dirs["ref"])
    assert sorted(os.listdir(dirs["port"])) == [
        "wal-000000000001.log", "wal-000000000004.log",
        "wal-000000000007.open"]
    # each package reads, reopens and appends to the other's journal
    for writer, dur in (("ref", durability), ("port", jdur)):
        jd = dirs[writer]
        recs, st = dur.replay(jd)
        assert [r["i"] for r in recs] == list(range(7))
        assert st.dropped == 0 and st.segments == 3
        j2 = dur.Journal(jd, segment_records=3)
        assert j2.seq == 7
        assert not [n for n in os.listdir(jd) if n.endswith(".open")]
        j2.append({"ev": "t", "i": 7})
        recs, _ = dur.replay(jd, after_seq=5)
        assert [r["i"] for r in recs] == [5, 6, 7]
        j2.prune(6)
        assert "wal-000000000001.log" not in os.listdir(jd)
        assert [r["i"] for r in dur.replay(jd, after_seq=6)[0]] == [6, 7]
        j2.bump_seq(40)
        assert j2.append({"ev": "t"}) == 41


def test_torn_journal_tail_dropped_cleanly(tmp_path):
    jd = str(tmp_path / "j")
    j = durability.Journal(jd, segment_records=100)
    for i in range(3):
        j.append({"ev": "t", "i": i})
    j.close()
    path = os.path.join(jd, "wal-000000000001.log")
    data = open(path, "rb").read()
    third = len(data) // 3
    for cut in range(2 * third + 1, len(data)):
        td = str(tmp_path / f"cut-{cut}")
        os.makedirs(td)
        with open(os.path.join(td, "wal-000000000001.log"), "wb") as f:
            f.write(data[:cut])
        for dur in (durability, jdur):
            recs, st = dur.replay(td)
            assert [r["i"] for r in recs] == [0, 1] and st.dropped == 1
    with open(path, "rb+") as f:
        f.truncate(len(data) - 4)
    os.replace(path, os.path.join(jd, "wal-000000000001.open"))
    j2 = durability.Journal(jd)
    assert j2.seq == 2
    recs, st = jdur.replay(jd)
    assert [r["i"] for r in recs] == [0, 1] and st.dropped == 0
    # a torn record mid-segment (injected io_torn): both neighbours live
    jd2 = str(tmp_path / "j2")
    j = durability.Journal(jd2, segment_records=100)
    j.append({"k": 1})
    with faults.inject(faults.FaultSpec("journal.append", "io_torn",
                                        calls=(0,), fraction=0.5)):
        j.append({"k": "torn"})
    j.append({"k": 2})
    for dur in (durability, jdur):
        recs, st = dur.replay(jd2)
        assert [r["k"] for r in recs] == [1, 2] and st.dropped >= 1


def test_io_faults_equal_reference():
    data = b"x" * 100
    fired = []
    for fm in (faults, jfaults):
        with fm.inject(fm.FaultSpec("io.site", "io_torn", every=1,
                                    fraction=0.25)):
            assert len(fm.io_fault("io.site", data)) == 75
        with fm.inject(fm.FaultSpec("io.site", "io_enospc",
                                    calls=(1,))) as p:
            assert fm.io_fault("io.site", data) == data
            with pytest.raises(OSError, match="No space left"):
                fm.io_fault("io.site", data)
        fired.append(p.fired)
    assert fired[0] == fired[1] == [("io.site", "io_enospc", 1)]
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultPlan([faults.FaultSpec("x", "io_nope", every=1)])
    with pytest.raises(ValueError, match="unknown channel profile"):
        faults.FaultPlan([faults.FaultSpec("x", "channel", every=1,
                                           profile="nope")])
    faults.FaultPlan([faults.FaultSpec("x", "channel", every=1)])


def test_snapshots_atomic_fallback_and_cross_package(tmp_path):
    sd = str(tmp_path / "snaps")
    for step in (1, 2, 3):
        p = durability.write_snapshot(sd, step, {0: b"lane-%d" % step,
                                                 2: b"two"},
                                      {"jseq": step * 10}, keep=2)
        assert os.path.basename(p) == durability.snapshot_name(step)
    assert sorted(n for n in os.listdir(sd) if n.startswith("snap")) == \
        ["snap-0000000002", "snap-0000000003"]
    os.makedirs(os.path.join(sd, ".tmp-snap-0000000007.1"))
    for dur in (durability, jdur):
        got = dur.load_snapshot(sd)
        assert (got.step, got.lanes, got.body) == \
            (3, {0: b"lane-3", 2: b"two"}, {"jseq": 30})
    # the manifest is the reference's byte for byte
    jd = str(tmp_path / "ref")
    jdur.write_snapshot(jd, 3, {0: b"lane-3", 2: b"two"}, {"jseq": 30})
    for name in ("meta.json", "lane-0000.ckpt", "lane-0002.ckpt"):
        assert open(os.path.join(sd, "snap-0000000003", name), "rb").read() \
            == open(os.path.join(jd, "snap-0000000003", name), "rb").read()
    with open(os.path.join(sd, "snap-0000000003", "meta.json"), "r+b") as f:
        f.seek(5)
        f.write(b"ZZ")
    assert durability.load_snapshot(sd).step == 2
    with faults.inject(faults.FaultSpec("snapshot.lane", "io_enospc",
                                        every=1)):
        with pytest.raises(OSError):
            durability.write_snapshot(sd, 9, {0: b"x"}, {})
    assert durability.load_snapshot(sd).step == 2
    assert not [n for n in os.listdir(sd) if n.startswith(".tmp-snap-00"
                                                          "00000009")]
    durability.write_snapshot(sd, 4, {0: b"lane-4"}, {"jseq": 40})
    assert not [n for n in os.listdir(sd) if n.startswith(".tmp-")]
    assert jdur.load_snapshot(sd).step == 4
    assert durability.load_snapshot(str(tmp_path / "none")) is None


def test_checkpoint_integrity_and_legacy():
    carry = SimpleNamespace(tail=np.arange(10, dtype=np.float32)
                            .reshape(5, 2), offset=4096, emitted=3,
                            watermark=4000)
    blob = resilience.checkpoint_carry(carry, seen=(4100,),
                                       geometry={"chunk_len": 4096},
                                       state={"quarantined": True})
    st = jres.restore_carry(blob)
    assert st.offset == 4096 and st.state["quarantined"]
    bad = bytearray(blob)
    bad[bad.find(np.float32(7.0).tobytes())] ^= 0x40
    with pytest.raises(resilience.CarryCheckpointError,
                       match="integrity|unreadable"):
        resilience.restore_carry(bytes(bad))
    z = dict(np.load(io.BytesIO(blob), allow_pickle=False))
    z.pop("crc")
    buf = io.BytesIO()
    np.savez(buf, **z)
    with telemetry.collect() as reg:
        assert resilience.restore_carry(buf.getvalue()).offset == 4096
    assert "resilience_checkpoint_legacy 1" in reg.exposition()


# ----------------------------------------------------- stub recovery


def _cfg(mod, tmp, n_lanes=2, **kw):
    return mod.ServeConfig(n_lanes=n_lanes, chunk_len=256, frame_len=64,
                           queue_cap=4, default_slo_s=50.0,
                           snapshot_dir=str(tmp), snapshot_every=1, **kw)


def _crash_table(pkg, tmp):
    mod, res, _dur = pkg
    clock = [0.0]
    srv = mod.ServeRuntime(_cfg(mod, tmp), receiver=Stub(2, res),
                           clock=lambda: clock[0])
    slab = np.zeros((300, 2), np.float32)
    with srv:
        srv.connect("a", slo_s=40.0)
        srv.connect("b")
        srv.connect("q1")
        srv.submit("a", slab)
        srv.submit("b", slab)
        srv.step()
        srv.submit("a", slab)
        srv.step()
        srv.close("b")
        clock[0] = 7.0
        srv._drained = True                # the crash: no drain
    return clock


def _recovered(pkg, tmp, clock, **kw):
    mod, res, _dur = pkg
    srv = mod.ServeRuntime.recover(str(tmp), receiver=Stub(
        kw.pop("lanes", 2), res), clock=lambda: clock[0], **kw)
    return srv, (sorted(srv._sessions), dict(srv._gone), srv.recovered,
                 {s: srv._sessions[s].deadline for s in srv._sessions},
                 list(srv._queue), tuple(srv.stats()))


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("ref", "port"),
                                           ("port", "ref")])
def test_stub_crash_recover_session_table(writer, reader, tmp_path):
    pkgs = {"port": PORT, "ref": REF}
    clock = _crash_table(pkgs[writer], tmp_path / "d")
    clock_r = _crash_table(REF, tmp_path / "r")
    srv, table = _recovered(pkgs[reader], tmp_path / "d", clock)
    _srv, want = _recovered(REF, tmp_path / "r", clock_r)
    assert table == want
    assert set(srv._sessions) == {"a", "q1"} and srv._gone["b"] == "closed"
    info = srv.recovered["a"]
    assert info["acked"] > 0 and info["dedupe_until"] >= 1
    r = srv.submit("b", np.zeros((8, 2), np.float32))
    assert not r.accepted and r.reason == "closed"
    # elastic: the same directory onto one lane, sessions repacked
    small = _cfg(pkgs[reader][0], tmp_path / "d")._replace(n_lanes=1)
    srv1, table1 = _recovered(pkgs[reader], tmp_path / "d", clock,
                              config=small, lanes=1)
    assert sum(srv1.is_active(s) for s in ("a", "q1")) == 1
    assert len(srv1._queue) == 1
    with srv1:
        active = [s for s in ("a", "q1") if srv1.is_active(s)][0]
        srv1.close(active)
        assert sum(srv1.is_active(s) for s in ("a", "q1")) == 1


def _journal_only(pkg, tmp):
    mod, res, _dur = pkg
    cfg = _cfg(mod, tmp)._replace(snapshot_every=0)
    slab = np.zeros((300, 2), np.float32)
    srv = mod.ServeRuntime(cfg, receiver=Stub(2, res), clock=lambda: 0.0)
    got = []
    with srv:
        srv.connect("a")
        srv.submit("a", slab)
        got += srv.step()
        got += srv.step()
        srv._drained = True
    srv2 = mod.ServeRuntime.recover(str(tmp), config=cfg,
                                    receiver=Stub(2, res), clock=lambda: 0.0)
    rec = dict(srv2.recovered)
    with srv2:
        srv2.submit("a", slab)
        srv2.submit("a", slab)
        for _ in range(6):
            got += srv2.step()
    return rec, [f for _s, f in got], tuple(srv2.stats())


def _second_crash(pkg, tmp):
    mod, res, dur = pkg
    cfg = _cfg(mod, tmp, journal_segment_records=1)
    slab = np.zeros((300, 2), np.float32)
    srv = mod.ServeRuntime(cfg, receiver=Stub(2, res), clock=lambda: 0.0)
    with srv:
        srv.connect("a")
        srv.submit("a", slab)
        srv.step()
        srv._drained = True
    step1 = dur.load_snapshot(str(tmp)).step
    srv2 = mod.ServeRuntime.recover(str(tmp), receiver=Stub(2, res),
                                    clock=lambda: 0.0)
    with srv2:
        srv2.connect("b")
        srv2.close("a")
        srv2.submit("b", slab)
        srv2.step()
        srv2.step()
        srv2._drained = True
    step2 = dur.load_snapshot(str(tmp)).step
    srv3 = mod.ServeRuntime.recover(str(tmp), receiver=Stub(2, res),
                                    clock=lambda: 0.0)
    return (step1, step2, sorted(srv3._sessions), dict(srv3._gone),
            srv3.recovered)


def test_stub_journal_only_dedupe_and_second_crash(tmp_path):
    rec, frames, st = _journal_only(PORT, tmp_path / "p1")
    assert (rec, frames, st) == _journal_only(REF, tmp_path / "r1")
    assert rec["a"] == {"acked": 0, "dedupe_until": 1, "active": True}
    assert len({f[2] for f in frames}) == len(frames)
    assert st[16] == 1                   # deduped
    got = _second_crash(PORT, tmp_path / "p2")
    assert got == _second_crash(REF, tmp_path / "r2")
    step1, step2, sessions, gone, recovered = got
    assert step2 > step1 and sessions == ["b"] and gone["a"] == "closed"
    assert recovered["b"]["dedupe_until"] >= 1
    # a full disk under the journal is counted, never raised
    with faults.inject(faults.FaultSpec("journal.append", "io_enospc",
                                        every=2)):
        srv = serve.ServeRuntime(_cfg(serve, tmp_path / "p3"),
                                 receiver=Stub(2, resilience),
                                 clock=lambda: 0.0)
        with srv:
            srv.connect("a")
            srv.connect("b")
            srv.submit("a", np.zeros((300, 2), np.float32))
            srv.step()
            srv.step()
    assert srv.stats().journal_errors >= 1 and srv.stats().admitted == 2


# -------------------------------------------------- real-fleet recovery


def test_fleet_crash_recover_equals_lone_receivers(tmp_path):
    streams, _starts = fleet_streams(seed=11)
    streams = streams[:3]
    want = {f"s{i}": framebatch.receive_stream(x, **GEO, device="cpu")[0]
            for i, x in enumerate(streams)}
    cfg = serve.ServeConfig(n_lanes=4, queue_cap=8, snapshot_dir=str(
        tmp_path / "d"), snapshot_every=1, **GEO)
    got = {sid: [] for sid in want}
    srv = serve.ServeRuntime(cfg, device="cpu")
    with srv:
        for sid in want:
            srv.connect(sid)
        for lo in range(0, 8500, 1700):
            for sid, x in zip(want, streams):
                srv.submit(sid, x[lo:lo + 1700])
            for sid, f in srv.step():
                got[sid].append(f)
        srv._drained = True                # the crash
    assert srv.stats().snapshots >= 1
    snap = durability.load_snapshot(cfg.snapshot_dir)
    # the rider's frames read back in both packages
    for ent in snap.body["rider"]:
        a = durability.decode_frame(ent["frame"])
        b = jdur.decode_frame(ent["frame"])
        same_frames([a], [b])
        assert durability.encode_frame(a) == ent["frame"]
    srv2 = serve.ServeRuntime.recover(cfg.snapshot_dir, device="cpu")
    assert srv2.cfg == cfg and srv2.stats().restarts == 1
    with srv2:
        for sid, f in srv2.replayed:
            got[sid].append(f)
        for sid, x in zip(want, streams):
            srv2.submit(sid, x[srv2.acked(sid):])
        for _ in range(6):
            for sid, f in srv2.step():
                got[sid].append(f)
        for sid, f in srv2.drain():
            got[sid].append(f)
    for sid in want:
        seen = {}
        for f in got[sid]:
            if f.start in seen:
                same_frames([f], [seen[f.start]])
            seen[f.start] = f
        same_frames([seen[s] for s in sorted(seen)], want[sid])
    assert [len(want[sid]) for sid in want] == [2, 2, 0]     # s2: noise


def test_guarded_policy_and_watchdog_equal_reference():
    # the policy knobs, a site that fails for good and the watchdog's
    # cut of an injected hang, counter for counter
    for kw in ({}, {"max_retries": 0}, {"max_retries": 3, "timeout_s": 0.05,
                                        "seed": 7}):
        assert tuple(resilience.default_policy(**kw)) == \
            tuple(jres.default_policy(**kw))
    with pytest.raises(ValueError, match="max_retries"):
        resilience.default_policy(max_retries=-1)
    from ziria_tpu.utils import telemetry as jtm
    got = []
    for res, fm, tm in ((resilience, faults, telemetry),
                        (jres, jfaults, jtm)):
        pol = res.default_policy(max_retries=1, timeout_s=0.05)
        calls = []
        with tm.collect() as reg, fm.inject(
                fm.FaultSpec("site.t", "transient", every=1),
                fm.FaultSpec("site.h", "hang", calls=(0,), delay_s=0.3),
                fm.FaultSpec("site.f", "fatal", calls=(0,))) as p:
            out = [res.guarded("site.h", calls.append, 2, policy=pol)]
            failed = []
            for site, arg in (("site.t", 1), ("site.f", 3)):
                with pytest.raises(res.DispatchFailed) as e:
                    res.guarded(site, calls.append, arg, policy=pol)
                failed.append((e.value.kind, e.value.attempts))
        got.append((out, calls, list(p.fired), failed,
                    {key: m.value for key, m in reg.metrics()
                     if type(m).__name__ == "CounterMetric"},
                    {key: m.count for key, m in reg.metrics()
                     if type(m).__name__ == "Histogram"}))
    assert got[0] == got[1]
    out, calls, _fired, failed, *_ = got[0]
    assert out == [None] and calls == [2]
    assert failed == [("transient", 2), ("fatal", 1)]
    # the hang was cut on the caller's thread, before its launch
    with faults.inject(faults.FaultSpec("site.h", "hang", every=1,
                                        delay_s=0.3)):
        with pytest.raises(resilience.DispatchFailed) as e:
            resilience.guarded("site.h", calls.append, 5,
                               policy=resilience.default_policy(
                                   max_retries=0, timeout_s=0.05))
    assert isinstance(e.value.last, resilience.InjectedTimeout)
    assert isinstance(e.value.last, faults.InjectedFault)
    assert calls == [2]
