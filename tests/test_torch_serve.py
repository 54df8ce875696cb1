"""The port's serving runtime (runtime/serve.ServeRuntime, run_clients)
against the JAX package's, on the CPU.

State-machine scenarios (the reference's ``tests/test_serve.py``) drive
both packages' ``ServeRuntime`` with the same stub fleet, the same
injected clock and a counting ``perf_counter``; each gives the same
answers, ``stats()``, shed log, ``scrape()`` text and journal records
(no JAX dispatch: the stub does no device work). Then one run of the
port's real fleet on the CPU against lone receivers (test_torch_fleet.py's
geometry): every session's frames equal its stream's lone receiver's,
the accounting balances and each step stays within two dispatches.
"""

import base64
import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet import GEO, fleet_streams, same_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.runtime import durability as jdur, resilience as jres, \
    serve as jserve
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.runtime import durability, resilience, serve
from ziria_tpu_torch.utils import dispatch

CHUNK_S, FRAME_S = 256, 64      # the stub fleet's geometry


class Stub:
    """A sample-count fleet: one token frame per consumed chunk, lane
    checkpoints as real carry blobs of `res` (either package's
    resilience module), no device work."""

    def __init__(self, s, res, chunk_len=CHUNK_S, frame_len=FRAME_S):
        self.s, self.res, self.chunk_len = s, res, chunk_len
        self.stride = chunk_len - frame_len
        self._tails = [0] * s
        self._offsets = [0] * s
        self._emitted = [0] * s
        self.stats = SimpleNamespace(chunk_steps=0)
        self.flushed = False
        self.restored = {}

    def quarantined(self, i):
        return i == 1 and self._offsets[i] > 0

    def _frame(self, i):
        self._emitted[i] += 1
        return (i, ("frame", i, self._offsets[i]))

    def push_many(self, slabs):
        for i, a in slabs.items():
            self._tails[i] += int(a.shape[0])
        out = []
        while any(t >= self.chunk_len for t in self._tails):
            self.stats.chunk_steps += 1
            for i in range(self.s):
                if self._tails[i] >= self.chunk_len:
                    out.append(self._frame(i))
                    self._tails[i] -= self.stride
                    self._offsets[i] += self.stride
        return out

    def flush_stream(self, i):
        if not self._tails[i]:
            return []
        self.stats.chunk_steps += 1
        out = [self._frame(i)]
        self._tails[i] = 0
        return out

    def reset_stream(self, i):
        self._tails[i] = self._offsets[i] = self._emitted[i] = 0
        return []

    def restore_stream(self, i, blob):
        st = self.res.restore_carry(blob)
        self.restored[i] = blob
        self._offsets[i], self._emitted[i] = int(st.offset), int(st.emitted)
        self._tails[i] = int(st.tail.shape[0])
        return []

    def _blob(self, i):
        carry = SimpleNamespace(
            tail=np.zeros((self._tails[i], 2), np.float32),
            offset=self._offsets[i], emitted=self._emitted[i],
            watermark=self._offsets[i])
        return self.res.checkpoint_carry(carry, geometry={"chunk_len":
                                                          self.chunk_len})

    def checkpoint(self, i):
        return self._blob(i), []

    def checkpoint_fleet(self, lanes=None):
        which = range(self.s) if lanes is None else lanes
        return {i: self._blob(i) for i in which}, []

    def flush(self):
        self.flushed = True
        return []


SLAB = np.zeros((300, 2), np.float32)


def s_admission(srv, clock):
    rs = [srv.connect(f"c{i}") for i in range(6)]
    return rs + [srv.connect("c0")]


def s_ingress(srv, clock):
    srv.connect("a")
    out = [srv.submit("a", np.zeros((600, 2), np.float32))]
    out += [srv.submit("a", np.zeros((128, 2), np.float32))
            for _ in range(9)]
    for bad in (lambda: srv.submit("nobody", SLAB),
                lambda: srv.submit("a", np.zeros((4, 3)))):
        with pytest.raises((KeyError, ValueError)) as e:
            bad()
        out.append(str(e.value))
    return out


def s_deadline(srv, clock):
    srv.connect("fast", slo_s=100.0)
    srv.connect("slow", slo_s=5.0)
    srv.connect("queued-slow", slo_s=5.0)
    srv.submit("fast", SLAB)
    clock[0] = 6.0
    out = srv.step()
    return out + [srv.submit("slow", SLAB)]


def s_drain(srv, clock):
    srv.connect("a")
    srv.connect("b")
    srv.connect("q1")
    srv.submit("a", SLAB)
    out = srv.step() + srv.drain()
    out += [srv.connect("late"), srv.drain(), srv._rx.flushed]
    with pytest.raises(RuntimeError, match="after drain"):
        srv.step()
    return out


def s_rejected_reconnect(srv, clock):
    srv.connect("doomed", slo_s=1.0)
    srv.connect("a")
    clock[0] = 2.0
    srv.step()
    for sid in ("b", "q1", "q2"):
        srv.connect(sid)
    return [srv.connect("doomed"), srv.submit("doomed", SLAB)]


def s_queued_close_evict(srv, clock):
    for sid in ("a", "b", "q-close", "q-evict"):
        srv.connect(sid)
    out = srv.close("q-close")
    blob, ems, staged = srv.evict("q-evict")
    return out + [blob, ems, len(staged), srv.drain()]


def s_flood(srv, clock):
    srv.connect("flood")
    srv.submit("flood", np.zeros((500, 2), np.float32))
    out = srv.step() + [srv._sessions["flood"].staged_samples]
    return out + srv.step() + [srv._sessions["flood"].staged_samples]


def s_evict_restore(srv, clock):
    srv.connect("a")
    srv.connect("b")
    srv.submit("a", SLAB)
    srv.submit("b", SLAB)
    out = srv.step()
    srv.submit("a", np.zeros((100, 2), np.float32))
    blob, ems, staged = srv.evict("a")
    out += ems + [len(staged), srv.is_active("a"),
                  srv.connect("a", checkpoint=blob), srv.acked("a")]
    srv.submit("a", SLAB)
    out += srv.step() + srv.close("a")
    return out + [srv.stats().quarantined_sessions]


def s_snapshot_marks(srv, clock):
    for i in range(3):
        srv.connect(f"s{i}", slo_s=30.0)
    out = []
    for t in range(6):
        clock[0] = float(t)
        for i in range(3):
            srv.submit(f"s{i}", SLAB)
        out += srv.step()
    out += srv.close("s0")
    out += srv.snapshot()
    return out


SCENARIOS = {f.__name__[2:]: f for f in (
    s_admission, s_ingress, s_deadline, s_drain, s_rejected_reconnect,
    s_queued_close_evict, s_flood, s_evict_restore, s_snapshot_marks)}


def journal_view(records, res):
    """Journal records with each checkpoint decoded to its fields (an
    npz blob's zip headers carry the time it was written)."""
    out = []
    for r in records:
        r = dict(r)
        if r.get("ckpt"):
            st = res.restore_carry(base64.b64decode(r["ckpt"]))
            r["ckpt"] = (st.offset, st.emitted, st.tail.shape, st.geometry)
        out.append(r)
    return out


def drive(pkg, scenario, tmp, monkeypatch):
    """Run one scenario against one package's ServeRuntime; returns
    everything the two packages must agree on."""
    srv_mod, res, dur = pkg
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)
    clock = [0.0]
    cfg = srv_mod.ServeConfig(
        n_lanes=2, chunk_len=CHUNK_S, frame_len=FRAME_S, queue_cap=2,
        max_slab_samples=512, max_backlog_samples=1024, retry_after_s=0.5,
        snapshot_dir=str(tmp), snapshot_every=2)
    srv = srv_mod.ServeRuntime(cfg, receiver=Stub(2, res),
                               clock=lambda: clock[0])
    with srv:
        answers = SCENARIOS[scenario](srv, clock)
    monkeypatch.undo()
    records, _st = dur.replay(str(tmp / "journal"))
    snap = dur.load_snapshot(str(tmp))
    view = [tuple(a) if isinstance(a, tuple) else a for a in answers]
    view = [journal_view([{"ckpt": base64.b64encode(a).decode()}], res)
            if isinstance(a, bytes) else a for a in view]
    return (view, tuple(srv.stats()), srv.scrape(),
            journal_view(records, res),
            None if snap is None else (snap.step, sorted(snap.lanes),
                                       snap.body["sessions"],
                                       snap.body["gone"]))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_state_machine_equals_reference(scenario, tmp_path, monkeypatch):
    got = drive((serve, resilience, durability), scenario,
                tmp_path / "port", monkeypatch)
    want = drive((jserve, jres, jdur), scenario, tmp_path / "ref",
                 monkeypatch)
    assert got[0] == want[0]           # every answer
    assert got[1] == want[1]           # stats(), shed log included
    assert got[2] == want[2]           # the scrape page, line for line
    assert got[3] == want[3]           # the journal's records
    assert got[4] == want[4]           # the last snapshot
    assert "serve_chunk_seconds" in got[2] or scenario in (
        "admission", "ingress", "queued_close_evict", "rejected_reconnect")


def test_config_geometry_and_unported_shard():
    from ziria_tpu_torch.utils import geometry
    g = geometry.Geometry(n_streams=4, chunk_len=4096, frame_len=1024)
    c = serve.ServeConfig.from_geometry(g, check_fcs=True)
    assert (c.n_lanes, c.chunk_len, c.frame_len, c.check_fcs) == \
        (4, 4096, 1024, True)
    assert serve.ServeConfig()._fields == jserve.ServeConfig()._fields
    assert tuple(serve.ServeConfig()) == tuple(jserve.ServeConfig())
    # shard=True: the lanes over the widest lane-dividing mesh of the
    # visible devices, the reference's on its 8 virtual devices (12
    # lanes: 6 entries; 11 lanes: only 1 fits, an unsharded fleet)
    for lanes, width in ((8, 8), (12, 6), (11, None)):
        cfg = dict(n_lanes=lanes, shard=True, **GEO)
        got = serve.ServeRuntime(serve.ServeConfig(**cfg), device="cpu")._rx
        want = jserve.ServeRuntime(jserve.ServeConfig(**cfg))._rx
        assert (None if got.mesh is None else got.mesh.size) == width == \
            (None if want.mesh is None else want.mesh.size)
        assert got.mesh is None or got.mesh.axis_names == ("dp",)
    with pytest.raises(ValueError, match="n_lanes"):
        serve.ServeRuntime(serve.ServeConfig(n_lanes=0),
                           receiver=Stub(1, resilience))


def test_real_fleet_serve_equals_lone_receivers():
    streams, starts = fleet_streams(seed=7)
    rng = np.random.default_rng(8)
    clients = []
    for i, x in enumerate(streams):
        cuts = np.cumsum(rng.integers(300, 2500, 40))
        cuts = [0] + [int(c) for c in cuts if c < x.shape[0]] + [x.shape[0]]
        sched = [(j, x[a:b]) for j, (a, b) in enumerate(zip(cuts, cuts[1:]))]
        clients.append(serve.ClientSpec(f"c{i}", sched, x))
    # a ninth client waits in the queue for a lane
    clients.append(serve.ClientSpec("late", clients[0].schedule,
                                    streams[0]))
    cfg = serve.ServeConfig(n_lanes=8, queue_cap=4, **GEO)
    with dispatch.count_dispatches() as d:
        with serve.ServeRuntime(cfg, device="cpu") as srv:
            frames = serve.run_clients(srv, clients)
    st = srv.stats()
    for c, x in zip(clients, streams + [streams[0]]):
        want, _ = framebatch.receive_stream(x, **GEO, device="cpu")
        same_frames(frames[c.sid], want)
    assert [f.start for f in frames["c1"]] == starts[1]
    assert st.admitted == st.closed == 9 and st.queued == 1
    assert st.shed == st.evicted == 0 and st.active_sessions == 0
    assert st.frames == sum(len(v) for v in frames.values())
    assert sum(d.counts.values()) <= 2 * st.chunk_steps
    lat = srv.registry.find("serve.chunk_seconds")
    assert lat.count == st.chunk_steps
    s = lat.summary(scale=1e3)
    assert 0 < s["p50"] <= s["p99"] <= 2 * s["max"]
    assert "serve_chunk_seconds_bucket" in srv.scrape()


def test_registry_quantiles_snapshot_and_exposition_equal_reference():
    from ziria_tpu.utils import telemetry as jtm
    from ziria_tpu_torch.utils import telemetry
    rng = np.random.default_rng(5)
    obs = list(rng.lognormal(-4, 2, 300)) + [0.0, -1.0, 0.5, 1.0, 2.0 ** -10]
    regs = []
    for tm in (telemetry, jtm):
        reg = tm.MetricsRegistry()
        with tm.collect(reg):
            for v in obs:
                tm.observe("serve.chunk_seconds", v)
            tm.observe("lat", 0.25, labels={"site": "a b"})
            tm.count("serve.shed", 3, labels={"reason": "deadline"})
            tm.count("serve.frames", 7)
        for i in range(5000):
            reg.gauge("ziria_gauge", site="rx.depth").set(i, t=float(i))
        regs.append(reg)
    port, ref = regs
    h, jh = port.find("serve.chunk_seconds"), ref.find("serve.chunk_seconds")
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.summary(scale=1e3) == jh.summary(scale=1e3)
    assert h.bucket_counts() == jh.bucket_counts()
    assert port.exposition() == ref.exposition()
    assert port.snapshot() == ref.snapshot()
    g = port.find("ziria_gauge", site="rx.depth")
    assert len(g.samples) == 4096 and g.last == 4999 and g.max == 4999
    assert port.find("nothing") is None
    assert telemetry.MetricsRegistry().find("x") is None
    assert telemetry.Histogram().summary() == {"count": 0}
    assert telemetry.Histogram().quantile(0.5) is None
