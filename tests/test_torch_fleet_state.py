"""State and containment of the port's S-stream fleet against the JAX
package's, on the CPU (test_torch_fleet.py's geometry and streams):
lane checkpoints restored across receivers and packages both ways, a
NaN lane quarantined with its lanemates unchanged, non-default
quarantine limits, injected transients and hangs under the watchdog and
the degraded twins, each also on a fleet held to the card's rule. The
rule's real-failure side is in test_torch_fleet_card.py.
"""

import numpy as np
import pytest

from test_torch_fleet import GEO, S, fleet_streams, same_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.utils import faults as jfaults, telemetry as jtm
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.runtime import resilience
from ziria_tpu_torch.utils import faults, telemetry

CUTS = [0, 1500, 3000, 4700, 6100]


def slabs_of(streams):
    """Each stream cut at CUTS: a list of per-stream slab lists."""
    return [[x[a:b] for a, b in zip(CUTS, CUTS[1:] + [None])]
            for x in streams]


def run(msr, slabs, start=0):
    """Push the slabs from round `start` on, stream by stream each
    round, then flush; returns per-stream frame lists."""
    got = []
    for r in range(start, len(CUTS)):
        got += msr.push_many([s[r] for s in slabs])
    got += msr.flush()
    return per_stream(got)


def per_stream(pairs):
    out = [[] for _ in range(S)]
    for i, f in pairs:
        out[i].append(f)
    return out


def port(**kw):
    return framebatch.MultiStreamReceiver(S, **GEO, device="cpu", **kw)


@pytest.fixture(scope="module")
def fleet():
    streams, _starts = fleet_streams()
    slabs = slabs_of(streams)
    return streams, slabs, run(port(), slabs)


def counters(reg):
    """A registry's unlabelled counters (either package's)."""
    if isinstance(reg, telemetry.MetricsRegistry):
        return reg.counters()
    return {n: m.value for (n, lab), m in reg.metrics()
            if not lab and isinstance(m, jtm.CounterMetric)}


def test_lane_checkpoints_cross_receivers_and_packages(fleet):
    streams, slabs, want = fleet
    for head_fb, extra in ((framebatch, {"device": "cpu"}), (jfb, {})):
        msr = head_fb.MultiStreamReceiver(S, **GEO, **extra)
        head = []
        for r in range(2):
            head += msr.push_many([s[r] for s in slabs])
        blobs, drained = msr.checkpoint_fleet()
        head = per_stream(head + drained)
        one_blob, none = msr.checkpoint(3)
        assert none == [] and resilience.restore_carry(one_blob).offset \
            == resilience.restore_carry(blobs[3]).offset
        # every lane into a fresh fleet of each package
        for fb, kw in ((framebatch, {"device": "cpu"}), (jfb, {})):
            new = fb.MultiStreamReceiver(S, **GEO, **kw)
            for i, b in blobs.items():
                new.restore_stream(i, b)
            rest = run(new, slabs, start=2)
            for i in range(S):
                same_frames(head[i] + rest[i], want[i])
        # lane 1 (the straddle) into a lone receiver
        sr = framebatch.StreamReceiver(**GEO, checkpoint=blobs[1],
                                       device="cpu")
        rest = [f for a in slabs[1][2:] for f in sr.push(a)] + sr.flush()
        same_frames(head[1] + rest, want[1])
    # a lone receiver's blob restores into a fleet lane
    sr = framebatch.StreamReceiver(**GEO, device="cpu")
    head = [f for a in slabs[0][:2] for f in sr.push(a)]
    blob, drained = sr.checkpoint()
    new = port()
    new.restore_stream(5, blob)
    got = []
    for a in slabs[0][2:]:
        got += new.push(5, a)
    got += new.flush()
    same_frames(head + drained + [f for _i, f in got], want[0])
    assert {i for i, _f in got} == {5}
    # a mismatched geometry or a torn blob is refused
    wide = framebatch.MultiStreamReceiver(2, chunk_len=8192, frame_len=1024,
                                          max_frames_per_chunk=8,
                                          check_fcs=True, device="cpu")
    with pytest.raises(resilience.CarryCheckpointError,
                       match="geometry mismatch"):
        wide.restore_stream(0, blob)
    with pytest.raises(resilience.CarryCheckpointError):
        wide.restore_stream(1, blob[:len(blob) // 2])


def test_nan_lane_quarantined_lanemates_unchanged(fleet):
    for limits in ((2, 3), (3, 1)):
        _nan_lane(fleet, limits)


def _nan_lane(fleet, limits):
    _streams, slabs, want = fleet
    blowup_limit, rejoin_after = limits
    bad = [list(s) for s in slabs]
    poisoned = np.array(bad[3][1], copy=True)
    poisoned[::7] = np.nan
    bad[3][1] = poisoned
    got = []
    for fb, kw in ((framebatch, {"device": "cpu"}), (jfb, {})):
        msr = fb.MultiStreamReceiver(S, **GEO, sanitize=True,
                                     blowup_limit=blowup_limit,
                                     rejoin_after=rejoin_after, **kw)
        out, q = [], []
        for r in range(len(CUTS)):
            out += msr.push_many([s[r] for s in bad])
            q.append(msr.quarantined(3))
        out += msr.flush()
        got.append((per_stream(out), tuple(msr.stats), q))
    (frames, st, q), (r_frames, r_st, r_q) = got
    assert st == r_st and q == r_q and q[1]
    assert st[7] == 1 and st[6] > 0       # quarantines, sanitized
    for i in range(S):
        same_frames(frames[i], r_frames[i])
        if i != 3:
            same_frames(frames[i], want[i])
    # the quarantined lane emits only frames it would have emitted, and
    # exactly a lone sanitizing receiver's on the same slabs
    by_start = {f.start: f for f in want[3]}
    for f in frames[3]:
        same_frames([f], [by_start[f.start]])
    lone = framebatch.StreamReceiver(**GEO, sanitize=True,
                                     blowup_limit=blowup_limit,
                                     rejoin_after=rejoin_after, device="cpu")
    same_frames(frames[3], [f for s in bad[3] for f in lone.push(s)]
                + lone.flush())
    # the health rule itself, event for event, with these limits
    rng = np.random.default_rng(sum(limits))
    h = framebatch._LaneHealth(blowup_limit, rejoin_after)
    jh = jfb._LaneHealth(blowup_limit, rejoin_after)
    for ev in rng.integers(0, 4, 200):
        for x in (h, jh):
            if ev == 0:
                x.poison()
            elif ev == 1:
                x.blowup()
        assert h.step(ev == 3) == jh.step(ev == 3)
        assert (h.quarantined, h.clean, h.blowups, h.quarantines) == \
            (jh.quarantined, jh.clean, jh.blowups, jh.quarantines)


# (knobs, fault specs, held to the reference too): the reference's
# degraded fleet scan runs its graph op by op (~20 s here), so that twin
# is held to the uninterrupted frames only
PLANS = {
    "transient": (dict(watchdog_s=None),
                  [dict(site="rx.stream_chunk_multi", kind="transient",
                        every=3),
                   dict(site="rx.stream_decode_multi", kind="transient",
                        every=2)], True),
    "hang": (dict(watchdog_s=0.05),
             [dict(site="rx.stream_chunk_multi", kind="hang", calls=(1,),
                   delay_s=0.3),
              dict(site="rx.stream_decode_multi", kind="hang", calls=(0,),
                   delay_s=0.3),
              dict(site="rx.stream_decode_multi", kind="delay", calls=(2,),
                   delay_s=0.01)], True),
    "fatal_decode": (dict(), [dict(site="rx.stream_decode_multi",
                                   kind="fatal", calls=(1,))], True),
    "fatal_scan": (dict(), [dict(site="rx.stream_chunk_multi",
                                 kind="fatal", calls=(1,))], False),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_injected_fault_equals_reference(fleet, plan):
    # every plan is survived with the uninterrupted frames, by the
    # reference's route: the same retries, the same degraded twin; and
    # a fleet held to the card's rule (_strict) takes the same route
    _streams, slabs, want = fleet
    knobs, specs, vs_ref = PLANS[plan]
    runs = [(framebatch, faults, telemetry, {"device": "cpu"}, strict)
            for strict in (False, True)]
    if vs_ref:
        runs.append((jfb, jfaults, jtm, {}, False))
    got = []
    for fb, fm, tm, kw, strict in runs:
        with fm.inject(*(fm.FaultSpec(**sp) for sp in specs),
                       seed=3) as p, tm.collect() as reg:
            msr = fb.MultiStreamReceiver(S, **GEO, **knobs, **kw)
            msr._strict = strict
            frames = run(msr, slabs)
        got.append((frames, tuple(msr.stats), list(p.fired), counters(reg)))
    (_f, st, fired, cnt), *others = got
    assert fired and st[-1] == plan.startswith("fatal")     # degraded
    for frames, *rest in got:
        assert rest == [st, fired, cnt]
        for i in range(S):
            same_frames(frames[i], want[i])
