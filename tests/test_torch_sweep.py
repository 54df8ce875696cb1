"""The port's BER sweep, perfect-sync BER loopback and stream stimulus
(ziria_tpu_torch/phy/link.py, runtime/serve.synth_load) against the
JAX package's.

Error counts are integers: the port's equal the reference's count for
count, with and without a profile axis, and equal a loop of the port's
``loopback_ber_bits`` (the sweep's twin). The noise is the reference's
own (utils/threefry; normals within 2 ulp), so the streams agree within
ATOL, a few float32 ulps at unit frame power; starts, arrival ticks
and slab lengths are equal."""

import numpy as np
import pytest

from tests.test_torch_fleet import one_thread  # noqa: F401 - autouse
from ziria_tpu.phy import link as jlink
from ziria_tpu.runtime import serve as jserve
from ziria_tpu_torch.phy import link as tlink
from ziria_tpu_torch.runtime import serve as tserve
from ziria_tpu_torch.utils import faults, telemetry

ATOL = 3e-6
B, NB = 8, 24
RATES = (6, 54)
SNRS = (-2.0, 8.0)
SEEDS = (7,)


@pytest.fixture(scope="module")
def psdus():
    rng = np.random.default_rng(9)
    return rng.integers(0, 256, (B, NB)).astype(np.uint8)


def _want_bits(psdus):
    return np.unpackbits(psdus, axis=1, bitorder="little")


@pytest.fixture(scope="module")
def reference(psdus):
    """The reference's sweep at 6 Mbit/s with a profile axis (flat,
    hostile): one compile serves both tests; its flat column is its
    unprofiled sweep. (Every rate's decode is held to the reference's
    in tests/test_torch_link.py; 54 Mbit/s here is held to the port's
    loop.)"""
    return jlink.sweep_ber(psdus, RATES[:1], SNRS, SEEDS,
                           profiles=("flat", "hostile"))


def test_sweep_equals_reference_and_loop(psdus, reference):
    """sweep_ber: counts equal the reference's and a loop of the port's
    loopback_ber_bits (a host read a point); -2 dB errs at 6 Mbit/s and
    8 dB is clean there; nothing degraded."""
    with telemetry.collect() as reg:
        got = tlink.sweep_ber(psdus, RATES, SNRS, SEEDS, device="cpu")
    assert not [k for k in reg.counters() if "degraded" in k]
    assert got.shape == (2, 2, 1) and got.dtype == np.int64
    assert np.array_equal(got[:1], reference[:, 0])
    want = _want_bits(psdus)
    for ri, m in enumerate(RATES):
        for si, s in enumerate(SNRS):
            bits = tlink.loopback_ber_bits(psdus, m, s, SEEDS[0],
                                           device="cpu")
            assert int((bits != want).sum()) == int(got[ri, si, 0])
    assert got[0, 0, 0] > 0 and got[0, 1, 0] == 0


def test_sweep_profile_axis_and_ber_bits(psdus, reference):
    """The profile axis (flat, hostile) at 6 Mbit/s: counts equal the
    reference's, the flat column equal to the unprofiled sweep, the
    hostile column to loopback_ber_bits through the profile, batched and
    per frame."""
    got = tlink.sweep_ber(psdus, RATES[:1], SNRS, SEEDS,
                          profiles=("flat", "hostile"), device="cpu")
    assert got.shape == (1, 2, 2, 1)
    assert np.array_equal(got, reference)
    assert (got[:, 1] > got[:, 0]).any()
    want = _want_bits(psdus)
    for si, s in enumerate(SNRS):
        for batched in (True, False):
            bits = tlink.loopback_ber_bits(psdus, 6, s, SEEDS[0],
                                           profile="hostile",
                                           batched_tx=batched, device="cpu")
            assert int((bits != want).sum()) == int(got[0, 1, si, 0])
    with pytest.raises(ValueError):
        tlink.sweep_ber(psdus, RATES, SNRS, SEEDS, profiles=(),
                        device="cpu")


def test_injected_fault_degrades_the_sweep_to_its_loop(psdus, reference):
    """A fault injected at the sweep's device loop degrades it to the
    loop of loopback_ber_bits: counts equal the reference's, the
    degrade counted once. (On a CUDA device only an injected fault
    does: tests/test_torch_link.py, tests/test_torch_gpu.py.)"""
    with telemetry.collect() as reg, faults.inject(
            faults.FaultSpec("link.sweep", "fatal", calls=(0,))) as plan:
        got = tlink.sweep_ber(psdus, RATES[:1], SNRS, SEEDS,
                              profiles=("flat", "hostile"), device="cpu")
        assert reg.gauge(telemetry.GAUGE_METRIC,
                         site="link.degraded_mode").last == 1.0
    assert len(plan.fired) == 1
    assert reg.counters()["link.sweep_degraded"] == 1
    assert np.array_equal(got, reference)


def _same_streams(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, what
        assert float(np.abs(g - w).max()) <= ATOL, what


def test_stream_many_and_multi_against_reference():
    """stream_many (given gaps, a bursty profile) and
    stream_many_multi with arrival schedules: streams within ATOL,
    starts, ticks and slab lengths equal."""
    rng = np.random.default_rng(4)
    rates = [6, 24, 54, 12]
    psdus = [rng.integers(0, 256, 30).astype(np.uint8) for _ in rates]
    for kw in (dict(snr_db=15.0, cfo=0.002, delay=40, gaps=[100, 0, 333],
                    seed=8, channel_profile="bursty", add_fcs=True),):
        gs, gst = tlink.stream_many(psdus, rates, device="cpu", **kw)
        ws, wst = jlink.stream_many(psdus, rates, **kw)
        assert np.array_equal(gst, wst)
        _same_streams([gs], [ws], kw)
    per = [psdus[:2], [], psdus[1:2]]
    rper = [rates[:2], [], rates[1:2]]
    spec = tlink.ArrivalSpec(300, 1500, 0, 3)
    kw = dict(snr_db=[25.0, np.inf, 30.0], cfo=1e-4, delay=60,
              seed=11, add_fcs=True, arrival=spec,
              channel_profile=["flat", "urban"])
    gs, gst, gsch = tlink.stream_many_multi(per, rper, device="cpu", **kw)
    ws, wst, wsch = jlink.stream_many_multi(per, rper, **kw)
    _same_streams(gs, ws, "stream_many_multi")
    for a, b in zip(gst, wst):
        assert np.array_equal(a, b)
    for i, (g, w) in enumerate(zip(gsch, wsch)):
        assert [(t, s.shape[0]) for t, s in g] == \
            [(t, s.shape[0]) for t, s in w]
        assert np.array_equal(np.concatenate([s for _t, s in g]), gs[i])
    with pytest.raises(ValueError):
        tlink.stream_many([], [], snr_db=10.0, device="cpu")
    with pytest.raises(ValueError):
        tlink.arrival_schedule(gs[0], tlink.ArrivalSpec(5, 5), 0)


def test_synth_load_against_reference():
    """serve.synth_load with every misbehave mode: sessions, modes,
    ticks and slab lengths equal the reference's, slabs within ATOL
    with the NaN samples at the same places."""
    modes = {1: "nan", 2: "flood", 3: "stall", 4: "oversize"}
    # 30-byte PSDUs: the reference's encodes at 6, 12 and 24 Mbit/s are
    # those the stream test above compiled
    got = tserve.synth_load(5, frames_per_session=1, n_bytes=30, seed=5,
                            misbehave=modes, device="cpu")
    want = jserve.synth_load(5, frames_per_session=1, n_bytes=30, seed=5,
                             misbehave=modes)
    assert [(c.sid, c.mode, c.slo_s) for c in got] == \
        [(c.sid, c.mode, c.slo_s) for c in want]
    for g, w in zip(got, want):
        assert [(t, s.shape[0]) for t, s in g.schedule] == \
            [(t, s.shape[0]) for t, s in w.schedule]
        for (_t, gs), (_u, ws) in zip(g.schedule, w.schedule):
            assert np.array_equal(np.isnan(gs), np.isnan(ws))
            ok = ~np.isnan(ws)
            assert float(np.abs(gs[ok] - ws[ok]).max(initial=0.0)) <= ATOL
        _same_streams([g.stream], [w.stream], g.sid)
    with pytest.raises(ValueError):
        tserve.synth_load(1, misbehave={0: "nope"}, device="cpu")
