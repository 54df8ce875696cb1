"""The port's loopback link (ziria_tpu_torch/phy/link.py) against the
JAX package's, mode for mode: fused, staged and per frame, on 8 lanes
over the 8 rates with FCS appended and checked.

The lanes run at 25-30 dB but for one swamped lane (-25 dB: no
detect) and three at 2 dB: at seed 5 one of those acquires a SIGNAL
that claims more samples than the capture holds (truncated) and two
decode with a bad FCS. Both packages draw the same noise (utils/
threefry), within 2 ulp, so every lane's RxResult equals the
reference's field for field; no decision flips at this seed. The
fused link's classifier is held branch for branch against the port's
host tree and the reference's graph. An injected fault degrades the
fused link to the staged one, as in the reference (on a CUDA device
nothing else does: tests/test_torch_fleet_card.py)."""

import itertools

import numpy as np
import pytest
import torch

from tests.test_torch_fleet import one_thread  # noqa: F401 - autouse
from ziria_tpu.phy import link as jlink
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu_torch.phy import link as tlink
from ziria_tpu_torch.phy.wifi import rx as trx
from ziria_tpu_torch.phy.wifi.params import RATES, n_symbols
from ziria_tpu_torch.utils import faults, geometry, telemetry

LENS = (16, 10, 16, 5, 16, 12, 9, 16)
MBPS = tuple(sorted(RATES))
CFO = tuple((-1) ** k * 1e-4 * (k + 1) for k in range(8))
DELAY = tuple(20 + 17 * k for k in range(8))
SNRS = (25.0, 30.0, -25.0, 28.0, 2.0, 2.0, 2.0, 26.0)
KW = dict(snr_db=SNRS, cfo=CFO, delay=DELAY, seed=5, add_fcs=True,
          check_fcs=True)
# G: right with a good FCS, b: decoded with a bad FCS, F: failed
# (no detect), T: truncated (rate and length parsed, no payload)
WANT_CLASSES = "GGFGbbTG"


@pytest.fixture(scope="module")
def psdus():
    rng = np.random.default_rng(20260803)
    return [rng.integers(0, 256, n).astype(np.uint8) for n in LENS]


@pytest.fixture(scope="module")
def reference(psdus):
    """The reference's batched link, one run a mode (fused, staged),
    made when a test first asks for that mode."""
    runs = {}

    def run(fused: bool):
        if fused not in runs:
            runs[fused] = jlink.loopback_many(psdus, MBPS, fused=fused, **KW)
        return runs[fused]
    return run


def _classes(results) -> str:
    return "".join("T" if not r.ok and r.rate_mbps else
                   "F" if not r.ok else "G" if r.crc_ok else "b"
                   for r in results)


def _same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.ok, a.rate_mbps, a.length_bytes, a.crc_ok) == \
            (b.ok, b.rate_mbps, b.length_bytes, b.crc_ok), i
        assert np.array_equal(np.asarray(a.psdu_bits),
                              np.asarray(b.psdu_bits)), i


@pytest.mark.parametrize("fused", [True, False])
def test_batched_link_equals_reference(psdus, reference, fused):
    """Fused and staged: every lane's RxResult equals the reference's
    same mode, the lane classes are as listed, the right lanes carry
    their PSDU, and no mode degraded."""
    with telemetry.collect() as reg:
        got = tlink.loopback_many(psdus, MBPS, fused=fused, device="cpu",
                                  **KW)
    assert not [k for k in reg.counters() if "degraded" in k]
    assert _classes(got) == WANT_CLASSES
    _same(got, reference(fused))
    for i, r in enumerate(got):
        if _classes([r]) == "G":
            body = np.packbits(r.psdu_bits, bitorder="little")
            assert np.array_equal(body[:LENS[i]], psdus[i])
    if fused:
        _same(got, tlink.loopback_many(psdus, MBPS, fused=False,
                                       device="cpu", **KW))


def test_injected_fault_degrades_fused_to_staged(psdus, reference):
    """A fault injected at the fused pass degrades the batch to the
    staged link: the reference's staged RxResults, the degrade counted
    and the gauge set; the next clean run clears the gauge."""
    with telemetry.collect() as reg, faults.inject(
            faults.FaultSpec("link.fused", "fatal", calls=(0,))) as plan:
        got = tlink.loopback_many(psdus, MBPS, device="cpu", **KW)
        gauge = reg.gauge(telemetry.GAUGE_METRIC, site="link.degraded_mode")
        assert gauge.last == 1.0
        tlink.loopback_many(psdus[:1], MBPS[:1], snr_db=25.0, seed=5,
                            device="cpu")
        assert gauge.last == 0.0
    assert len(plan.fired) == 1
    assert reg.counters()["link.fused_degraded"] == 1
    _same(got, reference(False))


def test_perframe_link_equals_reference(psdus):
    """The per-frame oracle (encode_frame, impair_one, rx.receive with
    the scan decoder) equals the reference's per-frame mode and the
    port's batched link, lane for lane."""
    got = tlink.loopback_many(psdus, MBPS, batched_tx=False, device="cpu",
                              **KW)
    assert _classes(got) == WANT_CLASSES
    _same(got, jlink.loopback_many(psdus, MBPS, batched_tx=False, **KW))
    _same(got, tlink.loopback_many(psdus, MBPS, device="cpu", **KW))


def test_link_modes_knobs_and_profiles(psdus, monkeypatch):
    """Within the port, at 25 dB: fused_demap, radix 4, sco_track with
    a profiled channel (urban and hostile lanes) and a Geometry's knobs
    give the
    same RxResults fused, staged and per frame; the knobs' readers and
    the argument errors."""
    kw = dict(KW, snr_db=25.0)
    prof = ["urban", "flat", "hostile", "mild"]
    for knobs in (dict(fused_demap=True), dict(viterbi_radix=4),
                  dict(channel_profile=prof, sco_track=True),
                  dict(geometry=geometry.Geometry(fused_demap=True))):
        fu = tlink.loopback_many(psdus, MBPS, device="cpu", **kw, **knobs)
        _same(tlink.loopback_many(psdus, MBPS, fused=False, device="cpu",
                                  **kw, **knobs), fu)
        _same(tlink.loopback_many(psdus, MBPS, batched_tx=False,
                                  device="cpu", **kw, **knobs), fu)
        # a 48 Mbit/s frame through the hostile profile (lane 6) fails
        # its FCS in every mode; every other lane is right
        assert all(r.ok and r.crc_ok for i, r in enumerate(fu)
                   if "channel_profile" not in knobs
                   or prof[i % 4] != "hostile"), knobs
    monkeypatch.setenv("ZIRIA_FUSED_LINK", "0")
    assert not tlink.fused_link_enabled()
    assert tlink.fused_link_enabled(True)
    monkeypatch.delenv("ZIRIA_FUSED_LINK")
    assert tlink.fused_link_enabled()
    assert tlink.loopback_many([], [], device="cpu") == []
    with pytest.raises(ValueError):
        tlink.loopback_many(psdus[:2], MBPS[:3], device="cpu")
    with pytest.raises(ValueError):
        tlink.loopback_many(psdus[:2], MBPS[:2], delay=-1, device="cpu")
    # the sweep with its lanes split over two CPU entries counts what
    # the one-device sweep counts; lanes that do not divide the mesh
    # are refused
    from ziria_tpu_torch.parallel.mesh import Mesh
    two = Mesh(["cpu"] * 2, ("dp",))
    frames = np.stack([p[:8] for p in psdus[:3]])
    np.testing.assert_array_equal(
        tlink.sweep_ber_sharded(frames[:2], [54], [4.0], [3], mesh=two,
                                device="cpu"),
        tlink.sweep_ber(frames[:2], [54], [4.0], [3], device="cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        tlink.sweep_ber_sharded(frames, [6], [0.0], [0], mesh=two,
                                device="cpu")


def test_classify_graph_every_branch():
    """The tensor classifier equals the port's host tree and the
    reference's graph branch for branch: no detect, short capture,
    flipped parity, unknown rate, truncated, decodable."""
    cases = list(itertools.product(
        (False, True), (0, 200, 400, 1040, 4096),
        (0b1101, 0b0011, 0b0000, 0b1110, 15), (0, 5, 16, 400, 4095),
        (False, True)))
    found, avail, rb, ln, pk = (np.asarray(v) for v in zip(*cases))
    got = [t.numpy() for t in trx.classify_acquire_graph(
        *(torch.from_numpy(a) for a in (found, avail, rb, ln, pk)))]
    ref = [np.asarray(a) for a in jrx.classify_acquire_graph(
        found, avail, rb, ln, pk)]
    assert np.array_equal(got[0], ref[0])
    for g, r in zip(got[1:3], ref[1:3]):
        assert np.array_equal(g, r)
    live = got[0] != trx.ACQ_FAIL
    assert np.array_equal(got[3][live], ref[3][live])
    statuses = set()
    for k, (f, av, r, l, p) in enumerate(cases):
        res, ok = trx._classify_acquire(f, av, r, l, p)
        if ok is not None:
            want = (trx.ACQ_DECODABLE, ok[0], l, ok[1])
        elif res.rate_mbps:
            want = (trx.ACQ_TRUNCATED, res.rate_mbps, res.length_bytes,
                    n_symbols(res.length_bytes, RATES[res.rate_mbps]))
        else:
            want = (trx.ACQ_FAIL, 0, 0, 0)
        have = (int(got[0][k]), int(got[1][k]), int(got[2][k]),
                int(got[3][k]) if want[0] != trx.ACQ_FAIL else 0)
        assert have == want, (cases[k], have, want)
        statuses.add(have[0])
    assert statuses == {trx.ACQ_FAIL, trx.ACQ_TRUNCATED, trx.ACQ_DECODABLE}
