"""The card's rule on the port's S-stream fleet, on the CPU: a fleet held
to it (``_strict``, as on a CUDA device) raises on a real failure of the
decode, the scan, the host read or a per-capture window, and degrades or
counts nothing; under ``watchdog_s`` every launch runs on the caller's
thread, and a host read that never completes raises ``DispatchTimeout``
(test_torch_fleet.py's geometry and streams). The loopback link and the
BER sweep keep the same rule: on a CUDA device only an injected fault
degrades them.
"""

import threading

import pytest
import torch

from test_torch_fleet import GEO, S, fleet_streams, same_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fleet_state import port, run, slabs_of
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy import link
from ziria_tpu_torch.runtime import resilience
from ziria_tpu_torch.utils import faults, telemetry


@pytest.fixture(scope="module")
def fleet():
    streams, _starts = fleet_streams()
    slabs = slabs_of(streams)
    return streams, slabs, run(port(), slabs)


@pytest.mark.parametrize("site", ["decode", "scan", "read", "window"])
def test_card_rule_real_failure_raises(fleet, monkeypatch, site):
    # a fleet held to the card's rule: a real failure propagates, and
    # nothing degrades or is counted as contained
    _streams, slabs, _want = fleet
    msr = port(sanitize=True)
    msr._strict = True

    def boom(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")
    if site == "decode":
        monkeypatch.setattr(msr, "_decode", boom)
    elif site == "scan":
        monkeypatch.setattr(msr, "_scan", boom)
    elif site == "read":
        monkeypatch.setattr(framebatch, "_pull_chunk", boom)
    else:
        msr._mark_degraded(scan=False)
        monkeypatch.setattr(framebatch._rx, "receive", boom)
    with telemetry.collect() as reg, \
            pytest.raises(RuntimeError, match="illegal memory access"):
        run(msr, slabs)
    assert msr.stats.lane_blowups == 0
    assert msr.stats.degraded == (site == "window")
    assert not [k for k in reg.counters() if k.startswith("resilience.")
                and k not in ("resilience.fatal", "resilience.degraded")]


class _Silent:
    """A device event that never completes."""

    def query(self):
        return False

    def synchronize(self):     # pragma: no cover - the watchdog polls
        raise AssertionError("waited without the watchdog")


def test_watchdog_on_the_callers_thread(fleet, monkeypatch):
    _streams, slabs, want = fleet
    threads = set()
    msr = port(watchdog_s=0.05)
    for name in ("_scan", "_decode"):
        fn = getattr(msr, name)

        def wrapped(*a, fn=fn):
            threads.add(threading.get_ident())
            return fn(*a)
        monkeypatch.setattr(msr, name, wrapped)
    with faults.inject(faults.FaultSpec("rx.stream_*_multi", "hang",
                                        every=2, delay_s=0.2)) as p:
        frames = run(msr, slabs)
    assert len(p.fired) >= 2 and {site for site, _k, _i in p.fired} == \
        {"rx.stream_chunk_multi", "rx.stream_decode_multi"}
    assert threads == {threading.get_ident()}
    for i in range(S):
        same_frames(frames[i], want[i])
    # a device that stops answering: the host read times out and, on
    # the card, raises DispatchTimeout to the caller
    monkeypatch.setattr(framebatch, "_to_host", lambda t: (t, _Silent()))
    msr = port(watchdog_s=0.05)
    msr._strict = True
    with pytest.raises(resilience.DispatchTimeout, match="0.05s watchdog"):
        run(msr, slabs)
    assert not msr.stats.degraded


@pytest.mark.parametrize("site", ["link.fused", "link.sweep"])
def test_card_rule_only_an_injected_fault_degrades(site):
    """The link's and the sweep's rule on a CUDA device: an injected
    fault (through the guarded dispatch) degrades and is counted; a
    real failure, bare or through the dispatch, raises, and nothing is
    counted for it. Off the card a real failure degrades too, as in the
    reference."""
    cuda = torch.device("cuda")
    counter = site + "_degraded"
    real = RuntimeError("CUDA error: an illegal memory access")
    with telemetry.collect() as reg:
        link._degrade_or_raise(resilience.DispatchFailed(
            site, 1, "fatal", faults.InjectedFatalError(site)), cuda,
            counter)
        assert reg.counters()[counter] == 1
        for e in (real, resilience.DispatchFailed(site, 1, "fatal", real)):
            with pytest.raises(RuntimeError, match="illegal memory access"):
                link._degrade_or_raise(e, cuda, counter)
        link._degrade_or_raise(real, torch.device("cpu"), counter)
    assert reg.counters()[counter] == 2
