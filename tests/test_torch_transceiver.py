"""The port's transceiver and MAC-lite (ziria_tpu_torch/phy/wifi/
transceiver.py) against the JAX package's, on the CPU: the PSDU bytes of
MAC frames and their parse, and ``run_link``'s outcomes (payloads
delivered, ACKs, retransmits, dedups, give-ups, every counter and both
stations' clocks) over the channels of ``tests/test_transceiver.py``: a
perfect one, one that loses the first DATA frame, one that loses the
first ACK, a dead one (the retry limit, then the step budget), a noisy
one with idle air and CFO, and fixed-point stations. Each scenario runs
once in each package with the same channel (numpy draws seeded by the
transmission index).
"""

import numpy as np

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.phy.wifi import transceiver as R_trx
from ziria_tpu_torch.phy.wifi import transceiver as trx


def _lose(ks):
    def channel(samples, k):
        return np.zeros_like(samples) if k in ks else samples
    return channel


def _dead(samples, _k):
    return np.zeros_like(samples)


def _noisy(samples, k):
    """Idle air around the frame, a small CFO and AWGN at 18 dB: numpy
    draws seeded by k (the same in both packages)."""
    rng = np.random.default_rng(1000 + k)
    s = np.asarray(samples, np.float32)
    x = np.zeros((s.shape[0] + 244, 2), np.float32)
    x[180:180 + s.shape[0]] = s
    x += rng.normal(0, 10 ** (-28 / 20) / np.sqrt(2), x.shape)
    z = (x[:, 0] + 1j * x[:, 1]) * np.exp(1j * 0.0012 * np.arange(len(x)))
    z += (rng.normal(size=z.size) + 1j * rng.normal(size=z.size)) \
        * (10 ** (-18 / 20) / np.sqrt(2))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


# name -> (station a kwargs, station b kwargs, [(payloads, channel,
# run_link kwargs), ...])
SCENARIOS = {
    "perfect": (dict(rate_mbps=24), {}, [
        ([b"frame-one", b"frame-two longer payload", b"x"], None, {})]),
    "lost_data": (dict(rate_mbps=12), {}, [
        ([b"payload"], _lose({0}), {})]),
    "lost_ack": (dict(rate_mbps=12), {}, [
        ([b"only-once"], _lose({1}), {})]),
    "retry_limit": (dict(rate_mbps=12, max_tries=2), {}, [
        ([b"void"], _dead, {}), ([b"after"], None, {})]),
    "step_budget": (dict(rate_mbps=12, max_tries=100), {}, [
        ([b"lost", b"also-lost"], _dead, dict(max_steps=3))]),
    "noisy": (dict(rate_mbps=24), {}, [
        ([b"noisy link frame", b"second"], _noisy, {})]),
    "fxp": (dict(rate_mbps=24, fxp=True), dict(fxp=True), [
        ([b"integer frame one", b"and two"], None, {}),
        ([b"lossy"], _lose({0, 3}), {})]),
}


def _outcome(a, b):
    return dict(delivered=list(b.delivered), acked=list(a.acked),
                failed=list(a.failed), a=dict(a.counters),
                b=dict(b.counters), now=(a.now, b.now))


def _run(mod, name, **dev):
    ka, kb, legs = SCENARIOS[name]
    a = mod.Station(addr=1, **ka, **dev)
    b = mod.Station(addr=2, **kb, **dev)
    for payloads, channel, kw in legs:
        mod.run_link(a, b, payloads,
                     channel=channel or mod.perfect_channel, **kw)
    return _outcome(a, b)


def _same_outcome(name):
    """The scenario's outcome in the port equals the reference's."""
    got = _run(trx, name, device="cpu")
    assert got == _run(R_trx, name), name
    return got


def _payloads(got):
    return [p for _s, p in got["delivered"]]


def test_perfect_link_and_fxp_stations():
    """A perfect channel, and fixed-point stations on it and on a
    channel that loses the first DATA frame and the second ACK."""
    got = _same_outcome("perfect")
    assert _payloads(got) == SCENARIOS["perfect"][2][0][0]
    assert got["acked"] == [0, 1, 2] and got["a"]["retries"] == 0
    got = _same_outcome("fxp")
    assert _payloads(got) == [b"integer frame one", b"and two", b"lossy"]
    assert got["a"]["retries"] >= 1 and not got["failed"]


def test_lost_data_and_lost_ack():
    """A lost DATA frame is retransmitted; a lost ACK makes the receiver
    re-ACK a duplicate without delivering it twice."""
    got = _same_outcome("lost_data")
    assert _payloads(got) == [b"payload"] and got["a"]["retries"] == 1
    got = _same_outcome("lost_ack")
    assert _payloads(got) == [b"only-once"]
    assert got["b"]["dups"] == 1 and got["b"]["rx_data"] == 2


def test_retry_limit_and_step_budget():
    """A dead channel: the sender gives up at its retry limit (a later
    frame still goes through) or when run_link's step budget runs out."""
    got = _same_outcome("retry_limit")
    assert got["failed"] == [0] and got["a"]["drops"] == 1
    assert _payloads(got) == [b"after"]
    got = _same_outcome("step_budget")
    assert got["failed"] == [0, 1] and got["a"]["drops"] == 2


def test_noisy_link():
    """Idle air, CFO and AWGN on every transmission, both directions."""
    got = _same_outcome("noisy")
    assert _payloads(got) == [b"noisy link frame", b"second"]
    assert not got["failed"]


def test_mac_frames_equal_the_references():
    """PSDU bytes of DATA and ACK frames, their parse, and the parse's
    CRC rejection of a corrupted frame."""
    for args in ((trx.TYPE_DATA, 7, 2, 1, b"hello"),
                 (trx.TYPE_ACK, 3, 2, 1, b""),
                 (trx.TYPE_DATA, 300, 9, 4, bytes(range(200)))):
        got = trx.mac_frame_psdu(*args)
        want = R_trx.mac_frame_psdu(*args)
        np.testing.assert_array_equal(got, want)
        fr = trx.MacFrame.parse(got)
        assert fr == trx.MacFrame(args[0], args[1] & 0xFF, args[2],
                                  args[3], args[4])
        bad = got.copy()
        bad[1] ^= 0x40
        assert trx.MacFrame.parse(bad) is None
        assert R_trx.MacFrame.parse(bad) is None
    assert trx.MacFrame.parse(np.zeros(7, np.uint8)) is None
    a = trx.Station(addr=1, rate_mbps=6, device="cpu")
    a.send(bytes(1000), dst=2)        # longer on the air than ACK_TIMEOUT
    assert a._pending.deadline > a.now and a.poll() is None
