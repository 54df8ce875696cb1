"""The port's per-capture receiver ``rx.receive`` and its parts against
the JAX package, on the CPU (the ``receive_many`` knobs it brought are
in test_torch_knobs.py).

The captures are test_torch_rx.py's corpus, rebuilt from its seed: 16-byte
PSDUs at the 8 rates through the port's TX and a numpy channel (offset,
CFO, AWGN at 25 dB), a noise capture, a truncated one and one with a
bad SIGNAL parity. RxResults are compared field for field; the fused
decodes are held to the JAX *unfused* ones, the reference's own contract
for its fused front (its Pallas fused kernels take minutes in interpret
mode; test_torch_fused_decode.py holds them in its ``slow`` test).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_rx import N_BODY, RATES, _bad_parity_frame, _channel, close
from ziria_tpu.ops import ofdm as jofdm
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import rx, tx
from ziria_tpu_torch.utils import geometry


def t(x):
    return torch.from_numpy(np.array(x))


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        assert g.psdu_bits.dtype == np.asarray(w.psdu_bits).dtype
        np.testing.assert_array_equal(g.psdu_bits, np.asarray(w.psdu_bits))


@pytest.fixture(scope="module")
def corpus():
    """test_torch_rx.py's captures: 8 rates, then noise, truncated and
    bad-parity captures."""
    rng = np.random.default_rng(20261016)
    caps, psdus = [], []
    for k, m in enumerate(RATES):
        psdu = rng.integers(0, 256, N_BODY).astype(np.uint8)
        s = tx.encode_frame(psdu, m, add_fcs=True, device="cpu").numpy()
        caps.append(_channel(rng, s, int(rng.integers(5, 60)),
                             (-1) ** k * 1e-4 * (k + 1)))
        psdus.append(psdu)
    noise = _channel(rng, np.zeros((700, 2), np.float32), 0, 0.0)
    trunc = caps[4][:caps[4].shape[0] - 150]
    parity = _channel(rng, _bad_parity_frame(psdus[4]), 33, 2e-4)
    return caps + [noise, trunc, parity]


# 6, 24 and 54 Mbps, the truncated capture and the bad-parity one
RECEIVE_CASES = [0, 4, 7, 9, 10]


@pytest.fixture(scope="module")
def jax_receive(corpus):
    return [jrx.receive(corpus[i], check_fcs=True, fused_demap=False)
            for i in RECEIVE_CASES]


@pytest.mark.parametrize("fused", [False, True])
def test_receive_equals_reference_field_for_field(corpus, jax_receive,
                                                  fused):
    got = [rx.receive(corpus[i], check_fcs=True, fused_demap=fused,
                      device="cpu") for i in RECEIVE_CASES]
    _same_results(got, jax_receive)
    assert [g.ok for g in got] == [True, True, True, False, False]
    assert all(g.crc_ok for g in got[:3])


def test_receive_equals_receive_many_lane(corpus):
    # the per-capture path and the batched one agree lane for lane
    many = framebatch.receive_many(corpus, check_fcs=True, device="cpu")
    one = [rx.receive(c, check_fcs=True, device="cpu") for c in corpus]
    _same_results(one, many)


def test_acquire_frame_and_padded_segment_match_reference(corpus):
    for i in (0, 7, 8, 9):
        res, acq = rx._acquire_frame(corpus[i], device="cpu")
        jres, jacq = jrx._acquire_frame(corpus[i])
        assert (res is None) == (jres is None)
        if res is not None:
            assert res[:3] == jres[:3] and res[4] == jres[4]
            continue
        assert (acq.avail, acq.rate_mbps, acq.length_bytes, acq.n_sym) == \
            (jacq.avail, jacq.rate_mbps, jacq.length_bytes, jacq.n_sym)
        np.testing.assert_array_equal(acq.frame_np, jacq.frame_np)
        close(acq.eps, jacq.eps)
        nsb = geometry.sym_bucket(acq.n_sym)
        close(rx._padded_segment(acq, nsb, device="cpu"),
              jrx._padded_segment(jacq, nsb))


def test_bucket_rules_match_reference():
    for n in (1, 400, 511, 512, 513, 3000, 1 << 16):
        assert geometry.capture_bucket(n) == jrx._stream_bucket(n)
        x = np.ones((n, 2), np.float32)
        got, want = rx._bucket_pad(x), jrx._bucket_pad(x)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    for n_sym in (1, 4, 5, 9, 335):
        assert rx._sym_bucket(n_sym) == jrx._sym_bucket(n_sym)


def test_pilot_sco_track_matches_reference():
    # a per-subcarrier phase ramp growing over the symbols (the SCO
    # signature) on data and pilots, as tests/test_channel_profiles.py
    # builds it, plus noise and a common phase
    rng = np.random.default_rng(8)
    n_sym = 6
    syms = (rng.integers(0, 2, (3, n_sym, 48, 2)) * 2 - 1) \
        .astype(np.float32) / np.sqrt(2.0)
    pol = jofdm.PILOT_POLARITY[(np.arange(n_sym) + 1) % 127]
    pil = (jofdm.PILOT_VALS[None, :] * pol[:, None]).astype(np.float32)
    pilots = np.stack([pil, np.zeros_like(pil)], -1)[None].repeat(3, 0)
    slope = 0.004 * (1.0 + np.arange(n_sym))[None] * \
        np.asarray([1.0, -2.0, 0.5])[:, None]
    common = rng.uniform(-0.5, 0.5, (3, n_sym))

    def rot(x, k):
        th = slope[..., None] * k + common[..., None]
        c, s = np.cos(th), np.sin(th)
        return np.stack([x[..., 0] * c - x[..., 1] * s,
                         x[..., 0] * s + x[..., 1] * c], -1).astype(
                             np.float32)
    data = rot(syms, jofdm.DATA_SC.astype(np.float64))
    pilots = rot(pilots, jofdm.PILOT_SC.astype(np.float64))
    data += rng.normal(0, 0.01, data.shape).astype(np.float32)
    for sco in (False, True):
        want = jax.vmap(lambda d, p, s=sco: jrx.pilot_phase_correct(
            d, p, 1, sco_track=s))(data, pilots)
        got = rx.pilot_phase_correct(t(data), t(pilots), 1, sco_track=sco)
        close(got, want)
    # tracking removes the ramp
    err = np.abs(got.numpy() - syms).max()
    assert err < 0.1


def test_knob_readers_follow_the_environment(monkeypatch):
    for name, fn in (("ZIRIA_RX_SCO_TRACK", rx.sco_track_enabled),
                     ("ZIRIA_FUSED_DEMAP", rx.fused_demap_enabled)):
        monkeypatch.delenv(name, raising=False)
        assert fn() is False and fn(True) is True
        monkeypatch.setenv(name, "1")
        assert fn() is True and fn(False) is False
    monkeypatch.setenv("ZIRIA_BATCHED_ACQUIRE", "0")
    assert framebatch.batched_acquire_enabled() is False
    assert framebatch.batched_acquire_enabled(True) is True
    assert geometry.env_fused_demap() and geometry.env_sco_track()


def test_receive_cuda_device_raises_without_cuda(monkeypatch, corpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        rx.receive(corpus[0])


def test_private_steps_default_to_cuda(corpus):
    # like every entry point, the per-capture steps run on the card
    # unless the caller passes a device
    for fn in (rx._acquire_frame, rx._padded_segment):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    _res, acq = rx._acquire_frame(corpus[0], device="cpu")
    nsb = geometry.sym_bucket(acq.n_sym)
    if torch.cuda.is_available():
        assert rx._padded_segment(acq, nsb).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            rx._padded_segment(acq, nsb)
