"""The port's transmitter and batched receiver against the JAX package's,
on the CPU.

One module fixture builds the captures (the port's TX, a numpy channel:
offset, CFO, AWGN at 25 dB) and runs the JAX ``receive_many`` once:
interpret-mode Pallas and its compiles are the expensive part. Every
test then compares a piece of the port with the reference on those
captures: floats within rtol = atol = 1e-5 (the reference's own float32
agreement across programs), integers, bits and RxResults exact.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.ops import crc as jcrc
from ziria_tpu.phy.wifi import params as jparams, rx as jrx, tx as jtx
from ziria_tpu.utils.bits import np_bytes_to_bits
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import coding, interleave, modulate, ofdm
from ziria_tpu_torch.phy.wifi import params, rx, tx
from ziria_tpu_torch.utils import geometry

RATES = sorted(params.RATES)
N_BODY = 12                      # + 4 FCS bytes = 16-byte PSDUs


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _channel(rng, s, offset, eps, snr_db=25.0):
    """A frame behind `offset` silent samples, rotated by a CFO of
    `eps` rad/sample, plus complex AWGN at `snr_db` (unit signal
    power)."""
    z = np.zeros(offset + s.shape[0], np.complex128)
    z[offset:] = s[:, 0] + 1j * s[:, 1]
    z *= np.exp(1j * eps * np.arange(z.size))
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    z += sigma * (rng.normal(size=z.size) + 1j * rng.normal(size=z.size))
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _bad_parity_frame(psdu):
    """A 24 Mbps frame whose SIGNAL symbol is re-encoded with its
    even-parity bit flipped."""
    s = tx.encode_frame(psdu, 24, add_fcs=True, device="cpu")
    sig = tx.signal_field_bits(params.RATES[24], len(psdu) + 4)
    sig[17] ^= 1
    syms = modulate.modulate(interleave.interleave(
        coding.conv_encode(sig), 48, 1), 1)
    s[320:400] = ofdm.ofdm_modulate(ofdm.map_subcarriers(
        syms[None], symbol_index0=0))[0]
    return s.numpy()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(20261016)
    caps, psdus = [], []
    for k, m in enumerate(RATES):
        psdu = rng.integers(0, 256, N_BODY).astype(np.uint8)
        s = tx.encode_frame(psdu, m, add_fcs=True, device="cpu").numpy()
        caps.append(_channel(rng, s, int(rng.integers(5, 60)),
                             (-1) ** k * 1e-4 * (k + 1)))
        psdus.append(psdu)
    noise = _channel(rng, np.zeros((700, 2), np.float32), 0, 0.0)
    trunc = caps[4][:caps[4].shape[0] - 150]      # DATA cut short
    parity = _channel(rng, _bad_parity_frame(psdus[4]), 33, 2e-4)
    caps += [noise, trunc, parity]
    ref = jfb.receive_many(caps, check_fcs=True)
    got = framebatch.receive_many(caps, check_fcs=True, device="cpu")
    return caps, psdus, ref, got


@pytest.mark.parametrize("mbps", RATES)
def test_encode_frame_matches_reference(mbps):
    rng = np.random.default_rng(mbps)
    psdu = rng.integers(0, 256, 21).astype(np.uint8)
    bits = jcrc.append_crc32(np_bytes_to_bits(psdu))
    want = jtx.encode_frame_bits(np.asarray(bits), jparams.RATES[mbps])
    got = tx.encode_frame(psdu, mbps, add_fcs=True, device="cpu")
    assert got.shape == want.shape
    close(got, want)


def test_signal_field_bits_match_reference():
    for m in RATES:
        for n in (1, 100, 4095):
            same(tx.signal_field_bits(params.RATES[m], n),
                 jtx.signal_field_bits(jparams.RATES[m], n))


def test_receive_many_equals_reference_field_for_field(corpus):
    _caps, _psdus, ref, got = corpus
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (r.ok, r.rate_mbps, r.length_bytes, r.crc_ok)
        assert g.psdu_bits.dtype == np.asarray(r.psdu_bits).dtype
        same(g.psdu_bits, r.psdu_bits)


def test_receive_many_decodes_every_class(corpus):
    _caps, psdus, _ref, got = corpus
    for g, m, p in zip(got, RATES, psdus):
        assert g.ok and g.rate_mbps == m and g.length_bytes == N_BODY + 4
        assert g.crc_ok is True
        same(g.psdu_bits[:8 * N_BODY], np_bytes_to_bits(p))
    noise, trunc, parity = got[8:]
    assert not noise.ok and noise.rate_mbps == 0
    assert not trunc.ok and trunc.rate_mbps == 24 \
        and trunc.length_bytes == N_BODY + 4
    assert not parity.ok and parity.rate_mbps == 0


@pytest.fixture(scope="module")
def acquired(corpus):
    """The port's and the reference's acquire and gather outputs on the
    corpus (the reference's at the geometry its receive_many compiled)."""
    caps = corpus[0]
    port = rx.acquire_many(caps, device="cpu")
    ref = jrx.acquire_many(caps)
    jl = [b for _i, b in ref[2]]
    nsb = max(geometry.sym_bucket(b.n_sym) for b in jl)
    segs = np.asarray(jrx.gather_segments_many(ref[1], jl, nsb))
    # acquire_many's padded per-row capture lengths and detection caps
    n_valid = [c.shape[0] for c in caps]
    nv = np.full(ref[1].shape[0], n_valid[0], np.int32)
    nv[:len(n_valid)] = n_valid
    lim = np.asarray([geometry.capture_bucket(v) for v in nv], np.int32)
    return port, ref, nsb, segs, nv, lim


def test_acquire_many_matches_reference(acquired):
    (results, x_dev, lanes), (jresults, jx, jlanes), *_rest = acquired
    same(x_dev, jx)
    assert [r is None for r in results] == [r is None for r in jresults]
    for r, j in zip(results, jresults):
        if r is not None:
            assert r[:3] == j[:3] and r[4] == j[4]
    assert [i for i, _ in lanes] == [i for i, _ in jlanes]
    for (_i, a), (_j, b) in zip(lanes, jlanes):
        assert (a.row, a.start, a.avail, a.rate_mbps, a.length_bytes,
                a.n_sym) == (b.row, b.start, b.avail, b.rate_mbps,
                             b.length_bytes, b.n_sym)
        close(a.eps, b.eps)


def test_acquire_frame_graph_matches_reference(acquired):
    (_r, x_dev, _l), (_jr, jx, _jl), _nsb, _segs, nv, lim = acquired
    got = rx.acquire_frame_graph(x_dev, t(nv).long(), t(lim).long())
    want = jrx._jit_acquire_many()(jx, nv, lim)
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 2:
            close(g, w)                                   # eps
        else:
            same(g, w)


def test_gather_matches_reference(acquired):
    (_r, x_dev, lanes), _ref, nsb, segs, *_rest = acquired
    close(rx.gather_segments_many(x_dev, [a for _i, a in lanes], nsb), segs)


def test_signal_and_symbol_fronts_match_reference(acquired):
    _port, _ref, nsb, segs, *_rest = acquired
    heads = segs[:, :400]
    for g, w in zip(rx.decode_signal(t(heads)),
                    jax.vmap(jrx.decode_signal)(heads)):
        same(g, w)
    data, gain = rx._front_symbols(t(segs), nsb)
    jdata, jgain = jax.vmap(lambda f: jrx._front_symbols(f, nsb))(segs)
    close(data, jdata)
    close(gain, jgain)


def test_decode_front_matches_reference_each_rate(acquired):
    _port, (_jr, _jx, jlanes), nsb, segs, *_rest = acquired
    for k, (_i, b) in enumerate(jlanes):
        want = jrx._decode_front(segs[k], jparams.RATES[b.rate_mbps], nsb)
        got = rx._decode_front(t(segs[k:k + 1]), params.RATES[b.rate_mbps],
                               nsb)[0]
        close(got, want)


def test_equalize_guard_and_pilots_match_reference():
    """On a channel with deep nulls on two data bins and one pilot bin,
    so the bounded-|H| guard trips."""
    rng = np.random.default_rng(9)
    bins = rng.normal(size=(3, 5, 64, 2)).astype(np.float32)
    H = rng.normal(size=(3, 64, 2)).astype(np.float32)
    H[:, [3, 40, 21]] *= 1e-3
    eq = jax.vmap(jrx.equalize)(bins, H)
    close(rx.equalize(t(bins), t(H)), eq)
    data, pilots = jax.vmap(jrx.ofdm.extract_subcarriers)(eq)
    want = jax.vmap(jrx.guard_subcarriers)(data, pilots, H)
    got = rx.guard_subcarriers(t(data), t(pilots), t(H))
    for g, w in zip(got, want):
        close(g, w)
    assert not np.asarray(want[2])[:, [26, 2]].any()      # nulled bins
    close(rx.pilot_phase_correct(got[0], got[1], 1),
          jax.vmap(lambda d, p: jrx.pilot_phase_correct(d, p, 1))(
              want[0], want[1]))


def test_classify_acquire_matches_reference():
    for found in (False, True):
        for avail in (300, 400, 640, 5000):
            for rb in (0b1101, 0b0011, 0b0000, 0b1001):
                for parity in (False, True):
                    a = rx._classify_acquire(found, avail, rb, 100, parity)
                    b = jrx._classify_acquire(found, avail, rb, 100, parity)
                    assert (a[1] == b[1])
                    if a[0] is None:
                        assert b[0] is None
                    else:
                        assert a[0][:3] == b[0][:3] and a[0][4] == b[0][4]


def test_crc_many_matches_reference(corpus):
    rng = np.random.default_rng(3)
    clear = rng.integers(0, 2, (4, 16 + 8 * 40)).astype(np.uint8)
    body = rng.integers(0, 2, 8 * 20).astype(np.uint8)
    clear[1, 16:16 + 192] = np.asarray(jcrc.append_crc32(body))
    n = np.asarray([192, 192, 24, 320], np.int32)
    same(rx.crc_psdu_many_graph(t(clear), t(n)),
         jrx.crc_psdu_many_graph(clear, n))


@pytest.mark.parametrize("entry,kwargs", [
    pytest.param("receive_many", {"viterbi_window": 1024},
                 id="viterbi_window-1024"),
    pytest.param("receive_many", {"viterbi_metric": "int16"},
                 id="viterbi_metric-int16"),
    pytest.param("receive_many", {"viterbi_radix": 4}, id="viterbi_radix-4"),
    pytest.param("receive_many", {"fused_demap": True, "viterbi_radix": 4},
                 id="fused_demap-radix4"),
    pytest.param("receive", {"fxp": True}, id="receive-fxp"),
    pytest.param("receive", {"viterbi_metric": "int16"},
                 id="receive-viterbi_metric-int16"),
    pytest.param("receive", {"viterbi_window": 1024},
                 id="receive-viterbi_window-1024"),
    pytest.param("receive", {"fused_demap": True, "viterbi_radix": 4},
                 id="receive-fused_demap-radix4"),
    pytest.param("receive", {"geometry": geometry.Geometry(
        viterbi_metric="int16")}, id="receive-geometry")])
def test_unported_knobs_raise(corpus, entry, kwargs):
    """Every knob once refused runs now, ``fxp`` too (the fixed-point
    interior, held to the JAX one in test_torch_rx_fxp.py), a
    ``geometry`` object's knobs too: each is held against the port
    itself on the corpus, with no JAX call (test_torch_modes*.py hold
    them against the reference, test_torch_stream_state.py the
    geometry). Radix 4 equals radix 2 field for field; a window, an
    int16 metric and the fixed-point interior decode every lane to the
    default's payload."""
    def run(**kw):
        if entry == "receive_many":
            return framebatch.receive_many(corpus[0], check_fcs=True,
                                           device="cpu", **kw)
        return [rx.receive(corpus[0][0], check_fcs=True, device="cpu",
                           **kw)]
    got = run(**kwargs)
    if kwargs.get("viterbi_radix") == 4:
        want = run(**dict(kwargs, viterbi_radix=2))
        for g, w in zip(got, want):
            assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
                (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
            same(g.psdu_bits, w.psdu_bits)
    else:
        want = corpus[3] if entry == "receive_many" else run()
        assert [g.ok for g in got] == [w.ok for w in want]
        for g, w in zip(got, want):
            if w.ok:
                assert g.crc_ok is True and w.crc_ok is True
                same(g.psdu_bits, w.psdu_bits)
    assert len(got) == len(want) and got[0].ok


def test_default_knob_values_run(corpus):
    got = framebatch.receive_many(
        corpus[0][:1], device="cpu", viterbi_window=0,
        viterbi_metric="float32", viterbi_radix=2, batched_acquire=True,
        sco_track=False, fused_demap=False)
    assert got[0].ok and got[0].rate_mbps == 6


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        framebatch.receive_many([np.zeros((600, 2), np.float32)])
