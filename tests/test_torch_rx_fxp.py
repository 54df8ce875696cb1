"""The port's fixed-point receive interior (ziria_tpu_torch/phy/wifi/
rx_fxp.py) and ``rx.receive(fxp=True)`` against the JAX package's, on the
CPU, bit for bit: the integer front's LLRs at all 8 rates, the per-frame
decodes (scan decoder) exact and bucketed, the batched decode exact and
windowed (the port on the plain ACS and traceback, the reference on its
Pallas kernels in interpret mode, as its own tests run it), and the
per-capture receiver field for field on impaired captures, a capture
with no frame, one with a NaN sample and a frame with a bad FCS. Frames
come from the port's TX and a seeded numpy channel; both packages get
the same quantized input. No tolerance: this path is exact.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.phy.wifi import rx as R_rx, rx_fxp as R_fxp
from ziria_tpu_torch.phy import channel
from ziria_tpu_torch.phy.wifi import rx, rx_fxp, tx
from ziria_tpu_torch.phy.wifi.params import RATES, n_symbols

RATES_ALL = sorted(RATES)
N_BYTES = 40
# the batch: BATCH frames at BATCH_MBPS, long enough that BATCH_WINDOW
# (plus twice the 96-step overlap) really cuts windows
BATCH, BATCH_MBPS, BATCH_BYTES, BATCH_WINDOW = 3, 6, 30, 64


def _frames(rng, mbps, n_bytes, n, sigma=0.05):
    """n aligned frames at `mbps` (port TX) under AWGN: (float32 frames,
    PSDU bits)."""
    psdus = rng.integers(0, 256, (n, n_bytes)).astype(np.uint8)
    frames = np.stack([tx.encode_frame(p, mbps, device="cpu").numpy()
                       for p in psdus])
    frames += rng.normal(0, sigma, frames.shape).astype(np.float32)
    return frames, np.unpackbits(psdus, axis=1, bitorder="little")


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def per_rate():
    """One quantized frame per rate, with the reference's front, data
    and bucketed decodes of it (each reference mode run once)."""
    rng = np.random.default_rng(101)
    out = {}
    for m in RATES_ALL:
        rate = RATES[m]
        n_sym = n_symbols(N_BYTES, rate)
        frames, bits = _frames(rng, m, N_BYTES, 1)
        fq = rx_fxp.quantize_frame(torch.from_numpy(frames[0]))
        _same(fq, R_fxp.quantize_frame(frames[0]))
        n_sym_b = 1 << (n_sym - 1).bit_length()
        pad = torch.zeros((400 + 80 * n_sym_b, 2), dtype=torch.int32)
        pad[:fq.shape[0]] = fq
        out[m] = dict(fq=fq, pad=pad, bits=bits[0], n_sym=n_sym,
                      n_sym_b=n_sym_b,
                      front=jax.jit(lambda f, r=rate, n=n_sym:
                                    R_fxp.decode_front_fxp(f, r, n))(
                                        fq.numpy()))
    return out


def test_decode_front_fxp_all_rates(per_rate):
    """The integer front's LLRs at each of the 8 rates, and the same
    lane of a batched front."""
    for mbps in RATES_ALL:
        c = per_rate[mbps]
        got = rx_fxp.decode_front_fxp(c["fq"], RATES[mbps], c["n_sym"])
        assert got.dtype == torch.int32
        _same(got, c["front"])
        _same(rx_fxp.decode_front_fxp(c["fq"][None].expand(2, -1, -1),
                                      RATES[mbps], c["n_sym"])[1],
              c["front"])


def test_decode_data_fxp_and_bucketed(per_rate):
    """decode_data_fxp's PSDU and SERVICE bits, and the bucketed decode
    of the same frame padded to its power-of-two symbol bucket, against
    the reference's (both on the scan decoder), at 6, 24 and 54
    Mbit/s."""
    for mbps in (6, 24, 54):
        _data_case(per_rate, mbps)


def _data_case(per_rate, mbps):
    c, rate = per_rate[mbps], RATES[mbps]
    nb = 8 * N_BYTES
    psdu, svc = rx_fxp.decode_data_fxp(c["fq"], rate, c["n_sym"], nb)
    r_psdu, r_svc = jax.jit(lambda f: R_fxp.decode_data_fxp(
        f, rate, c["n_sym"], nb))(c["fq"].numpy())
    _same(psdu, r_psdu)
    _same(svc, r_svc)
    _same(psdu, c["bits"])
    n_real = c["n_sym"] * rate.n_dbps
    got = rx_fxp.decode_data_bucketed_fxp(c["pad"], rate, c["n_sym_b"],
                                          n_real)
    want = jax.jit(lambda f, n: R_fxp.decode_data_bucketed_fxp(
        f, rate, c["n_sym_b"], n))(c["pad"].numpy(), np.int32(n_real))
    _same(got, want)
    # rx.decode_data_bucketed's fxp branch is the same decode
    _same(rx.decode_data_bucketed(c["pad"], rate, c["n_sym_b"], n_real,
                                  fxp=True), want)


@pytest.fixture(scope="module")
def batch():
    """The batch's quantized frames and the reference's decodes of them,
    exact and windowed (its Pallas kernels, interpret mode)."""
    rng = np.random.default_rng(202)
    frames, bits = _frames(rng, BATCH_MBPS, BATCH_BYTES, BATCH)
    fq = rx_fxp.quantize_frame(torch.from_numpy(frames))
    rate = RATES[BATCH_MBPS]
    n_sym = n_symbols(BATCH_BYTES, rate)
    assert n_sym * rate.n_dbps > BATCH_WINDOW + 2 * 96
    want = {w: R_fxp.decode_data_batch_fxp(fq.numpy(), rate, n_sym,
                                           8 * BATCH_BYTES,
                                           viterbi_window=w)
            for w in (None, BATCH_WINDOW)}
    return fq, bits, rate, n_sym, want


def test_decode_data_batch_fxp_exact(batch):
    _batch_case(batch, None)


def test_decode_data_batch_fxp_windowed(batch):
    _batch_case(batch, BATCH_WINDOW)


def _batch_case(batch, window):
    fq, bits, rate, n_sym, want = batch
    psdu, svc = rx_fxp.decode_data_batch_fxp(fq, rate, n_sym,
                                             8 * BATCH_BYTES,
                                             viterbi_window=window)
    _same(psdu, want[window][0])
    _same(svc, want[window][1])
    _same(psdu, bits)


def _captures():
    """name -> (float32 capture, check_fcs): impaired captures, one with
    no frame, one with a NaN sample in its DATA field and one whose FCS
    is wrong."""
    caps = {}
    for m, seed in ((12, 81), (54, 82), (6, 83)):
        _psdu, xi = channel.impaired_capture(m, 60, seed, add_fcs=True,
                                             device="cpu")
        caps[f"impaired_{m}"] = np.asarray(xi, np.float32)
    rng = np.random.default_rng(84)
    caps["no_frame"] = (rng.normal(0, 30, (3000, 2))).astype(np.float32)
    nan = caps["impaired_54"].copy()
    nan[60 + 520] = np.nan
    caps["nan_sample"] = nan
    body = rng.integers(0, 256, 40).astype(np.uint8)
    frame = tx.encode_frame(np.concatenate([body, [1, 2, 3, 4]]), 24,
                            device="cpu").numpy()
    cap = np.zeros((frame.shape[0] + 200, 2), np.float32)
    cap[100:100 + frame.shape[0]] = frame * 1024.0
    caps["bad_fcs"] = cap + rng.normal(0, 5, cap.shape).astype(np.float32)
    return caps


CAPTURES = _captures()


def test_receive_fxp_impaired_captures():
    """rx.receive(fxp=True) field for field on impaired captures at 6,
    12 and 54 Mbit/s, each right with a good FCS; and its AGC step on
    random segments and divisors against the reference's expression."""
    for name in sorted(CAPTURES):
        if name.startswith("impaired"):
            _receive_case(name)
    rng = np.random.default_rng(85)
    for _ in range(8):
        seg = rng.normal(0, 1000, (8192, 2)).astype(np.float32)
        pre = rng.normal(0, rng.uniform(100, 2000), (320, 2)).astype(
            np.float32)
        _agc_case(torch.from_numpy(seg), pre)


def test_receive_fxp_no_frame_nan_and_bad_fcs():
    """A capture with no frame, one with a NaN sample in its DATA field
    and a frame with a wrong FCS, field for field."""
    for name in ("no_frame", "nan_sample", "bad_fcs"):
        _receive_case(name)


def _agc_case(seg, preamble):
    """rx._agc_quantize against the reference's AGC line
    (``quantize_frame(np.asarray(seg) / max(rms, 1e-12))``, a float32
    division) on the same float segment."""
    rms = float(np.sqrt(np.mean(preamble.astype(np.float64) ** 2) * 2.0))
    _same(rx._agc_quantize(seg, preamble),
          R_fxp.quantize_frame(seg.numpy() / max(rms, 1e-12)))


def _receive_case(name):
    cap = CAPTURES[name]
    _res, acq = rx._acquire_frame(cap, device="cpu")
    if acq is not None:
        # the Q11 boundary, on the port's own float segment (float32
        # acquisition is not bit-identical between the packages)
        _agc_case(rx._padded_segment(acq, rx._sym_bucket(acq.n_sym), "cpu"),
                  acq.frame_np[:320])
    want = R_rx.receive(cap, check_fcs=True, fxp=True)
    got = rx.receive(cap, check_fcs=True, fxp=True, device="cpu")
    assert (got.ok, got.rate_mbps, got.length_bytes, got.crc_ok) == \
        (want.ok, want.rate_mbps, want.length_bytes, want.crc_ok)
    _same(got.psdu_bits, want.psdu_bits)
    if name.startswith("impaired"):
        assert got.ok and got.crc_ok
    if name == "no_frame":
        assert not got.ok
    if name == "bad_fcs":
        assert got.ok and got.crc_ok is False
