"""``rx.receive(fxp=True)`` of the port against the JAX package's on
impaired captures down to low SNR, on the CPU.

The fixed-point interior is exact on equal input (held bit for bit in
``test_torch_rx_fxp.py``), but its input is not equal: acquisition and
the CFO derotation stay float32 in both packages, and XLA's float32
sums, sin, cos and atan2 are its own (CUDA's differ from both), so the
Q11 segment each package hands the interior can differ by one LSB in a
few samples. This file holds the whole receive field for field (PSDU
bits, rate, length, FCS verdict, failures included) on 64 captures:
the 8 rates, 100 bytes + FCS, CFO 0.004, noise 0.03 to 0.28 (the low
end fails FCS in both packages), 2 seeds each; and it bounds the Q11
difference.

The bound comes from this set of captures on the CPU: 16 of its 281,600
Q11 samples differ, none by more than one LSB, at most 3 in one
capture. The limits below leave room for a CPU whose vectorized float32
sin and cos round differently (torch picks its SIMD path by the host's
instruction set): at most one LSB anywhere, at most
``MAX_DIFF_PER_CAPTURE`` samples in a capture and ``MAX_DIFF_TOTAL`` in
all (about 0.017%).
"""

import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.phy.wifi import rx as R_rx, rx_fxp as R_fxp
from ziria_tpu_torch.phy import channel
from ziria_tpu_torch.phy.wifi import rx
from ziria_tpu_torch.phy.wifi.params import RATES

NOISES = tuple(float(v) for v in np.linspace(0.03, 0.28, 4))
SEEDS = (0, 1)
N_BYTES = 100
CFO = 0.004
MAX_DIFF_PER_CAPTURE = 8
MAX_DIFF_TOTAL = 48


def _captures():
    for m in sorted(RATES):
        for noise in NOISES:
            for s in SEEDS:
                seed = 1000 * m + int(noise * 1000) + s
                _psdu, cap = channel.impaired_capture(
                    m, N_BYTES, seed, cfo=CFO, noise=noise, add_fcs=True,
                    device="cpu")
                yield (m, noise, s), cap


def _q11_port(cap):
    _res, acq = rx._acquire_frame(cap, device="cpu")
    if acq is None:
        return None
    seg = rx._padded_segment(acq, rx._sym_bucket(acq.n_sym), "cpu")
    return rx._agc_quantize(seg, acq.frame_np[:320]).numpy()


def _q11_reference(cap):
    """The reference's AGC and quantization line of ``receive(fxp=True)``
    on its own acquisition."""
    _res, acq = R_rx._acquire_frame(cap)
    if acq is None:
        return None
    seg = R_rx._padded_segment(acq, R_rx._sym_bucket(acq.n_sym))
    rms = float(np.sqrt(np.mean(acq.frame_np[:320].astype(np.float64)
                                ** 2) * 2.0))
    return np.asarray(R_fxp.quantize_frame(np.asarray(seg)
                                           / max(rms, 1e-12)))


@pytest.fixture(scope="module")
def runs():
    """Per capture: both Q11 segments and both receive results."""
    out = {}
    for key, cap in _captures():
        out[key] = (_q11_port(cap), _q11_reference(cap),
                    rx.receive(cap, check_fcs=True, fxp=True,
                               device="cpu"),
                    R_rx.receive(cap, check_fcs=True, fxp=True))
    return out


def test_receive_fxp_fields_equal_at_low_snr(runs):
    assert len(runs) == 64
    failed = 0
    for key, (_q, _rq, got, want) in runs.items():
        assert (got.ok, got.rate_mbps, got.length_bytes, got.crc_ok) == \
            (want.ok, want.rate_mbps, want.length_bytes, want.crc_ok), key
        np.testing.assert_array_equal(np.asarray(got.psdu_bits),
                                      np.asarray(want.psdu_bits),
                                      err_msg=str(key))
        failed += not (got.ok and got.crc_ok)
        if key[1] == NOISES[0]:
            assert got.ok and got.crc_ok, key
    # the low-SNR end really fails decodes, so failures are compared too
    assert failed > 0


def test_q11_input_within_one_lsb_of_the_reference(runs):
    total = 0
    for key, (q, rq, _got, _want) in runs.items():
        assert (q is None) == (rq is None), key
        if q is None:
            continue
        assert q.shape == rq.shape and q.dtype == rq.dtype, key
        d = np.abs(q.astype(np.int64) - rq.astype(np.int64))
        assert int(d.max()) <= 1, key
        n = int(np.count_nonzero(d))
        assert n <= MAX_DIFF_PER_CAPTURE, (key, n)
        total += n
    assert total <= MAX_DIFF_TOTAL, total
