"""The frozen transmitter against the port's, and the generator's
traffic through the plain reference receiver, at a small size."""

import numpy as np
import torch

from benchmark import check, control, generator
from benchmark.reference import tx
from benchmark.tests.smallcells import SMALL

SEED = 2 ** 31 + 91


def test_frozen_tx_equals_the_ports_encode_frame():
    from ziria_tpu_torch.phy.wifi import tx as port_tx

    rng = np.random.default_rng(5)
    for mbps in tx.RATE_ORDER:
        body = rng.integers(0, 256, (2, 37)).astype(np.uint8)
        mine = tx.encode_frames(tx.with_fcs(body), mbps)
        for i in range(2):
            p = port_tx.encode_frame(body[i], mbps, add_fcs=True,
                                     device="cpu").numpy()
            assert mine[i].shape == (p.shape[0],)
            assert np.abs(mine[i] - (p[:, 0] + 1j * p[:, 1])).max() < 2e-6


def test_captures_decode_right_through_the_reference():
    mix = {"kind": "captures", "captures": 16, "pool": 1, "rates": "cycle",
           "psdu_bytes": [30, 90], "lead": [16, 4000], "tail": 200,
           "cfo": [-0.01, 0.01], "snr_db": 25.0}
    pool, truth = generator.make_captures(mix, SEED, torch.device("cpu"))
    got = check.reference_frames(pool[0])
    for g, fr in zip(got, truth[0]):
        assert g["start"] == fr.start
        assert check.same_result(control.Answer(
            g["ok"], g["rate_mbps"], g["length_bytes"], g["psdu_bits"],
            g["crc_ok"]), fr)


def test_streams_hold_their_frames_and_decode_right():
    mix = {"kind": "streams", **SMALL["fleet32_busy"]["mix"],
           "rates": "cycle", "first_start": [60, 600], "cfo_spread": 0.004,
           "snr_db": 25.0}
    loops, truth = generator.make_streams(mix, SEED, torch.device("cpu"))
    assert len(loops) == 2 and all(x.shape == (65536, 2) for x in loops)
    for fs in truth:
        starts = [f.start for f in fs]
        assert np.all(np.diff(starts) >= 2400)
        assert starts[-1] + 2700 <= 65536
        assert sorted({f.mbps for f in fs}) == list(tx.RATE_ORDER) or \
            len(fs) < 8
    fr = truth[1][3]
    got = check.reference_frames([loops[1][fr.start - 300:
                                           fr.start + fr.n_samples + 50]])[0]
    assert got["start"] == 300 and got["crc_ok"] is True
    assert np.array_equal(got["psdu_bits"], fr.bits)


def test_the_control_fails_and_the_float32_reference_passes():
    for wl in ("batch_mixed_512", "fleet32_busy"):
        ov = SMALL[wl]["mix"]
        sound = control.readings(wl, SEED, torch.float32,
                                 torch.device("cpu"), ov)
        low = control.readings(wl, SEED, torch.bfloat16,
                               torch.device("cpu"), ov)
        assert sound["wrong_frames"] == sound["reference_mismatch"] == 0
        assert low["wrong_frames"] > 0 and low["reference_mismatch"] > 0
