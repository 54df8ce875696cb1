"""``receive_many`` against the JAX package's where decodes and FCS
checks fail: 32 captures of 600-byte PSDUs, the 8 rates at 3, 6, 9 and
25 dB, made by the port's TX and a numpy channel from a seed. Every
lane compares field for field, exactly, with ``check_fcs=True``, in
the default and the fused mode (the reference's fused decode runs its
Pallas kernel in interpret mode, about a minute here). At these SNRs
the fused decode differs from the unfused one in both packages (each
renorms on its own cadence, which moves near-ties), so each mode is
held to the reference's same mode. The fused mode's case lives in
``test_torch_lowsnr_fused.py``, so that ``--dist loadfile`` runs the two
long cases on two workers.
"""

import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_receive import _same_results
from test_torch_rx import RATES, _channel
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import tx

SNRS_DB = (3.0, 6.0, 9.0, 25.0)
N_BODY = 596                     # + 4 FCS bytes = 600-byte PSDUs


@pytest.fixture(scope="module")
def lowsnr():
    rng = np.random.default_rng(20261017)
    caps = []
    for snr in SNRS_DB:
        for m in RATES:
            psdu = rng.integers(0, 256, N_BODY).astype(np.uint8)
            s = tx.encode_frame(psdu, m, add_fcs=True, device="cpu").numpy()
            caps.append(_channel(rng, s, int(rng.integers(5, 200)),
                                 float(rng.uniform(-2e-3, 2e-3)), snr))
    return caps


@pytest.mark.parametrize("fused", [False], ids=["default"])
def test_receive_many_at_low_snr_equals_reference(lowsnr, fused):
    check_low_snr(lowsnr, fused)


def check_low_snr(lowsnr, fused):
    want = jfb.receive_many(lowsnr, check_fcs=True, fused_demap=fused)
    got = framebatch.receive_many(lowsnr, check_fcs=True, device="cpu",
                                  fused_demap=fused)
    _same_results(got, want)
    # the corpus reaches the failures: lanes whose FCS fails beside
    # lanes whose FCS holds, and every lane at 25 dB holds
    assert any(g.crc_ok for g in got) and not all(g.crc_ok for g in got)
    assert all(g.crc_ok for g in got[-len(RATES):])
