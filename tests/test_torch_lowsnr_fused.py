"""``receive_many(fused_demap=True)`` against the JAX package's fused
mode at 3-25 dB, where decodes and FCS checks fail: the fused case of
``test_torch_lowsnr.py`` (its corpus and checks), in a file of its own
so that ``--dist loadfile`` runs it beside the default case. The
reference's fused decode runs its Pallas kernel in interpret mode,
about a minute here.
"""

import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_lowsnr import check_low_snr, lowsnr  # noqa: F401


@pytest.mark.parametrize("fused", [True], ids=["fused"])
def test_receive_many_at_low_snr_equals_reference(lowsnr, fused):  # noqa: F811
    check_low_snr(lowsnr, fused)
