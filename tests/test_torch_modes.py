"""``receive_many`` in the decode modes off the default (radix 4, int16
and int8 metrics) against the JAX ``receive_many`` in the same mode, on
the CPU, field for field on test_torch_rx.py's corpus (rebuilt from its
seed by test_torch_receive.py's fixture: 16-byte PSDUs at the 8 rates
through the port's TX and a numpy channel at 25 dB, a noise capture, a
truncated one and one with a bad SIGNAL parity). The reference runs its
Pallas kernels in interpret mode; the port its kernels' plain versions.
The window, the fused front at radix 4 and ``rx.receive`` are in
test_torch_modes_rx.py.
"""

import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_receive import _same_results, corpus  # noqa: F401
from test_torch_rx import RATES
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu_torch.backend import framebatch


@pytest.mark.parametrize("knobs", [
    {"viterbi_radix": 4},
    {"viterbi_metric": "int16"},
    {"viterbi_metric": "int8"}], ids=["radix4", "int16", "int8"])
def test_receive_many_mode_equals_reference(corpus, knobs):  # noqa: F811
    want = jfb.receive_many(corpus, check_fcs=True, **knobs)
    got = framebatch.receive_many(corpus, check_fcs=True, device="cpu",
                                  **knobs)
    _same_results(got, want)
    assert sum(g.ok and g.crc_ok for g in got) == len(RATES)
