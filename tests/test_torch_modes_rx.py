"""The windowed decode and the radix-4 fused front in ``receive_many``,
and ``rx.receive`` in every decode mode off the default, against the JAX
package on the CPU, field for field on test_torch_rx.py's corpus
(rebuilt from its seed by test_torch_receive.py's fixture).

The window is 256 steps, short enough that the corpus's 1,728-step
mixed trellis (and the 864-step one of a 54 Mbps capture) really is cut
into windows. The fused decodes are held to the JAX *unfused* decode of
the same radix, the reference's own contract for its fused front.
"""

import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_receive import _same_results, corpus  # noqa: F401
from test_torch_rx import RATES
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import rx

WINDOW = 256
RX_MODES = [{"viterbi_radix": 4}, {"viterbi_metric": "int16"},
            {"viterbi_metric": "int8"}, {"viterbi_window": WINDOW}]


@pytest.fixture(scope="module")
def jax_radix4(corpus):  # noqa: F811
    return jfb.receive_many(corpus, check_fcs=True, viterbi_radix=4)


def test_receive_many_window_equals_reference(corpus):  # noqa: F811
    want = jfb.receive_many(corpus, check_fcs=True, viterbi_window=WINDOW)
    got = framebatch.receive_many(corpus, check_fcs=True, device="cpu",
                                  viterbi_window=WINDOW)
    _same_results(got, want)
    assert sum(g.ok and g.crc_ok for g in got) == len(RATES)


def test_receive_many_fused_radix4_equals_reference(corpus,  # noqa: F811
                                                    jax_radix4):
    got = framebatch.receive_many(corpus, check_fcs=True, device="cpu",
                                  fused_demap=True, viterbi_radix=4)
    _same_results(got, jax_radix4)


def test_receive_each_mode_equals_reference(corpus):  # noqa: F811
    # the 54 Mbps capture: 864 trellis steps at its 4-symbol bucket
    cap = corpus[RATES.index(54)]
    for knobs in RX_MODES:
        want = jrx.receive(cap, check_fcs=True, **knobs)
        got = rx.receive(cap, check_fcs=True, device="cpu", **knobs)
        _same_results([got], [want])
        assert got.ok and got.crc_ok, knobs
    want = jrx.receive(cap, check_fcs=True, viterbi_radix=4)
    got = rx.receive(cap, check_fcs=True, device="cpu", fused_demap=True,
                     viterbi_radix=4)
    _same_results([got], [want])
