"""The ``receive_many`` knobs that the per-capture receiver brought to the
port (``batched_acquire=False``, ``sco_track=True``, ``fused_demap=True``)
against the JAX ``receive_many``, on the CPU, field for field on
test_torch_rx.py's corpus (rebuilt from its seed by
test_torch_receive.py's fixture). The fused decode is held to the JAX
*unfused* one, the reference's own contract for its fused front.
"""

import pytest

from test_torch_receive import _same_results, corpus  # noqa: F401
from test_torch_rx import RATES
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import viterbi_cuda, viterbi_fused as vf


@pytest.fixture(scope="module")
def jax_many(corpus):  # noqa: F811
    """The JAX receive_many at its defaults and with the per-capture
    acquisition and SCO tracking on (its batched and per-capture
    acquisitions are pinned bit-identical by its own tests)."""
    return {"default": jfb.receive_many(corpus, check_fcs=True),
            "sco": jfb.receive_many(corpus, check_fcs=True,
                                    batched_acquire=False, sco_track=True)}


@pytest.mark.parametrize("knobs,ref", [
    ({"batched_acquire": False}, "default"),
    ({"sco_track": True}, "sco"),
    ({"batched_acquire": False, "sco_track": True}, "sco")])
def test_receive_many_knob_equals_reference(corpus, jax_many,  # noqa: F811
                                            knobs, ref):
    got = framebatch.receive_many(corpus, check_fcs=True, device="cpu",
                                  **knobs)
    _same_results(got, jax_many[ref])


def test_receive_many_fused_equals_reference_unfused(corpus,  # noqa: F811
                                                     jax_many):
    vf.reset_launches()
    viterbi_cuda.reset_launches()
    got = framebatch.receive_many(corpus, check_fcs=True, device="cpu",
                                  fused_demap=True)
    _same_results(got, jax_many["default"])
    assert sum(g.ok for g in got) == len(RATES)
    # on the CPU the wrappers run their plain versions: nothing counts
    assert vf.LAUNCHES == {"fused_mixed": 0, "fused_rate": 0}
    assert viterbi_cuda.LAUNCHES == {"acs": 0, "traceback": 0}
