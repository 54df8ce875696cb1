"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a card every test skips (the fixture
decides, at run time). On a machine with one:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import viterbi_cuda as vc
from ziria_tpu_torch.phy.wifi import params, tx

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _llr(b, t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, t, 2)) * 2.0).astype(np.float32)
    x[1:2] = 0.0                                 # an all-erasure lane
    x[2:3, t // 3:] = 0.0                        # an erasure tail
    return torch.from_numpy(x)


@pytest.mark.parametrize("b,t", [(1, 64), (33, 1024), (130, 4160)])
def test_acs_and_traceback_kernels_equal_plain(cuda, b, t):
    llr = _llr(b, t, b + t).to(cuda)
    vc.reset_launches()
    dec, met = vc.acs(llr)
    bits = vc.traceback(dec, met)
    torch.cuda.synchronize()
    assert vc.LAUNCHES == {"acs": 1, "traceback": 1}
    dec_p, met_p = vc.acs_plain(llr)
    assert torch.equal(dec, dec_p)
    assert torch.equal(met.view(torch.int32), met_p.view(torch.int32))
    assert torch.equal(bits, vc.traceback_plain(dec, met))


def test_decode_on_card_equals_decode_on_cpu(cuda):
    llr = _llr(9, 500, 5)
    got = vc.viterbi_decode_batch(llr.to(cuda)).cpu()
    assert torch.equal(got, vc.viterbi_decode_batch(llr))


def test_receive_many_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    caps = []
    for k, m in enumerate(sorted(params.RATES)):
        s = tx.encode_frame(rng.integers(0, 256, 60).astype(np.uint8), m,
                            add_fcs=True, device="cpu").numpy()
        z = np.concatenate([np.zeros((20 + 7 * k, 2), np.float32), s])
        caps.append(z + rng.normal(0, 0.02, z.shape).astype(np.float32))
    vc.reset_launches()
    got = framebatch.receive_many(caps, check_fcs=True, device=cuda)
    assert vc.LAUNCHES["acs"] == 1 and vc.LAUNCHES["traceback"] == 1
    want = framebatch.receive_many(caps, check_fcs=True, device="cpu")
    for g, w in zip(got, want):
        assert g.ok and g.crc_ok
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        np.testing.assert_array_equal(g.psdu_bits, w.psdu_bits)
