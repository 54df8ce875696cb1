"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a card every test skips (the fixture
decides, at run time). On a machine with one:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params, rx, tx

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


def _fused_inputs(b, n_sym, ridx, seed):
    """Random equalized symbols and gains (one nulled subcarrier), and
    bit counts with an all-erasure lane and a lane ending inside a
    symbol."""
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 0.7, (b, n_sym, 48, 2)).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, (b, 48)).astype(np.float32)
    gain[:, 7] = 0.0
    ndb = np.asarray([params.RATES[params.RATE_MBPS_ORDER[r]].n_dbps
                      for r in ridx])
    nbits = rng.integers(0, n_sym * ndb + 1)
    nbits[0] = 0
    if b > 1:
        nbits[1] = (n_sym // 2) * ndb[1] + ndb[1] // 3
    return (torch.from_numpy(data), torch.from_numpy(gain),
            torch.from_numpy(nbits.astype(np.int32)))


def _same_acs(got, want):
    (dec, met), (dec_p, met_p) = got, want
    assert torch.equal(dec, dec_p)
    assert torch.equal(met.view(torch.int32), met_p.view(torch.int32))


@pytest.mark.parametrize("b,n_sym", [(1, 4), (37, 8), (128, 16)])
def test_fused_mixed_kernel_equals_plain(cuda, b, n_sym):
    ridx = np.arange(b) % 8
    data, gain, nbits = (t.to(cuda) for t in _fused_inputs(b, n_sym, ridx,
                                                           b + n_sym))
    vf.reset_launches()
    got = vf.fused_acs_mixed(data, gain, ridx, nbits)
    torch.cuda.synchronize()
    assert vf.LAUNCHES == {"fused_mixed": 1, "fused_rate": 0}
    _same_acs(got, vf.fused_acs_mixed_plain(data, gain, ridx, nbits))


@pytest.mark.parametrize("mbps", sorted(params.RATES))
def test_fused_rate_kernel_equals_plain(cuda, mbps):
    rate = params.RATES[mbps]
    n_sym = 3 * vf.symbols_per_block(rate)
    ridx = np.full(33, params.RATE_INDEX[mbps])
    data, gain, nbits = (t.to(cuda) for t in _fused_inputs(33, n_sym, ridx,
                                                           mbps))
    vf.reset_launches()
    got = vf.fused_acs_rate(data, gain, rate, nbits)
    torch.cuda.synchronize()
    assert vf.LAUNCHES == {"fused_mixed": 0, "fused_rate": 1}
    _same_acs(got, vf.fused_acs_rate_plain(data, gain, rate, nbits))


def _captures(seed):
    rng = np.random.default_rng(seed)
    caps = []
    for k, m in enumerate(sorted(params.RATES)):
        s = tx.encode_frame(rng.integers(0, 256, 60).astype(np.uint8), m,
                            add_fcs=True, device="cpu").numpy()
        z = np.concatenate([np.zeros((20 + 7 * k, 2), np.float32), s])
        caps.append(z + rng.normal(0, 0.02, z.shape).astype(np.float32))
    return caps


def test_fused_receive_paths_on_card_equal_cpu(cuda):
    caps = _captures(2)
    vf.reset_launches()
    vc.reset_launches()
    got = framebatch.receive_many(caps, check_fcs=True, device=cuda,
                                  fused_demap=True)
    assert vf.LAUNCHES["fused_mixed"] == 1 and vc.LAUNCHES["acs"] == 0
    want = framebatch.receive_many(caps, check_fcs=True, device="cpu",
                                   fused_demap=True)
    for c, g, w in zip(caps, got, want):
        assert g.ok and g.crc_ok
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        np.testing.assert_array_equal(g.psdu_bits, w.psdu_bits)
        one = rx.receive(c, check_fcs=True, fused_demap=True, device=cuda)
        assert one.crc_ok
        np.testing.assert_array_equal(one.psdu_bits, g.psdu_bits)
    assert vf.LAUNCHES["fused_rate"] == len(caps)
