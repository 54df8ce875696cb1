"""The port's batched TX (ziria_tpu_torch/phy/wifi/tx.py: encode_many,
encode_batch; phy/link.transmit_many) lane for lane.

Within the port every lane is bitwise the per-frame ``encode_frame``,
whatever the batch around it. Against the JAX package the lanes are
held to the reference's per-frame ``encode_frame`` within ATOL (the
IFFT's float32 sums round differently): the reference's own
``encode_many`` does not match its ``encode_frame`` under jax 0.9.0
(tests/test_tx_batched.py, ROADMAP Queue 3 C), so it is not the
oracle here."""

import numpy as np
import pytest
import torch

from tests.test_torch_fleet import one_thread  # noqa: F401 - autouse
from ziria_tpu.phy.wifi import tx as jtx
from ziria_tpu_torch.phy import link as tlink
from ziria_tpu_torch.phy.wifi import tx as ttx

ATOL = 2e-6
RATES = (6, 9, 12, 18, 24, 36, 48, 54, 6, 54, 24)
LENS = (1, 17, 40, 5, 16, 100, 9, 3, 60, 33, 12)
SEED = 20261018


def _psdus():
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, n).astype(np.uint8) for n in LENS]


@pytest.mark.parametrize("add_fcs", [False, True])
def test_encode_many_lane_for_lane(add_fcs):
    """11 lanes of mixed rates and lengths (bit buckets 128-1024, pad
    rows 11-15 repeating lane 0): each lane bitwise the port's
    encode_frame, within ATOL of the reference's encode_frame; the
    valid counts and symbol counts as the reference's prep says."""
    psdus = _psdus()
    b = ttx.encode_many(psdus, RATES, add_fcs=add_fcs, device="cpu")
    prep = jtx.batch_host_prep(psdus, RATES, add_fcs)
    assert b.samples.shape == (16, 400 + 80 * prep.n_sym_bucket, 2)
    assert b.n_sym_bucket == prep.n_sym_bucket
    assert np.array_equal(b.n_sym, prep.n_sym)
    assert np.array_equal(b.n_valid, 400 + 80 * prep.n_sym)
    assert torch.equal(b.samples[11:], b.samples[:1].expand(5, -1, -1))
    for i, (p, m) in enumerate(zip(psdus, RATES)):
        own = ttx.encode_frame(p, m, add_fcs=add_fcs, device="cpu")
        assert torch.equal(b.samples[i, :b.n_valid[i]], own), i
        ref = np.asarray(jtx.encode_frame(p, m, add_fcs=add_fcs))
        assert float(np.abs(own.numpy() - ref).max()) <= ATOL, (i, m)


def test_host_prep_matches_reference():
    """The padded-batch rule (bits, buckets, rows) equals the
    reference's batch_host_prep."""
    psdus = _psdus()
    for add_fcs in (False, True):
        got = ttx.batch_host_prep(psdus, RATES, add_fcs)
        want = jtx.batch_host_prep(psdus, RATES, add_fcs)
        assert (got.bit_bucket, got.n_sym_bucket) == \
            (want.bit_bucket, want.n_sym_bucket)
        for f in ("n_sym", "bits_b", "nbits_b", "ridx_b"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        for a, b in zip(got.bits_list, want.bits_list):
            assert np.array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        ttx.batch_host_prep([], [])
    with pytest.raises(ValueError):
        ttx.batch_host_prep(psdus[:2], RATES[:3])


def test_encode_batch_and_batch_independence():
    """encode_batch: each lane bitwise encode_frame, within ATOL of the
    reference's encode_batch; a lane's samples are the same alone, in
    the batch, and in encode_many's mixed batch."""
    rng = np.random.default_rng(5)
    psdus = rng.integers(0, 256, (6, 24)).astype(np.uint8)
    for m in (6, 54):
        got = ttx.encode_batch(psdus, m, device="cpu")
        want = np.asarray(jtx.encode_batch(psdus, m))
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= ATOL
        for i in range(6):
            assert torch.equal(got[i], ttx.encode_frame(psdus[i], m,
                                                        device="cpu"))
        alone = ttx.encode_batch(psdus[2:3], m, device="cpu")
        assert torch.equal(alone[0], got[2])
    mixed = ttx.encode_many(list(psdus), [54] * 6, device="cpu")
    assert torch.equal(mixed.samples[3, :mixed.n_valid[3]],
                       ttx.encode_batch(psdus, 54, device="cpu")[3])


def test_transmit_many_modes(monkeypatch):
    """transmit_many batched and per frame give equal arrays at the
    true lengths; the empty batch is [] in both; ZIRIA_BATCHED_TX=0
    picks the per-frame loop."""
    psdus = _psdus()
    batched = tlink.transmit_many(psdus, RATES, add_fcs=True,
                                  batched_tx=True, device="cpu")
    single = tlink.transmit_many(psdus, RATES, add_fcs=True,
                                 batched_tx=False, device="cpu")
    assert len(batched) == len(single) == len(psdus)
    for a, b in zip(batched, single):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert tlink.transmit_many([], [], batched_tx=True, device="cpu") == []
    assert tlink.transmit_many([], [], batched_tx=False, device="cpu") == []
    monkeypatch.setenv("ZIRIA_BATCHED_TX", "0")
    assert not tlink.batched_tx_enabled()
    assert tlink.batched_tx_enabled(True)
    monkeypatch.setenv("ZIRIA_BATCHED_TX", "1")
    assert tlink.batched_tx_enabled()
