"""The port's Viterbi against the JAX package's, on the CPU.

The plain versions of the two CUDA kernels (ops/viterbi_cuda.acs_plain
and traceback_plain) are held bit for bit against the Pallas kernels
they replace, run in interpret mode as the JAX package's own tests run
them: packed decisions, final metrics and decoded bits exact, at a
shape that is a multiple of neither 64 steps nor 128 lanes, with an
all-erasure lane and erasure tails (where metrics tie exactly, so the
strict-greater decision, the first-index argmax and the 64-step renorm
cadence all decide bits). The scan decoder of the SIGNAL field is held
against ops/viterbi.viterbi_decode.
"""

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.ops import coding as jcoding, viterbi as jviterbi, \
    viterbi_pallas as jvp
from ziria_tpu_torch.ops import viterbi, viterbi_cuda

B, T = 5, 200


def _llrs(seed, b=B, n=T):
    """Noisy soft pairs of zero-tailed random messages, lane 1 all
    erasures, lanes 2 and 3 with erasure tails."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, n, 2), np.float32)
    for k in range(b):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        bits[-6:] = 0
        coded = jcoding.np_conv_encode_ref(bits).astype(np.float32)
        out[k] = ((2 * coded - 1) * 1.5
                  + rng.normal(0, 1.0, coded.size)).reshape(n, 2)
    out[1] = 0.0
    out[2, 120:] = 0.0
    out[3, 61:] = 0.0
    return out


@pytest.fixture(scope="module")
def reference():
    """One interpret-mode pass of the Pallas ACS and traceback over the
    padded lane tiles, unpacked to per-lane arrays."""
    llr = _llrs(0)
    Tp = -(-T // jvp.UNROLL) * jvp.UNROLL
    padded = np.pad(llr, ((0, 0), (0, Tp - T), (0, 0)))
    tiles, _ = jvp._to_tiles(padded)
    dec, met = jvp._acs_tiles(tiles, True)
    bits = jvp._traceback_tiles(dec, met, True)
    return (llr, np.array(np.asarray(dec)[0, :, :, :B].transpose(2, 0, 1)),
            np.array(np.asarray(met)[0, :, :B].T),
            np.array(np.asarray(bits)[0, :, 0, :B].T, np.uint8))


def test_pad_trellis_matches_decode_tiles_padding(reference):
    llr = reference[0]
    x = viterbi_cuda.pad_trellis(torch.from_numpy(llr))
    assert x.shape == (B, 256, 2) and x.is_contiguous()
    np.testing.assert_array_equal(x[:, :T].numpy(), llr)
    assert not x[:, T:].any()


def test_acs_plain_equals_pallas_acs(reference):
    llr, dec_ref, met_ref, _bits = reference
    dec, met = viterbi_cuda.acs_plain(
        viterbi_cuda.pad_trellis(torch.from_numpy(llr)))
    assert dec.dtype == torch.uint8 and dec.shape == dec_ref.shape
    np.testing.assert_array_equal(dec.numpy(), dec_ref)
    np.testing.assert_array_equal(met.numpy(), met_ref)


def test_traceback_plain_equals_pallas_traceback(reference):
    _llr, dec_ref, met_ref, bits_ref = reference
    bits = viterbi_cuda.traceback_plain(torch.from_numpy(dec_ref),
                                        torch.from_numpy(met_ref))
    np.testing.assert_array_equal(bits.numpy(), bits_ref)


def test_wrappers_take_the_plain_version_on_cpu(reference):
    llr, dec_ref, met_ref, bits_ref = reference
    viterbi_cuda.reset_launches()
    dec, met = viterbi_cuda.acs(viterbi_cuda.pad_trellis(
        torch.from_numpy(llr)))
    bits = viterbi_cuda.traceback(dec, met)
    np.testing.assert_array_equal(dec.numpy(), dec_ref)
    np.testing.assert_array_equal(bits.numpy(), bits_ref)
    # only kernel launches count
    assert not any(viterbi_cuda.LAUNCHES.values())


def test_decode_batch_equals_pallas_decode(reference):
    llr, _dec, _met, bits_ref = reference
    want = np.asarray(jvp.viterbi_decode_batch(llr, interpret=True))
    np.testing.assert_array_equal(want, bits_ref[:, :T])
    got = viterbi_cuda.viterbi_decode_batch(torch.from_numpy(llr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        viterbi_cuda.acs(torch.zeros(2, 100, 2))            # Tp % 64
    with pytest.raises(ValueError):
        viterbi_cuda.acs(torch.zeros(2, 64, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        viterbi_cuda.traceback(torch.zeros(2, 64, 8, dtype=torch.uint8),
                               torch.zeros(3, 64))


@pytest.mark.parametrize("n", [24, 90])
def test_scan_decoder_equals_reference_scan(n):
    llr = _llrs(n, b=4, n=n)
    want = np.stack([np.asarray(jviterbi.viterbi_decode(x)) for x in llr])
    got = viterbi.viterbi_decode(torch.from_numpy(llr))
    np.testing.assert_array_equal(got.numpy(), want)
    got_flat = viterbi.viterbi_decode(torch.from_numpy(llr.reshape(4, -1)),
                                      n_bits=n - 6)
    np.testing.assert_array_equal(got_flat.numpy(), want[:, :n - 6])


def test_edge_tables_agree_with_the_kernel_formula():
    # the CUDA source derives the +-1 coefficients from the generator
    # taps with this formula (csrc/viterbi.cu edge_coeff)
    for t in range(64):
        for d in range(2):
            s = ((t & 31) << 1) | d
            win = [t >> 5] + [(s >> (5 - i)) & 1 for i in range(6)]
            for g, tab in ((jcoding.G0, viterbi._OUT_A),
                           (jcoding.G1, viterbi._OUT_B)):
                acc = sum(int(a) * w for a, w in zip(g, win)) & 1
                assert tab[t, d] == (1.0 if acc else -1.0)
