"""The port's fused decodes (ops/viterbi_fused through phy/wifi/rx)
against the JAX package's decodes, on the CPU.

The tier-1 tests hold the fused decodes to the reference's own contract
for its fused front (tests/test_viterbi_fused_mixed.py
``_assert_fused_identical``): they equal the JAX *unfused* decodes bit
for bit over each lane's real prefix. The one ``slow`` test holds the
plain fused decodes against the Pallas fused kernels in interpret mode,
whole outputs, since both renormalize on the same cadence (minutes of
interpret-mode Pallas on the CPU).

The frames are test_torch_fused.py's: the port's TX, 24-byte PSDUs.
"""

import jax
import numpy as np
import pytest

from test_torch_fused import ALL, N_BYTES, N_SYM_B, _frames, t
from ziria_tpu.ops import viterbi_pallas as jvp
from ziria_tpu.phy.wifi import params as jparams, rx as jrx
from ziria_tpu_torch.ops import viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params, rx


@pytest.fixture(scope="module")
def mixed():
    """One frame per rate at the 8-symbol bucket and a bit count per
    lane: lane 0 all erasures, lane 1 ending inside a symbol, the rest
    random."""
    rng = np.random.default_rng(20261016)
    frames = _frames(rng, ALL, N_SYM_B)
    ndbps = np.asarray([params.RATES[m].n_dbps for m in ALL])
    nb = rng.integers(0, N_SYM_B * ndbps + 1).astype(np.int32)
    nb[0], nb[1] = 0, 3 * ndbps[1] + ndbps[1] // 2 + 1
    return frames, nb


def test_mixed_fused_decode_equals_reference_unfused(mixed):
    # the port's fused and unfused decode_data_mixed against the JAX
    # unfused one (receive_many's compiled program), over each lane's
    # real prefix
    frames, nb = mixed
    ridx = np.arange(len(ALL), dtype=np.int32)
    want = np.asarray(jrx._jit_decode_data_mixed(N_SYM_B, None, None, 2)(
        frames, ridx, nb))
    keep = np.arange(want.shape[1])[None, :] < nb[:, None]
    for fused in (True, False):
        got = rx.decode_data_mixed(t(frames), ridx, nb, N_SYM_B,
                                   fused_demap=fused).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[keep], want[keep])


@pytest.fixture(scope="module")
def known_rate():
    """Three frames at each of 6 and 54 Mbps (24-byte PSDUs: 9 and 1
    symbols, T = 216 steps both, so one Pallas decode program serves
    both) and the JAX unfused decode_data_batch of each."""
    rng = np.random.default_rng(7)
    out = {}
    for m in (6, 54):
        rate = jparams.RATES[m]
        n_sym = jparams.n_symbols(N_BYTES, rate)
        frames = _frames(rng, [m] * 3, n_sym)
        psdu, service = jrx.decode_data_batch(frames, rate, n_sym,
                                              8 * N_BYTES, fused_demap=False)
        out[m] = (frames, n_sym, np.asarray(psdu), np.asarray(service))
    return out


@pytest.mark.parametrize("mbps", [6, 54])
def test_known_rate_fused_decode_equals_reference(known_rate, mbps):
    frames, n_sym, psdu, service = known_rate[mbps]
    rate = params.RATES[mbps]
    for fused in (True, False):
        got = rx.decode_data_batch(t(frames), rate, n_sym, 8 * N_BYTES,
                                   fused_demap=fused)
        np.testing.assert_array_equal(got[0].numpy(), psdu)
        np.testing.assert_array_equal(got[1].numpy(), service)


@pytest.mark.slow
def test_plain_fused_decodes_equal_pallas_fused_kernels(mixed, known_rate):
    frames, nb = mixed
    data, gain = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda f: jrx._front_symbols(f, N_SYM_B)))(frames))
    want = np.asarray(jvp.viterbi_decode_mixed_fused(
        data, gain, np.arange(8, dtype=np.int32), nb, interpret=True))
    got = vf.viterbi_decode_mixed_fused(t(data), t(gain), np.arange(8),
                                        t(nb))
    np.testing.assert_array_equal(got.numpy(), want)
    for m in (6, 54):
        frames, n_sym, _psdu, _service = known_rate[m]
        d, g = jax.vmap(lambda f: jrx._front_symbols(f, n_sym))(frames)
        d, g = np.asarray(d), np.asarray(g)
        want = np.asarray(jvp.viterbi_decode_batch_fused(
            d, g, jparams.RATES[m], nbits_real=np.asarray([100, 0, 216]),
            interpret=True))
        got = vf.viterbi_decode_batch_fused(t(d), t(g), params.RATES[m],
                                            nbits_real=[100, 0, 216])
        np.testing.assert_array_equal(got.numpy(), want)
