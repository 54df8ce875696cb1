"""The port's fused demap front end (ops/viterbi_fused) against the JAX
package's unfused front and decode, on the CPU.

The Pallas fused kernels take minutes in interpret mode, so these tests
hold the port to the reference's own contract for them
(tests/test_viterbi_fused_mixed.py ``_assert_fused_identical``): the
fused front's LLRs equal the unfused front's, float32 bitwise (-0.0 ==
+0.0), and the fused decodes equal the unfused decodes bit for bit over
each lane's real prefix (test_torch_fused_decode.py, kept apart since
its JAX references compile interpret-mode Pallas decodes).

Inputs are made with numpy from a seed and the port's TX (pinned to the
JAX TX in test_torch_rx.py): 24-byte PSDUs at an 8-symbol bucket.
"""

import jax
import numpy as np
import pytest
import torch

from ziria_tpu.ops import viterbi_pallas as jvp
from ziria_tpu.phy.wifi import params as jparams, rx as jrx
from ziria_tpu_torch.ops import viterbi_cuda, viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params, rx, tx

ALL = params.RATE_MBPS_ORDER
N_BYTES = 24
N_SYM_B = 8


def t(x):
    return torch.from_numpy(np.array(x))


def _frames(rng, rates, n_sym, noise=0.03):
    """Aligned noisy frames (len(rates), 400 + 80*n_sym, 2), frame k a
    random N_BYTES PSDU at rates[k], cut or zero-padded to the
    length."""
    need = rx.FRAME_DATA_START + 80 * n_sym
    frames = np.zeros((len(rates), need, 2), np.float32)
    for k, m in enumerate(rates):
        psdu = rng.integers(0, 256, N_BYTES).astype(np.uint8)
        s = tx.encode_frame(psdu, m, device="cpu").numpy()[:need]
        frames[k, :s.shape[0]] = s
    return frames + rng.normal(0, noise, frames.shape).astype(np.float32)


@pytest.fixture(scope="module")
def fronts():
    """One frame per rate at the 8-symbol bucket; bit counts per rate
    and lane (lane 0 all erasures, lane 1 ending inside a symbol, the
    rest random); the JAX equalized symbols and gains, and the JAX
    unfused front of every lane at every rate."""
    rng = np.random.default_rng(20261016)
    frames = _frames(rng, ALL, N_SYM_B)
    nbits = {}
    for m in ALL:
        n_dbps = params.RATES[m].n_dbps
        nb = rng.integers(0, N_SYM_B * n_dbps + 1, len(ALL))
        nb[0], nb[1] = 0, 3 * n_dbps + n_dbps // 2 + 1
        nbits[m] = nb
    data, gain = jax.jit(jax.vmap(
        lambda f: jrx._front_symbols(f, N_SYM_B)))(frames)
    dep = {m: np.asarray(jax.jit(jax.vmap(
        lambda f, r=jparams.RATES[m]: jrx._decode_front(f, r, N_SYM_B)))(
            frames)) for m in ALL}
    return frames, nbits, np.asarray(data), np.asarray(gain), dep


def _masked(dep, nbits, T):
    out = np.zeros((dep.shape[0], T, 2), np.float32)
    out[:, :dep.shape[1]] = dep
    keep = np.arange(T)[None, :] < np.asarray(nbits)[:, None]
    return np.where(keep[..., None], out, np.float32(0.0))


@pytest.mark.parametrize("mbps", ALL)
def test_fused_front_equals_reference_front(fronts, mbps):
    _frames_, nbits, data, gain, dep = fronts
    T = N_SYM_B * params.RATES[mbps].n_dbps
    got = vf.fused_front_plain(t(data), t(gain),
                               [params.RATE_INDEX[mbps]] * len(ALL),
                               t(nbits[mbps]), T)
    assert got.shape == (len(ALL), T, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  _masked(dep[mbps], nbits[mbps], T))


def test_mixed_fused_front_equals_reference_switch(fronts):
    # lane k at rate ALL[k], each zero-padded to the bucket's maximal
    # trellis and masked at its bit count: the vmapped lax.switch front
    _frames_, nbits, data, gain, dep = fronts
    T = N_SYM_B * params.MAX_DBPS
    nb = np.asarray([nbits[m][k] for k, m in enumerate(ALL)])
    want = np.stack([_masked(dep[m][k:k + 1], nb[k:k + 1], T)[0]
                     for k, m in enumerate(ALL)])
    got = vf.fused_front_plain(t(data), t(gain), np.arange(8), t(nb), T)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own unfused front agrees on the same frames
    np.testing.assert_allclose(
        rx.mixed_front(t(_frames_), np.arange(8), nb, N_SYM_B).numpy(),
        want, rtol=1e-5, atol=1e-5)


def test_renorm_cadences():
    # the known-rate kernel renormalizes once per spb symbols, never
    # every 64 steps; the mixed one every 72
    cad = [vf.symbols_per_block(params.RATES[m]) * params.RATES[m].n_dbps
           for m in ALL]
    assert cad == [72, 72, 96, 72, 96, 144, 192, 216]
    assert (vf.MIXED_SUB, vf.MIXED_UNROLL, vf.MIXED_CHUNKS) == \
        (jvp.MIXED_SUB, jvp.MIXED_UNROLL, jvp.MIXED_CHUNKS)
    assert all(cad_r % vf.MIXED_SUB == 0 for cad_r in cad)


def test_known_rate_tables_are_rows_of_the_bank():
    bank = vf.mixed_front_tables()
    for r, m in enumerate(ALL):
        p = params.RATES[m]
        tab = vf.front_tables(p.n_bpsc, p.n_cbps, p.n_dbps, p.coding)
        flat = bank[r].reshape(-1, 4)
        np.testing.assert_array_equal(flat[:tab.shape[0]], tab)
        assert not flat[tab.shape[0]:].any()


def test_wrappers_take_the_plain_version_on_cpu(fronts):
    _frames_, nbits, data, gain, _dep = fronts
    vf.reset_launches()
    viterbi_cuda.reset_launches()
    nb = np.asarray([nbits[m][k] for k, m in enumerate(ALL)])
    dec, met = vf.fused_acs_mixed(t(data), t(gain), np.arange(8), t(nb))
    dec_p, met_p = vf.fused_acs_mixed_plain(t(data), t(gain), np.arange(8),
                                            t(nb))
    assert torch.equal(dec, dec_p) and torch.equal(met, met_p)
    assert dec.shape == (8, N_SYM_B * 216, 8)
    rate = params.RATES[54]
    d54 = t(data[:3, :3])
    dec, met = vf.fused_acs_rate(d54, t(gain[:3]), rate, [200, 648, 0])
    assert dec.shape == (3, 3 * 216, 8)
    # only kernel launches count
    assert vf.LAUNCHES == {"fused_mixed": 0, "fused_rate": 0}
    assert viterbi_cuda.LAUNCHES == {"acs": 0, "traceback": 0}


def test_wrappers_reject_bad_input(fronts):
    _frames_, _nbits, data, gain, _dep = fronts
    with pytest.raises(ValueError, match="rate_idx"):
        vf.fused_acs_mixed(t(data), t(gain), [8] * 8, 0)
    with pytest.raises(ValueError, match="spb"):
        vf.fused_acs_rate(t(data[:, :4]), t(gain), params.RATES[6], 0)
    with pytest.raises(ValueError, match="48, 2"):
        vf.fused_acs_mixed(t(data[..., 0]), t(gain), [0] * 8, 0)
