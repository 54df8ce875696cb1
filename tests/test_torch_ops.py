"""Each ported op of ziria_tpu_torch against its JAX counterpart, on the
CPU, on seeded numpy inputs handed to both.

Tolerances: integers and bits exact. Floats within rtol = atol = 1e-5:
the reference itself promises only float32 ulp-level agreement between
separately compiled programs (FMA contraction, reduction order), and
the port sums in PyTorch's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.ops import coding as jcoding, cplx as jcplx, crc as jcrc, \
    demap as jdemap, interleave as jinter, modulate as jmod, ofdm as jofdm, \
    scramble as jscr, sync as jsync
from ziria_tpu.phy.wifi import params as jparams
from ziria_tpu.utils import bits as jbits, dispatch as jdispatch
from ziria_tpu.utils.geometry import DEFAULT as JGEOM
from ziria_tpu_torch.ops import coding, cplx, crc, demap, interleave, \
    modulate, ofdm, scramble, sync
from ziria_tpu_torch.phy.wifi import params, tx
from ziria_tpu_torch.utils import bits, dispatch, geometry

RATE_MODES = sorted({(p.n_cbps, p.n_bpsc) for p in params.RATES.values()})


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def pairs(rng, *shape, scale=1.0):
    return (rng.normal(size=shape + (2,)) * scale).astype(np.float32)


# ------------------------------------------------ bits, params, geometry


def test_bit_helpers():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3, 10)).astype(np.uint8)
    same(bits.bytes_to_bits(t(data)), jbits.bytes_to_bits(data))
    b = rng.integers(0, 2, (4, 40)).astype(np.uint8)
    same(bits.bits_to_bytes(t(b)), jbits.bits_to_bytes(b))
    for msb in (False, True):
        same(bits.bits_to_uint(t(b[:, :12]), msb_first=msb),
             jbits.bits_to_uint(b[:, :12], msb_first=msb))
        vals = rng.integers(0, 1 << 31, 6)
        same(bits.uint_to_bits(vals, 32, msb_first=msb),
             jbits.uint_to_bits(vals.astype(np.uint32), 32, msb_first=msb))


def test_params_and_buckets():
    assert params.RATES == {m: params.RateParams(**vars(p))
                            for m, p in jparams.RATES.items()}
    assert params.SIGNAL_BITS_TO_MBPS == jparams.SIGNAL_BITS_TO_MBPS
    assert params.RATE_MBPS_ORDER == jparams.RATE_MBPS_ORDER
    assert params.RATE_INDEX == jparams.RATE_INDEX
    assert params.MAX_DBPS == jparams.MAX_DBPS
    for n in (1, 3, 17, 100, 1000):
        for m in (6, 54):
            assert params.n_symbols(n, params.RATES[m]) == \
                jparams.n_symbols(n, jparams.RATES[m])
    for n in (0, 1, 3, 4, 5, 300, 335, 513, 27600, 40000):
        assert dispatch.pow2_ceil(n) == jdispatch.pow2_ceil(n)
        assert dispatch.pow2_bucket(n, 8) == jdispatch.pow2_bucket(n, 8)
        assert geometry.sym_bucket(n) == JGEOM.sym_bucket(n)
        assert geometry.capture_bucket(n) == JGEOM.capture_bucket(n)
    for k in (1, 3, 5, 8):
        assert dispatch.pad_lanes(list(range(k))) == \
            jdispatch.pad_lanes(list(range(k)))


# ------------------------------------------------------------- cplx, ofdm


def test_cplx_ops():
    rng = np.random.default_rng(1)
    a, b = pairs(rng, 5, 7), pairs(rng, 5, 7)
    b[0, 0] = 0.0                                  # the eps-guarded divisor
    close(cplx.cmul(t(a), t(b)), jcplx.cmul(a, b))
    close(cplx.cabs2(t(a)), jcplx.cabs2(a))
    close(cplx.cdiv(t(a), t(b)), jcplx.cdiv(a, b))
    th = rng.uniform(-40, 40, (5, 7)).astype(np.float32)
    close(cplx.cexp(t(th)), jcplx.cexp(th))


@pytest.mark.parametrize("inverse", [False, True])
def test_dft_pair(inverse):
    x = pairs(np.random.default_rng(2), 3, 9, 64)
    close(cplx.dft_pair(t(x), inverse=inverse),
          jcplx.dft_pair(x, inverse=inverse))


@pytest.mark.parametrize("front", ["dft", "idft", "mixed_front",
                                   "front_symbols"])
def test_lane_values_do_not_depend_on_the_batch(front):
    # a fleet decodes S*K lanes in one batch where a lone receiver
    # decodes its own K: each lane's soft values must be the same bits
    # in both (the DFT matmul runs in fixed row blocks)
    from ziria_tpu_torch.phy.wifi import rx
    rng = np.random.default_rng(4)
    s, k, nsb = 8, 8, 32
    if front in ("dft", "idft"):
        x = t(pairs(rng, s * k, 64))

        def fn(lo, hi):
            return cplx.dft_pair(x[lo:hi], inverse=front == "idft")
    else:
        x = t(pairs(rng, s * k, rx.FRAME_DATA_START + 80 * nsb))
        ridx = rng.integers(0, 8, s * k)
        nbits = rng.integers(24, nsb * 216, s * k)

        def fn(lo, hi):
            if front == "mixed_front":
                return rx.mixed_front(x[lo:hi], ridx[lo:hi], nbits[lo:hi],
                                      nsb)
            return rx._front_symbols(x[lo:hi], nsb)[0]
    full = fn(0, s * k)
    for size in (k, 1):
        each = torch.cat([fn(i, i + size) for i in range(0, s * k, size)])
        assert torch.equal(full, each), size


def test_ofdm_ops():
    rng = np.random.default_rng(3)
    syms = pairs(rng, 2, 5, 48)
    for i0 in (0, 1):
        close(ofdm.map_subcarriers(t(syms), symbol_index0=i0),
              jofdm.map_subcarriers(syms, symbol_index0=i0))
    bins = pairs(rng, 2, 5, 64)
    for got, want in zip(ofdm.extract_subcarriers(t(bins)),
                         jofdm.extract_subcarriers(bins)):
        same(got, want)
    close(ofdm.ofdm_modulate(t(bins)), jofdm.ofdm_modulate(bins))
    samples = pairs(rng, 2, 5, 80)
    close(ofdm.ofdm_demodulate(t(samples)), jofdm.ofdm_demodulate(samples))
    same(ofdm.preamble(), jofdm.preamble())
    same(ofdm.lts_time_symbol(), jofdm.lts_time_symbol())


# ----------------------------------------- coding, interleave, modulate


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4"])
def test_coding(rate):
    rng = np.random.default_rng(4)
    b = rng.integers(0, 2, 72).astype(np.uint8)
    coded = coding.conv_encode(t(b))
    same(coded, jcoding.conv_encode(b))
    same(coding.puncture(coded, rate), jcoding.puncture(np.asarray(coded),
                                                        rate))
    kept = int(coding.PUNCTURE_KEEP[rate].sum())
    soft = rng.normal(size=6 * kept).astype(np.float32)
    same(coding.depuncture(t(soft), rate), jcoding.depuncture(soft, rate))


@pytest.mark.parametrize("n_cbps,n_bpsc", RATE_MODES)
def test_interleave_and_modulate(n_cbps, n_bpsc):
    rng = np.random.default_rng(n_cbps + n_bpsc)
    b = rng.integers(0, 2, 3 * n_cbps).astype(np.uint8)
    same(interleave.interleave(t(b), n_cbps, n_bpsc),
         jinter.interleave(b, n_cbps, n_bpsc))
    soft = rng.normal(size=(2, 3 * n_cbps)).astype(np.float32)
    same(interleave.deinterleave(t(soft), n_cbps, n_bpsc),
         jax.vmap(lambda v: jinter.deinterleave(v, n_cbps, n_bpsc))(soft))
    same(modulate.modulate(t(b), n_bpsc), jmod.modulate(b, n_bpsc))


@pytest.mark.parametrize("n_bpsc", [1, 2, 4, 6])
def test_demap(n_bpsc):
    rng = np.random.default_rng(10 + n_bpsc)
    syms = pairs(rng, 2, 3, 48, scale=0.7)
    gain = rng.uniform(0, 2, (2, 3, 48)).astype(np.float32)
    close(demap.demap(t(syms), n_bpsc, gain=t(gain)),
          jdemap.demap(syms, n_bpsc, gain=gain))
    close(demap.demap(t(syms), n_bpsc), jdemap.demap(syms, n_bpsc))


# --------------------------------------------------------- scramble, crc


def test_scramble_and_seed_recovery():
    rng = np.random.default_rng(5)
    b = rng.integers(0, 2, 300).astype(np.uint8)
    seed = jscr.np_lfsr_sequence_127(np.ones(7, np.uint8))[:7]
    same(scramble.scramble_bits(t(b), seed), jscr.scramble_bits(b, seed))
    # lanes whose first 7 bits expose different seeds, plus one that
    # matches no seed (all-zero) and falls back to seed 0
    lanes = []
    for s in (1, 93, 127, 0):
        sb = np.array([(s >> k) & 1 for k in range(7)], np.uint8)
        raw = np.concatenate([np.zeros(16, np.uint8),
                              rng.integers(0, 2, 284).astype(np.uint8)])
        lanes.append(np.asarray(jscr.scramble_bits(raw, sb)))
    lanes = np.stack(lanes)
    want = np.stack([np.asarray(jscr.descramble_bits(
        l, jscr.recover_seed(l[:7]))) for l in lanes])
    seed = scramble.recover_seed(t(lanes[:, :7]))
    same(seed, [jbits.bits_to_uint(jscr.recover_seed(l[:7])) for l in lanes])
    same(scramble.descramble_bits(t(lanes), seed), want)


def test_crc():
    rng = np.random.default_rng(6)
    body = rng.integers(0, 2, 8 * 20).astype(np.uint8)
    same(crc.append_crc32(t(body)), jcrc.append_crc32(body))
    lanes, nbits = [], []
    for n_bytes, corrupt in ((20, False), (7, False), (12, True), (2, False),
                             (0, False)):
        b = np.array(jcrc.append_crc32(
            rng.integers(0, 2, 8 * n_bytes).astype(np.uint8)))
        if corrupt:
            b[5] ^= 1
        pad = np.zeros(8 * 40, np.uint8)
        pad[:b.size] = b
        lanes.append(pad)
        nbits.append(b.size if n_bytes else 16)        # one n_bits < 32
    lanes, nbits = np.stack(lanes), np.asarray(nbits, np.int32)
    want = jax.vmap(jcrc.check_crc32_masked)(lanes, nbits)
    same(crc.check_crc32_masked(t(lanes), t(nbits)), want)
    assert list(np.asarray(want)) == [True, True, False, True, False]


# -------------------------------------------------------------------- sync


@pytest.fixture(scope="module")
def captures():
    """Three noisy 1024-sample captures with frames at different offsets
    and CFOs (made by the port's TX, checked against JAX elsewhere)."""
    rng = np.random.default_rng(7)
    caps = []
    for k, (m, off, eps) in enumerate(((6, 40, 2e-4), (24, 300, -3e-4),
                                       (54, 7, 0.0))):
        s = tx.encode_frame(rng.integers(0, 256, 16).astype(np.uint8), m,
                            device="cpu").numpy()
        z = np.zeros(1024, np.complex128)
        z[off:off + s.shape[0]] = s[:, 0] + 1j * s[:, 1]
        z *= np.exp(1j * eps * np.arange(z.size))
        z += (rng.normal(size=z.size) + 1j * rng.normal(size=z.size)) * 0.03
        caps.append(np.stack([z.real, z.imag], -1).astype(np.float32))
    return np.stack(caps)


def test_sliding_sum_float_and_int():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 200, 2)).astype(np.float32)
    close(sync._sliding_sum(t(x), 48),
          jax.vmap(lambda v: jsync._sliding_sum(v, 48))(x))
    xi = rng.integers(0, 2, (2, 200)).astype(np.int32)
    same(sync._sliding_sum(t(xi), 33),
         jax.vmap(lambda v: jsync._sliding_sum(v, 33))(xi))


def test_detect_and_metrics(captures):
    x = captures
    lim = np.asarray([1024, 700, 1024], np.int32)
    m, c = sync.sts_autocorr(t(x))
    jm, jc = jax.vmap(jsync.sts_autocorr)(x)
    close(m, jm)
    close(c, jc)
    det, start = sync.detect_packet(t(x), limit=t(lim).long())
    jdet, jstart = jax.vmap(
        lambda v, l: jsync.detect_packet(v, limit=l))(x, lim)
    same(det, jdet)
    same(start, jstart)
    close(sync.lts_pair_metric(t(x), limit=t(lim).long()),
          jax.vmap(lambda v, l: jsync.lts_pair_metric(v, limit=l))(x, lim))


def test_locate_frame_and_cfo(captures):
    x = captures
    lim = np.full(3, 1024, np.int32)
    det, start, eps = sync.locate_frame(t(x), limit=t(lim).long())
    jdet, jstart, jeps = jax.vmap(
        lambda v, l: jsync.locate_frame(v, limit=l))(x, lim)
    same(det, jdet)
    same(start, jstart)
    close(eps, jeps)
    heads = np.stack([x[i, s:s + 400] for i, s in enumerate(jstart)])
    close(sync.estimate_cfo_sts(t(heads)),
          jax.vmap(jsync.estimate_cfo_sts)(heads))
    close(sync.estimate_cfo_lts(t(heads)),
          jax.vmap(jsync.estimate_cfo_lts)(heads))
    e = np.asarray(jeps)
    close(sync.correct_cfo(t(heads), t(e)),
          jax.vmap(jsync.correct_cfo)(heads, e))
    close(sync.estimate_channel(t(heads)),
          jax.vmap(jsync.estimate_channel)(heads))


def test_dynamic_slice_clamps_like_lax():
    x = np.arange(3 * 50 * 2, dtype=np.float32).reshape(3, 50, 2)
    starts = np.asarray([45, 0, 60], np.int32)
    want = jax.vmap(lambda v, s: jax.lax.dynamic_slice(
        v, (s, jnp.int32(0)), (10, 2)))(x, starts)
    same(sync.dynamic_slice(t(x), t(starts).long(), 10), want)
