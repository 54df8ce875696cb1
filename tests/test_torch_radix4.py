"""The port's radix-4 ACS (two trellis steps as one butterfly) against the
JAX package's and against radix 2, on the CPU, and the radix knob's
environment reader.

The plain radix-4 sweep follows ``_acs_pair_r4_f32``'s expression order
(the step-1 candidates p[j], then their maxima m01/m23, then step 2), so
holding it against the Pallas ``_acs_kernel_r4`` in interpret mode holds
the pair formulation itself; the CUDA kernel is held against the plain
version on the card (test_torch_gpu.py). Tolerance is bitwise for
decisions, metrics and bits: radix 4 is radix 2 bit for bit by
construction, at every metric type. Soft inputs come from numpy seeds,
with an all-erasure lane and erasure tails.
"""

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fused import ALL, _frames, t
from ziria_tpu.ops import viterbi as jviterbi, viterbi_pallas as jvp
from ziria_tpu.phy.wifi import params as jparams, rx as jrx
from ziria_tpu.utils import geometry as jgeometry
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import viterbi, viterbi_cuda as vc, \
    viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params, rx, tx
from ziria_tpu_torch.utils import geometry

B, T = 4, 256
N_SYM = 4                      # fused decodes: symbols (bucket 4)


def _llrs(seed):
    """Random soft pairs (B, T, 2): lane 1 all erasures, lanes 2 and 3
    with erasure tails."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, 2)) * 2.0).astype(np.float32)
    x[1] = 0.0
    x[2, 130:] = 0.0
    x[3, 61:] = 0.0
    return x


def _capture(seed, mbps=54):
    """One short noisy capture behind 30 samples of silence."""
    rng = np.random.default_rng(seed)
    s = tx.encode_frame(rng.integers(0, 256, 8).astype(np.uint8), mbps,
                        add_fcs=True, device="cpu").numpy()
    cap = np.concatenate([np.zeros((30, 2), np.float32), s])
    return cap + rng.normal(0, 0.02, cap.shape).astype(np.float32)


def _lanes(a):
    """Pallas (1, Tp, k, 128) lane tiles -> the first B lanes (B, Tp, k)."""
    return np.array(np.asarray(a)[0, ..., :B].transpose(2, 0, 1))


def test_plain_radix4_acs_equals_pallas_radix4_kernel():
    llr = _llrs(0)
    tiles, _ = jvp._to_tiles(llr)
    dec, met = jvp._acs_tiles(tiles, True, "float32", 4)
    bits = jvp._traceback_tiles(dec, met, True)
    got_dec, got_met = vc.acs_plain(t(llr), radix=4)
    np.testing.assert_array_equal(got_dec.numpy(), _lanes(dec))
    np.testing.assert_array_equal(got_met.numpy(),
                                  np.asarray(met)[0, :, :B].T)
    np.testing.assert_array_equal(
        vc.traceback_plain(got_dec, got_met).numpy(),
        np.asarray(bits)[0, :, 0, :B].T)


def test_plain_radix4_equals_radix2_every_metric():
    llr = _llrs(1)
    rails = np.full((B, T, 2), 15, np.int16)     # long runs of +-15
    rails[:, 64:160] = -15
    rails[1] = 0
    for md, x in (("float32", t(llr)),
                  ("int16", vc._quantize_for("int16", t(llr))),
                  ("int8", vc._quantize_for("int8", t(llr))),
                  ("int8", t(rails))):
        d2, m2 = vc.acs_plain(x, metric_dtype=md, radix=2)
        d4, m4 = vc.acs_plain(x, metric_dtype=md, radix=4)
        assert torch.equal(d4, d2), md
        assert m4.dtype == m2.dtype and torch.equal(m4, m2), md
        # the 72-step cadence of the fused kernels too
        x72 = torch.nn.functional.pad(x, (0, 0, 0, 288 - T))
        for r in (2, 4):
            assert torch.equal(vc.acs_plain(x72, 72, md, r)[0],
                               vc.acs_plain(x72, 72, md, 2)[0])


def test_fused_plain_decodes_radix4_equal_radix2():
    rng = np.random.default_rng(5)
    data = t(rng.normal(0, 0.7, (8, N_SYM, 48, 2)).astype(np.float32))
    gain = t(rng.uniform(0.2, 2.0, (8, 48)).astype(np.float32))
    ridx = np.arange(8)
    ndb = np.asarray([params.RATES[m].n_dbps for m in ALL])
    nb = rng.integers(0, N_SYM * ndb + 1)
    nb[0], nb[1] = 0, 2 * ndb[1] + 5
    got = vf.fused_acs_mixed_plain(data, gain, ridx, nb, radix=4)
    want = vf.fused_acs_mixed_plain(data, gain, ridx, nb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for m in ALL:
        rate = params.RATES[m]
        x = vf.pad_symbols(data[:3], rate)
        nbr = [0, 40, x.shape[1] * rate.n_dbps]
        got = vf.fused_acs_rate_plain(x, gain[:3], rate, nbr, radix=4)
        want = vf.fused_acs_rate_plain(x, gain[:3], rate, nbr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1]), m


def test_radix4_fused_decodes_equal_pallas_fused_kernels():
    rng = np.random.default_rng(20261016)
    frames = _frames(rng, ALL, N_SYM)
    ndb = np.asarray([params.RATES[m].n_dbps for m in ALL])
    nb = rng.integers(0, N_SYM * ndb + 1).astype(np.int32)
    nb[0], nb[1] = 0, 2 * ndb[1] + ndb[1] // 2 + 1
    data, gain = rx._front_symbols(t(frames), N_SYM)
    want = np.asarray(jvp.viterbi_decode_mixed_fused(
        data.numpy(), gain.numpy(), np.arange(8, dtype=np.int32), nb,
        radix=4, interpret=True))
    got = vf.viterbi_decode_mixed_fused(data, gain, np.arange(8), t(nb),
                                        radix=4)
    np.testing.assert_array_equal(got.numpy(), want)
    # 6 Mbps: the known-rate kernel's smallest block (3 symbols, 72
    # steps), and so its quickest interpret-mode compile
    want = np.asarray(jvp.viterbi_decode_batch_fused(
        data[:3, :3].numpy(), gain[:3].numpy(), jparams.RATES[6],
        nbits_real=np.asarray([30, 0, 72]), radix=4, interpret=True))
    got = vf.viterbi_decode_batch_fused(data[:3, :3], gain[:3],
                                        params.RATES[6],
                                        nbits_real=[30, 0, 72], radix=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_radix_env_reaches_the_kernel(monkeypatch):
    """ZIRIA_VITERBI_RADIX=4 with viterbi_radix=None: every entry point
    reaches the radix-4 ACS, the kernel whose launch count is acs_r4
    (fused_mixed_r4 fused) on the card; on the CPU the wrapper calls
    its plain version in that mode."""
    seen = []
    plain = vc.acs_plain

    def spy(llr, renorm=vc.RENORM, metric_dtype="float32", radix=2):
        seen.append(radix)
        return plain(llr, renorm, metric_dtype, radix)
    monkeypatch.setattr(vc, "acs_plain", spy)
    monkeypatch.setenv("ZIRIA_VITERBI_RADIX", "4")
    assert viterbi._check_radix(None) == 4
    assert vc.ACS_KEYS[("float32", 4)] == "acs_r4"
    assert vf._key("fused_mixed", 4) == "fused_mixed_r4"
    vc.reset_launches()
    vf.reset_launches()
    vc.viterbi_decode_batch(t(_llrs(2)))
    cap = _capture(3)
    many = framebatch.receive_many([cap], check_fcs=True, device="cpu")
    one = rx.receive(cap, check_fcs=True, device="cpu")
    fused = framebatch.receive_many([cap], check_fcs=True, device="cpu",
                                    fused_demap=True)
    assert seen == [4] * 4
    assert many[0].crc_ok and one.crc_ok and fused[0].crc_ok
    monkeypatch.setenv("ZIRIA_VITERBI_RADIX", "2")
    framebatch.receive_many([cap], device="cpu")
    assert seen[-1] == 2
    # only launches count: the plain versions ran
    assert not any(vc.LAUNCHES.values()) and not any(vf.LAUNCHES.values())


def test_bad_knob_values_raise_as_the_reference(monkeypatch):
    def message(fn, *args):
        with pytest.raises(ValueError) as err:
            fn(*args)
        return str(err.value)

    for raw in ("3", "four", "-2"):
        monkeypatch.setenv("ZIRIA_VITERBI_RADIX", raw)
        assert message(geometry.env_viterbi_radix) == \
            message(jgeometry.env_viterbi_radix)
        assert message(viterbi._check_radix, None) == \
            message(jviterbi._check_radix, None)
        with pytest.raises(ValueError, match="ZIRIA_VITERBI_RADIX"):
            rx.receive(_capture(4), device="cpu")
    monkeypatch.setenv("ZIRIA_VITERBI_RADIX", "")
    assert geometry.env_viterbi_radix() == jgeometry.env_viterbi_radix() == 2
    assert message(viterbi._check_radix, 3) == \
        message(jviterbi._check_radix, 3)
    assert message(viterbi._check_metric_dtype, "int4") == \
        message(jviterbi._check_metric_dtype, "int4")
    monkeypatch.setenv("ZIRIA_VITERBI_METRIC", "int4")
    assert message(geometry.env_viterbi_metric) == \
        message(jgeometry.env_viterbi_metric)
    for raw, want in (("int8", "int8"), ("", "float32")):
        monkeypatch.setenv("ZIRIA_VITERBI_METRIC", raw)
        assert geometry.env_viterbi_metric() == \
            jgeometry.env_viterbi_metric() == want
    for raw in ("256", "x", ""):
        monkeypatch.setenv("ZIRIA_VITERBI_WINDOW", raw)
        assert geometry.env_viterbi_window() == \
            jgeometry.env_viterbi_window()
    with pytest.raises(ValueError, match="radix"):
        vc.acs(t(_llrs(0)), radix=3)
    with pytest.raises(ValueError):
        vc.acs(t(_llrs(0)), metric_dtype="int16")       # float input
    assert set(jviterbi.METRIC_DTYPES) == set(viterbi.METRIC_DTYPES)
    assert jviterbi.RADIXES == viterbi.RADIXES
    assert (jrx.FRAME_DATA_START, jvp.DEFAULT_WINDOW_OVERLAP) == \
        (rx.FRAME_DATA_START, vc.DEFAULT_WINDOW_OVERLAP)
