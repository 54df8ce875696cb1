"""The port's channel (ziria_tpu_torch/phy/channel.py, profiles.py)
against the JAX package's, on TX batches made from a seed.

The noise is the reference's own (utils/threefry): the impaired samples
agree to ATOL, a few float32 ulps of the unit-power signal (sin, cos,
pow and the power sum round differently from XLA's; the normals within
2 ulp). Within the port, row i of ``impair_many`` equals ``impair_one``
at ``lane=i`` bit for bit, profiled or not. The checked-in golden
capture (examples/golden/wifi_rx.infile, made by the reference's
``impaired_capture``) is reproduced sample for sample, and the port's
``rx.receive`` decodes it to its ground PSDU."""

import numpy as np
import pytest
import torch

from tests.test_torch_fleet import one_thread  # noqa: F401 - autouse
from ziria_tpu.phy import channel as jch
from ziria_tpu.phy import profiles as jprof
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu.phy.wifi import tx as jtx
from ziria_tpu_torch.phy import channel as tch
from ziria_tpu_torch.phy import profiles as tprof
from ziria_tpu_torch.phy.wifi import rx as trx
from ziria_tpu_torch.phy.wifi import tx as ttx
from ziria_tpu_torch.utils import threefry

ATOL = 2e-6
RATES = (6, 9, 12, 18, 24, 36, 48, 54)
LENS = (16, 10, 16, 5, 16, 12, 9, 16)
SNR = np.float32([25.0, 30.0, 8.0, 28.0, 25.0, 3.0, 27.0, 26.0])
EPS = np.float32([(-1) ** k * 1e-3 * (k + 1) for k in range(8)])
DLY = np.arange(8) * 17 + 20
OUT_LEN = 2048
SEED = 20261017


@pytest.fixture(scope="module")
def batch():
    """One mixed-rate TX batch, made by each package's encode_many."""
    rng = np.random.default_rng(SEED)
    psdus = [rng.integers(0, 256, n).astype(np.uint8) for n in LENS]
    jb = jtx.encode_many(psdus, RATES, add_fcs=True)
    tb = ttx.encode_many(psdus, RATES, add_fcs=True, device="cpu")
    return jb, tb


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= ATOL, (what, err)


def test_profile_tables_and_host_twins():
    """Every profile's parameters, the per-lane arrays, the name
    grammar and the numpy twins equal the reference's."""
    assert list(tprof.CHANNEL_PROFILES) == list(jprof.CHANNEL_PROFILES)
    for name, p in tprof.CHANNEL_PROFILES.items():
        assert tuple(p) == tuple(jprof.CHANNEL_PROFILES[name]), name
        assert p.is_flat == jprof.CHANNEL_PROFILES[name].is_flat
    names = tuple(tprof.CHANNEL_PROFILES)
    for a, b in zip(tprof.lane_arrays(names), jprof.lane_arrays(names)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for spec in (None, "flat", "urban", "flat,severe", ["mild", "sco"],
                 tprof.CHANNEL_PROFILES["hostile"]):
        jspec = (jprof.CHANNEL_PROFILES["hostile"] if spec is
                 tprof.CHANNEL_PROFILES["hostile"] else spec)
        for use_env in (True, False):
            assert tprof.resolve_profiles(spec, 5, use_env) == \
                jprof.resolve_profiles(jspec, 5, use_env)
    for bad in ("nope", ""):
        with pytest.raises(ValueError):
            tprof.parse_profile_spec(bad)
    x = np.random.default_rng(1).normal(size=(3000, 2)).astype(np.float32)
    for name in names:
        tp, jp = tprof.get_profile(name), jprof.get_profile(name)
        assert np.array_equal(tprof.np_apply_taps(x, tp),
                              jprof.np_apply_taps(x, jp))
        assert np.array_equal(tprof.np_apply_sco(x, tp.sco),
                              jprof.np_apply_sco(x, jp.sco))
        assert np.array_equal(tprof.np_apply_drift(x, tp.drift),
                              jprof.np_apply_drift(x, jp.drift))
        if tp.burst_every:
            assert np.array_equal(tprof.np_burst_mask(3000, tp, 17),
                                  jprof.np_burst_mask(3000, jp, 17))
            assert tprof.np_burst_amp(2.5, tp) == \
                jprof.np_burst_amp(2.5, jp)


@pytest.mark.parametrize("profile", [None, list(tprof.CHANNEL_PROFILES)])
def test_impair_many_against_reference_and_lane_alone(batch, profile):
    """impair_many (unprofiled, and every profile a lane)
    against the reference's; each row bitwise equal to the port's
    impair_one at its lane (and within ATOL of the reference's)."""
    jb, tb = batch
    nv = jb.n_valid
    want = np.asarray(jch.impair_many(jb.samples, nv, SNR, EPS, DLY, 7,
                                      out_len=OUT_LEN, profile=profile))
    got = tch.impair_many(tb.samples, nv, SNR, EPS, DLY, 7, out_len=OUT_LEN,
                          profile=profile)
    _close(got, want[:got.shape[0]], f"impair_many {profile}")
    names = tprof.resolve_profiles(profile, got.shape[0], use_env=False)
    for i in (0, 2, 5, 7):
        frame = tb.samples[i, :nv[i]]
        lane_prof = None if names is None else names[i]
        one = tch.impair_one(frame, SNR[i], EPS[i], DLY[i], 7, i, OUT_LEN,
                             profile=lane_prof, device="cpu")
        assert torch.equal(one, got[i]), (profile, i)
        if profile is None and i < 3:
            ref = np.asarray(jch.impair_one(np.asarray(jb.samples[i, :nv[i]]),
                                            SNR[i], EPS[i], int(DLY[i]), 7,
                                            i, OUT_LEN))
            _close(one, ref, f"impair_one lane {i}")


def test_profile_graphs_per_profile(batch):
    """impair_profile_graph at each profile's parameters (every lane
    one profile, bursts on) and impair_profile_point_graph (the BER
    surfaces' perfect-sync channel) against the reference's; a flat
    lane of the profiled graph equals impair_graph bitwise."""
    import jax
    import jax.numpy as jnp

    jb, tb = batch
    r = tb.samples.shape[0]
    x_t = torch.nn.functional.pad(tb.samples, (0, 0, 0, OUT_LEN
                                               - tb.samples.shape[1]))
    x_j = np.asarray(x_t)
    nv = np.concatenate([jb.n_valid, np.repeat(jb.n_valid[:1],
                                               r - len(jb.n_valid))])
    pad = np.concatenate

    def rows(a):
        return pad([a, np.repeat(a[:1], r - len(a))])
    snr, eps, dly = rows(SNR), rows(EPS), rows(DLY)
    keys_t = tch.lane_key(7, torch.arange(r))
    keys_j = jax.vmap(lambda i: jch.lane_key(7, i))(jnp.arange(r))
    names = tuple(tprof.CHANNEL_PROFILES)
    lane_names = tuple(names[i % len(names)] for i in range(r))
    arrs = tprof.lane_arrays(lane_names)
    want = jax.vmap(lambda *a: jch.impair_profile_graph(*a, with_bursts=True))(
        x_j, nv, snr, eps, dly, keys_j, *arrs)
    at = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    got = tch.impair_profile_graph(
        x_t, torch.from_numpy(nv.astype(np.int64)), torch.from_numpy(snr),
        torch.from_numpy(eps), torch.from_numpy(dly.astype(np.int64)),
        keys_t, at[0], at[1], at[2], at[3].long(), at[4].long(), at[5])
    _close(got, want, "impair_profile_graph")
    flat = tch.impair_graph(x_t, torch.from_numpy(nv.astype(np.int64)),
                            torch.from_numpy(snr), torch.from_numpy(eps),
                            torch.from_numpy(dly.astype(np.int64)), keys_t)
    for i, nm in enumerate(lane_names):
        if nm == "flat":
            assert torch.equal(got[i], flat[i])
    frames = ttx.encode_batch(np.stack([np.arange(24, dtype=np.uint8)] * 4),
                              36, device="cpu")
    k = jax.random.split(jax.random.PRNGKey(5), 4)
    kt = threefry.split(threefry.prng_key(5), 4)
    for name in ("urban", "bursty", "hostile"):
        want = jch.impair_profile_point_graph(np.asarray(frames), k, 6.0,
                                              name)
        got = tch.impair_profile_point_graph(frames, kt, 6.0, name)
        _close(got, want, f"impair_profile_point_graph {name}")


def test_impair_stream_and_multipath():
    """impair_stream (host float64 math, the port's draws) against the
    reference's, unprofiled, with a bursty profile and with SCO; the
    complex FIR against the reference's."""
    rng = np.random.default_rng(3)
    x = np.zeros((6000, 2), np.float32)
    x[500:4500] = rng.normal(size=(4000, 2)) / np.sqrt(2)
    for prof, snr in ((None, 12.0), ("hostile", 20.0), ("sco", np.inf),
                      ("bursty", np.inf)):
        want = jch.impair_stream(x, 4000, snr, 0.003, 41, profile=prof,
                                 lane=2)
        got = tch.impair_stream(x, 4000, snr, 0.003, 41, profile=prof,
                                lane=2, device="cpu")
        assert got.dtype == np.float32
        _close(got, want, f"impair_stream {prof}")
    taps = np.asarray(tprof.CHANNEL_PROFILES["severe"].taps, np.float32)
    _close(tch.multipath(torch.from_numpy(x), torch.from_numpy(taps)),
           jch.multipath(x, taps), "multipath")
    key = threefry.prng_key(9)
    import jax
    _close(tch.awgn(key, torch.from_numpy(x[:800]), 5.0),
           jch.awgn(jax.random.PRNGKey(9), x[:800], 5.0), "awgn")
    _close(tch.delay(key, torch.from_numpy(x[500:800]), 30, 20),
           jch.delay(jax.random.PRNGKey(9), x[500:800], 30, 20), "delay")
    _close(tch.apply_phase(torch.from_numpy(x[:64]), 0.7),
           jch.apply_phase(x[:64], 0.7), "apply_phase")


def test_golden_capture_reproduced_and_received():
    """The port's impaired_capture reproduces the checked-in golden
    capture's int16 bytes (no sample differs), and the port's
    rx.receive returns its ground PSDU with a good FCS, as the
    reference's rx.receive does on the same file."""
    raw = np.fromfile("examples/golden/wifi_rx.infile",
                      dtype="<i2").reshape(-1, 2)
    ground = np.fromfile("examples/golden/wifi_rx.outfile.ground",
                         dtype=np.uint8)
    psdu, xi = tch.impaired_capture(24, 60, 119, floor=0.02, add_fcs=True,
                                    device="cpu")
    assert np.array_equal(psdu, ground)
    assert xi.dtype == np.int16 and xi.shape == raw.shape
    assert int((xi != raw).any(-1).sum()) == 0
    x = raw.astype(np.float32)
    got = trx.receive(x, check_fcs=True, device="cpu")
    want = jrx.receive(x, check_fcs=True)
    for r in (got, want):
        assert (r.ok, r.rate_mbps, r.length_bytes, r.crc_ok) == \
            (True, 24, 64, True)
        body = np.packbits(np.asarray(r.psdu_bits), bitorder="little")
        assert np.array_equal(body[:60], ground)
    assert np.array_equal(got.psdu_bits, np.asarray(want.psdu_bits))
