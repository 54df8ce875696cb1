"""The port's last public counterparts against the JAX package on the
CPU, on seeded numpy inputs handed to both: ``viterbi_decode_bits``,
``crc32_bytes`` and ``crc32_bytes_masked``,
``lfsr_sequence_127``, the pair helpers and the DFTs' ``axis=``,
``rx.decode_data_static``, ``DispatchCount.total_time``/``times_ms``,
``Observatory.site_costs`` and ``observing(obs=)``, and the numpy bit
helpers. Bits and integers exact; floats within test_torch_ops.py's
rtol = atol = 1e-5.
"""

import importlib.util
import os

import numpy as np
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.ops import coding as jcoding, cplx as jcplx, crc as jcrc, \
    scramble as jscr, viterbi as jvit
from ziria_tpu.utils import bits as jbits, dispatch as jdispatch, \
    programs as jprograms
from ziria_tpu_torch.ops import cplx, crc, scramble, viterbi
from ziria_tpu_torch.utils import bits, dispatch, programs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def tailed_bits(rng, n):
    """Random bits with 6 zero tail bits (tests/test_viterbi.py's)."""
    b = rng.integers(0, 2, n).astype(np.uint8)
    b[-6:] = 0
    return b


def test_viterbi_decode_bits():
    """tests/test_viterbi.py's hard-decision cases (a 120-bit round
    trip, the first 30 of 50 bits) and the same codes with coded bits
    flipped, one stream and as a batch, each bit for bit the
    reference's."""
    rng = np.random.default_rng(11)
    for n, n_bits in ((120, None), (50, 30), (200, None)):
        src = tailed_bits(rng, n)
        coded = np.asarray(jcoding.conv_encode(src)).astype(np.uint8)
        noisy = coded.copy()
        noisy[rng.choice(coded.size, coded.size // 25, replace=False)] ^= 1
        rows = []
        for c in (coded, noisy):
            want = np.asarray(jvit.viterbi_decode_bits(c, n_bits))
            got = viterbi.viterbi_decode_bits(c, n_bits, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)
            rows.append(want)
        np.testing.assert_array_equal(rows[0], src[:n_bits])
        batch = viterbi.viterbi_decode_bits(torch.from_numpy(
            np.stack([coded, noisy])), n_bits, device="cpu")
        np.testing.assert_array_equal(batch.numpy(), np.stack(rows))


def test_crc32_bytes_and_masked():
    """The check value 0xCBF43926, lengths 0, 1 and the whole pad, and
    a batch of lanes at mixed true lengths, each register equal to the
    reference's uint32."""
    check = np.frombuffer(b"123456789", np.uint8)
    assert int(crc.crc32_bytes(check)) == 0xCBF43926 == \
        int(jcrc.crc32_bytes(check))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (7, 64)).astype(np.uint8)
    lens = np.array([0, 1, 64, 17, 63, 2, 40])
    for row, n in zip(data, lens):
        want = int(jcrc.crc32_bytes(row[:n]))
        assert int(crc.crc32_bytes(torch.from_numpy(row[:n]))) == want
        assert int(jcrc.crc32_bytes_masked(row, n)) == want
        assert int(crc.crc32_bytes_masked(row, n)) == want
    got = crc.crc32_bytes_masked(torch.from_numpy(data),
                                 torch.from_numpy(lens))
    assert got.shape == (7,)
    assert got.tolist() == [int(jcrc.crc32_bytes_masked(r, n))
                            for r, n in zip(data, lens)]


def test_lfsr_sequence_127_every_seed():
    """All 127 non-zero seeds: the tensor equals np_lfsr_sequence_127's
    period and the reference's scan."""
    import jax
    seeds = np.array([[(s >> k) & 1 for k in range(7)]
                      for s in range(1, 128)], np.uint8)
    ref = np.asarray(jax.vmap(jscr.lfsr_sequence_127)(seeds))
    for s, want in zip(seeds, ref):
        got = scramble.lfsr_sequence_127(s, device="cpu")
        assert got.dtype == torch.uint8 and got.shape == (127,)
        np.testing.assert_array_equal(got.numpy(),
                                      scramble.np_lfsr_sequence_127(s))
        np.testing.assert_array_equal(got.numpy(), want)


def test_pair_helpers_and_dft_axis():
    """cpack, cre, cim, conj, cscale and to_complex exactly; the DFTs
    along axes 0, 1 and -2 within the tolerance; and along axis 0 a
    column's values the same bits at 24 columns as at 3."""
    rng = np.random.default_rng(9)
    re, im = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(2))
    p = np.asarray(jcplx.cpack(re, im))
    tp = cplx.cpack(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_array_equal(tp.numpy(), p)
    np.testing.assert_array_equal(cplx.cre(tp).numpy(), jcplx.cre(p))
    np.testing.assert_array_equal(cplx.cim(tp).numpy(), jcplx.cim(p))
    np.testing.assert_array_equal(cplx.conj(tp).numpy(), jcplx.conj(p))
    s = rng.normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        cplx.cscale(tp, torch.from_numpy(s)).numpy(), jcplx.cscale(p, s))
    np.testing.assert_array_equal(cplx.cscale(tp, 2.5).numpy(),
                                  jcplx.cscale(p, 2.5))
    np.testing.assert_array_equal(cplx.to_complex(tp).numpy(),
                                  jcplx.to_complex(p))
    np.testing.assert_array_equal(cplx.to_complex(p), jcplx.to_complex(p))
    x = rng.normal(size=(64, 24, 2)).astype(np.float32)
    y = rng.normal(size=(3, 64, 5, 2)).astype(np.float32)
    for arr, axis in ((x, 0), (y, 1), (y, -2), (x, -3)):
        tx_ = torch.from_numpy(arr)
        np.testing.assert_allclose(cplx.fft_pair(tx_, axis=axis),
                                   jcplx.fft_pair(arr, axis=axis), **TOL)
        np.testing.assert_allclose(cplx.ifft_pair(tx_, axis=axis),
                                   jcplx.ifft_pair(arr, axis=axis), **TOL)
        np.testing.assert_allclose(
            cplx.dft_pair(tx_, inverse=True, axis=axis),
            jcplx.dft_pair(arr, inverse=True, axis=axis), **TOL)
    full = cplx.fft_pair(torch.from_numpy(x), axis=0)
    part = torch.cat([cplx.fft_pair(torch.from_numpy(x[:, i:i + 3]), axis=0)
                      for i in range(0, 24, 3)], dim=1)
    assert torch.equal(full, part)


def test_decode_data_static_at_every_rate():
    """A 100-byte PSDU at each of the 8 rates (tx.encode_frame, plus
    noise): the PSDU and service bits of the port's static decode equal
    the reference's, field for field, and the PSDU is the one sent."""
    from ziria_tpu.phy.wifi import rx as jrx
    from ziria_tpu_torch.phy.wifi import rx, tx
    from ziria_tpu_torch.phy.wifi.params import RATES
    rng = np.random.default_rng(15)
    for mbps, rate in sorted(RATES.items()):
        psdu = rng.integers(0, 256, 100).astype(np.uint8)
        frame = tx.encode_frame(psdu, mbps, device="cpu").numpy()
        frame = frame + rng.normal(0, 0.02, frame.shape).astype(np.float32)
        n_sym = (frame.shape[0] - rx.FRAME_DATA_START) // 80
        got = rx.decode_data_static(frame, rate, n_sym, 800, device="cpu")
        want = jrx.decode_data_static(frame, jrx.RATES[mbps], n_sym, 800)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{mbps} Mbit/s")
        np.testing.assert_array_equal(bits.np_bits_to_bytes(got[0].numpy()),
                                      psdu)
        np.testing.assert_array_equal(bits.np_bytes_to_bits(psdu),
                                      jbits.np_bytes_to_bits(psdu))


def test_dispatch_times_site_costs_and_observing():
    """DispatchCount's total_time and times_ms with the reference's
    rounding; site_costs over the same records as the reference's and
    as tools/trace_report.site_costs_of's normalization (the largest
    bytes per label, errors and zero bytes skipped); observing(obs=)
    activating the given observatory."""
    times = {"rx.decode": 0.0123456789, "rx.acquire": 1.5e-4,
             "link.fused": 2.0}
    counts = []
    for mod in (dispatch, jdispatch):
        c = mod.DispatchCount()
        for label, sec in times.items():
            c._add(label, 1, sec)
            c._add(label, 2, None)
        counts.append((c.total, c.total_time, c.times_ms()))
    assert counts[0] == counts[1]
    assert counts[0][2] == {"link.fused": 2000.0, "rx.acquire": 0.15,
                            "rx.decode": 12.346}
    recs = [{"label": "a", "flops": 10.0, "bytes_accessed": 100.0},
            {"label": "a", "flops": 20.0, "bytes_accessed": 200.0},
            {"label": "b", "error": "boom"},
            {"label": "c", "flops": 1.0, "bytes_accessed": 0.0},
            {"label": "d", "flops": 3.0, "bytes_accessed": 7.0}]
    got = []
    for mod in (programs, jprograms):
        obs = mod.Observatory()
        obs.analyze = lambda _r=recs, **_k: [dict(r) for r in _r]
        got.append(obs.site_costs())
    assert got[0] == got[1] == {"a": recs[1], "d": recs[4]}
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    assert tr.site_costs_of({"programs": recs}) == {
        k: {"bytes_accessed": v["bytes_accessed"], "flops": v["flops"]}
        for k, v in got[0].items()}
    mine = programs.Observatory()
    with programs.observing(mine) as active:
        assert active is mine
        programs.note_site("x.site", torch.add, torch.zeros(3),
                           torch.ones(3))
    programs.note_site("x.site", torch.add, torch.zeros(3), torch.ones(3))
    assert [n.calls for n in mine.notes.values()] == [1]
    (rec,) = mine.analyze()
    assert rec["label"] == "x.site" and rec["bytes_accessed"] == 36.0
    assert mine.site_costs() == {"x.site": rec}
