"""The port's CUDA kernels against their plain PyTorch versions (and each
radix-4 kernel against its radix-2 twin), on the card. Marked ``gpu``:
without a card every test skips (the fixture decides, at run time). On
a machine with one:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import FUSED_EXACT, FUSED_INF, FUSED_LANES, FUSED_QUIET, \
    longest_psdu, make_stream, need_stop
from test_torch_crc import FULL_BITS, edge_lanes, masked_loop
from test_torch_fused_stop import _inputs
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import crc, viterbi_cuda as vc, viterbi_fused as vf
from ziria_tpu_torch.phy.wifi import params, rx, tx
from ziria_tpu_torch.utils import dispatch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _only(module, **counts):
    """The module's whole launch-count dict: `counts`, 0 elsewhere."""
    return {k: counts.get(k, 0) for k in module.LAUNCHES}


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
    assert vc.LAUNCHES == _only(vc, acs=1, traceback=1)
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
    assert vf.LAUNCHES == _only(vf, fused_mixed=1)
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
    assert vf.LAUNCHES == _only(vf, fused_rate=1)
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


def _quantized(b, t, md, seed):
    """Random soft pairs quantized for `md` (per-frame scale), with an
    all-erasure lane and an erasure tail, and for int8 a lane of long
    +-15 runs that reaches the -128 rail."""
    q = vc._quantize_for(md, _llr(b, t, seed))
    if md == "int8" and b > 3:
        q[3] = 15
        q[3, t // 4: t // 2] = -15
    return q


@pytest.mark.parametrize("md,radix", [("float32", 4), ("int16", 2),
                                      ("int16", 4), ("int8", 2),
                                      ("int8", 4)])
@pytest.mark.parametrize("b,t", [(1, 64), (33, 1024), (130, 4160)])
def test_mode_acs_kernels_equal_plain_and_radix2(cuda, md, radix, b, t):
    x = (_llr(b, t, b + t) if md == "float32"
         else _quantized(b, t, md, b + t)).to(cuda)
    vc.reset_launches()
    dec, met = vc.acs(x, md, radix)
    bits = vc.traceback(dec, met)
    torch.cuda.synchronize()
    assert vc.LAUNCHES == _only(vc, traceback=1,
                                **{vc.ACS_KEYS[(md, radix)]: 1})
    assert met.dtype == (torch.float32 if md == "float32" else torch.int32)
    dec_p, met_p = vc.acs_plain(x, metric_dtype=md, radix=radix)
    assert torch.equal(dec, dec_p)
    assert torch.equal(met.view(torch.int32), met_p.view(torch.int32))
    assert torch.equal(bits, vc.traceback_plain(dec, met))
    dec2, met2 = vc.acs(x, md, 2)
    assert torch.equal(dec, dec2) and torch.equal(met, met2)


@pytest.mark.parametrize("b,n_sym", [(1, 4), (128, 16)])
def test_fused_radix4_kernels_equal_plain_and_radix2(cuda, b, n_sym):
    ridx = np.arange(b) % 8
    data, gain, nbits = (t.to(cuda) for t in _fused_inputs(b, n_sym, ridx,
                                                           b + n_sym))
    vf.reset_launches()
    got = vf.fused_acs_mixed(data, gain, ridx, nbits, radix=4)
    torch.cuda.synchronize()
    assert vf.LAUNCHES == _only(vf, fused_mixed_r4=1)
    _same_acs(got, vf.fused_acs_mixed_plain(data, gain, ridx, nbits,
                                            radix=4))
    _same_acs(got, vf.fused_acs_mixed(data, gain, ridx, nbits))
    for mbps in sorted(params.RATES):
        rate = params.RATES[mbps]
        n_sym_p = 2 * vf.symbols_per_block(rate)
        data, gain, nbits = (t.to(cuda) for t in _fused_inputs(
            b, n_sym_p, np.full(b, params.RATE_INDEX[mbps]), mbps))
        vf.reset_launches()
        got = vf.fused_acs_rate(data, gain, rate, nbits, radix=4)
        torch.cuda.synchronize()
        assert vf.LAUNCHES == _only(vf, fused_rate_r4=1)
        _same_acs(got, vf.fused_acs_rate_plain(data, gain, rate, nbits,
                                               radix=4))
        _same_acs(got, vf.fused_acs_rate(data, gain, rate, nbits))


def test_decode_modes_on_card_equal_cpu(cuda):
    caps = _captures(3)
    modes = [({"viterbi_radix": 4}, {"acs_r4": 1}),
             ({"viterbi_metric": "int16"}, {"acs_i16": 1}),
             ({"viterbi_metric": "int8", "viterbi_radix": 4},
              {"acs_i8_r4": 1}),
             ({"viterbi_window": 256}, {"acs": 1}),
             ({"fused_demap": True, "viterbi_radix": 4}, {})]
    for knobs, counts in modes:
        vc.reset_launches()
        vf.reset_launches()
        got = framebatch.receive_many(caps, check_fcs=True, device=cuda,
                                      **knobs)
        assert vc.LAUNCHES == _only(vc, traceback=1, **counts), knobs
        if knobs.get("fused_demap"):
            assert vf.LAUNCHES == _only(vf, fused_mixed_r4=1)
        want = framebatch.receive_many(caps, check_fcs=True, device="cpu",
                                       **knobs)
        for g, w in zip(got, want):
            assert g.ok and g.crc_ok, knobs
            assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
                (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
            np.testing.assert_array_equal(g.psdu_bits, w.psdu_bits)
        one = rx.receive(caps[-1], check_fcs=True, device=cuda, **knobs)
        assert one.crc_ok
        np.testing.assert_array_equal(one.psdu_bits, got[-1].psdu_bits)


def _edge_llr(b, t, seed):
    """Soft pairs with a lane with no erasure (0), an all-erasure lane
    (3), lanes 9, 11, ..., 41 live up to 8 steps before to 8 after the
    renorm boundary t // 2, a -0.0 tail (1) and an inf before a tail
    (7)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, t, 2)) * 2.0).astype(np.float32)
    x[3] = 0.0
    for i, off in enumerate(range(-8, 9)):
        x[9 + 2 * i, t // 2 + off:] = 0.0
    x[1, t // 2 + 100:] = -0.0
    x[7, t // 3, 0] = np.inf
    x[7, 3 * t // 4:] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("md,radix", [(md, r) for md in
                                      ("float32", "int16", "int8")
                                      for r in (2, 4)])
def test_acs_stop_edge_lanes_equal_plain(cuda, md, radix):
    t = 2048
    x = _edge_llr(43, t, 11).to(cuda)
    if md != "float32":
        x = vc._quantize_for(md, x)
    vc.reset_launches()
    dec, met, stops = vc.acs_with_stops(x, md, radix)
    bits = vc.traceback(dec, met)
    torch.cuda.synchronize()
    assert vc.LAUNCHES == _only(vc, traceback=1,
                                **{vc.ACS_KEYS[(md, radix)]: 1})
    _same_acs((dec, met), vc.acs_plain(x, metric_dtype=md, radix=radix))
    assert torch.equal(bits, vc.traceback_plain(dec, met))
    live = (x != 0).any(dim=2).cpu().numpy()
    last = np.array([np.flatnonzero(r).max() if r.any() else -1
                     for r in live])
    s = stops.cpu().numpy()
    assert ((s % 64 == 0) & (s <= t) & (s > last)).all()
    assert s[0] == t
    if md == "float32":
        assert s[7] == t                         # inf: never +0 metrics


def test_traceback_on_full_sweep_words_equals_plain(cuda):
    # the fused path's words (zero past each frame's stop),
    # and random words over a trellis long enough for segments of two
    # 256-word chunks, with a zero run and a zero tail
    ridx = np.arange(16) % 8
    data, gain, nbits = (v.to(cuda) for v in _fused_inputs(16, 64, ridx, 5))
    dec, met = vf.fused_acs_mixed(data, gain, ridx, nbits)
    assert torch.equal(vc.traceback(dec, met), vc.traceback_plain(dec, met))
    rng = np.random.default_rng(6)
    tp = 2048 * 256 + 1000
    w = rng.integers(0, 2 ** 63, size=(2, tp), dtype=np.int64)
    w[:, 1000:300000] = 0
    w[1, 400000:] = 0
    dec = torch.from_numpy(w.view(np.uint8).reshape(2, tp, 8).copy())
    met = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    got = vc.traceback(dec.to(cuda), met.to(cuda)).cpu().numpy()
    for f in range(2):                 # the walk of traceback_plain
        words = w[f].view(np.uint64).tolist()
        s, want = int(np.argmax(met[f].numpy())), np.empty(tp, np.uint8)
        for t in range(tp - 1, -1, -1):
            want[t] = s >> 5
            s = ((s & 31) << 1) | ((words[t] >> s) & 1)
        np.testing.assert_array_equal(got[f], want)


def _fused_edge_inputs(n_sym, ndbps, edge, seed, dev):
    """The CPU stop test's inputs (chip_smoke.py's stop edge lanes) on
    the card, bit counts as int32."""
    data, gain, nbits = _inputs(n_sym, ndbps, edge, seed)
    return (data.to(dev), gain.to(dev),
            torch.from_numpy(nbits.astype(np.int32)).to(dev))


def _check_fused_stops(stops, nbits, cadence, tp):
    """Each stop a multiple of the cadence, at or past the frame's bits,
    at the first boundary 6 steps past them (where the metrics are all
    +0) for every lane but the inf one, which sweeps to Tp."""
    s, nb = stops.cpu().numpy(), nbits.cpu().numpy().astype(np.int64)
    assert ((s % cadence == 0) & (s <= tp) & ((s >= nb) | (s == tp))).all()
    assert s[FUSED_INF] == tp
    np.testing.assert_array_equal(s[FUSED_EXACT],
                                  need_stop(nb[FUSED_EXACT], cadence, tp))


@pytest.mark.parametrize("radix", [2, 4])
def test_fused_stop_edge_lanes_equal_plain(cuda, radix):
    n_sym = 8                                   # mixed: Tp 1728, edge 864
    ridx = np.arange(FUSED_LANES) % 8
    ridx[FUSED_QUIET] = 0                       # BPSK: zero symbols, +0 pairs
    ndbps = [params.RATES[params.RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    data, gain, nbits = _fused_edge_inputs(n_sym, ndbps, 864, radix, cuda)
    vf.reset_launches()
    dec, met, stops = vf.fused_acs_mixed_with_stops(data, gain, ridx, nbits,
                                                    radix)
    torch.cuda.synchronize()
    assert vf.LAUNCHES == _only(vf, **{vf._key("fused_mixed", radix): 1})
    _same_acs((dec, met), vf.fused_acs_mixed_plain(data, gain, ridx, nbits,
                                                   radix))
    assert torch.equal(vc.traceback(dec, met), vc.traceback_plain(dec, met))
    _check_fused_stops(stops, nbits, vf.MIXED_UNROLL, n_sym * 216)
    for mbps, n_sym, edge in ((6, 36, 432), (12, 18, 480), (54, 8, 864)):
        rate = params.RATES[mbps]
        data, gain, nbits = _fused_edge_inputs(
            n_sym, [rate.n_dbps] * FUSED_LANES, edge, mbps + radix, cuda)
        vf.reset_launches()
        dec, met, stops = vf.fused_acs_rate_with_stops(data, gain, rate,
                                                       nbits, radix)
        torch.cuda.synchronize()
        assert vf.LAUNCHES == _only(vf, **{vf._key("fused_rate", radix): 1})
        _same_acs((dec, met), vf.fused_acs_rate_plain(data, gain, rate,
                                                      nbits, radix))
        assert torch.equal(vc.traceback(dec, met),
                           vc.traceback_plain(dec, met))
        _check_fused_stops(stops, nbits,
                           vf.symbols_per_block(rate) * rate.n_dbps,
                           n_sym * rate.n_dbps)


@pytest.mark.parametrize("width,lanes", [(8 * 70, None), (FULL_BITS, 128)])
def test_masked_crc_on_card_equals_plain_loop(cuda, width, lanes):
    # the edge lanes (0 ... 40 bits, the full width, a clamped FCS
    # start, all ones) and random ones; at full width 128 lanes
    bits, nb = edge_lanes(width, width)
    if lanes is not None:
        rng = np.random.default_rng(3)
        extra = torch.from_numpy(rng.integers(0, 2, (lanes - bits.shape[0],
                                                     width)).astype(np.uint8))
        bits = torch.cat([bits, extra])
        nb = torch.cat([nb, torch.full((extra.shape[0],), width)])
    got = crc.check_crc32_masked(bits.to(cuda), nb.to(cuda))
    assert torch.equal(got, masked_loop(bits.to(cuda), nb.to(cuda)))
    assert torch.equal(got.cpu(), crc.check_crc32_masked(bits, nb))


def test_stream_default_on_card_equals_cpu(cuda):
    # Geometry() defaults, 16 frames of the 8 rates at 20 symbols
    rng = np.random.default_rng(4)
    order = [params.RATE_MBPS_ORDER[i % 8] for i in range(16)]
    stream, starts, truth = make_stream(
        rng, "cpu", order, [longest_psdu(params.RATES[m], 20) for m in order],
        lambda i, n: int(rng.integers(300, 600)), 0.004, 2048)
    vc.reset_launches()
    with dispatch.count_dispatches() as d:
        got, st = framebatch.receive_stream(stream, check_fcs=True,
                                            device=cuda)
    decodes = d.counts["rx.stream_decode"]
    assert vc.LAUNCHES == _only(vc, acs=decodes, traceback=decodes)
    want, wst = framebatch.receive_stream(stream, check_fcs=True,
                                          device="cpu")
    assert st == wst and [f.start for f in got] == list(starts)
    for g, w, (m, n, bits) in zip(got, want, truth):
        g, w = g.result, w.result
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok) == (True, m, n, True)
        np.testing.assert_array_equal(g.psdu_bits, w.psdu_bits)
        np.testing.assert_array_equal(g.psdu_bits, bits)


FLEET_GEO = dict(chunk_len=4096, frame_len=1024, max_frames_per_chunk=8,
                 check_fcs=True)


def _fleet_streams(n=8, seed=12):
    """n streams of 2-4 16-byte frames at rotating rates, and one
    all-noise stream in place of the last."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n - 1):
        rates = [params.RATE_MBPS_ORDER[(i + j) % 8] for j in range(2 + i % 3)]
        x, _st, _t = make_stream(rng, "cpu", rates, [16] * len(rates),
                                 lambda j, m: int(rng.integers(300, 2600)),
                                 1e-4 * i, 1024)
        out.append(x)
    out.append(rng.normal(scale=0.05, size=(6000, 2)).astype(np.float32))
    return out


def _fleet_run(streams, dev, **kw):
    msr = framebatch.MultiStreamReceiver(len(streams), **FLEET_GEO,
                                         device=dev, **kw)
    got = []
    for lo in range(0, max(x.shape[0] for x in streams), 1500):
        got += msr.push_many([x[lo:lo + 1500] for x in streams])
    got += msr.flush()
    per = [[] for _ in streams]
    for i, f in got:
        per[i].append(f)
    return per, msr


def _same_stream_frames(got, want):
    assert [f.start for f in got] == [f.start for f in want]
    for g, w in zip(got, want):
        g, w = g.result, w.result
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        np.testing.assert_array_equal(g.psdu_bits, w.psdu_bits)


def test_fleet_on_card_equals_cpu_and_lone_receivers(cuda):
    streams = _fleet_streams()
    vc.reset_launches()
    with dispatch.count_dispatches() as d:
        per, msr = _fleet_run(streams, cuda)
    decodes = d.counts["rx.stream_decode_multi"]
    assert vc.LAUNCHES == _only(vc, acs=decodes, traceback=decodes)
    assert d.counts["rx.stream_chunk_multi"] == msr.stats.chunk_steps
    want, cpu = _fleet_run(streams, "cpu")
    assert msr.stats == cpu.stats and not msr.stats.degraded
    for i, x in enumerate(streams):
        _same_stream_frames(per[i], want[i])
        lone, _st = framebatch.receive_stream(x, **FLEET_GEO, device=cuda)
        _same_stream_frames(per[i], lone)
    assert sum(len(p) for p in per) >= 14 and per[-1] == []


@pytest.mark.parametrize("site", ["decode", "scan"])
def test_fleet_on_card_degrades_only_for_an_injected_fault(cuda, site,
                                                           monkeypatch):
    from ziria_tpu_torch.utils import faults
    streams = _fleet_streams(4, seed=13)
    want, _m = _fleet_run(streams, cuda)
    label = "rx.stream_decode_multi" if site == "decode" \
        else "rx.stream_chunk_multi"
    with faults.inject(faults.FaultSpec(label, "fatal", calls=(1,))):
        per, msr = _fleet_run(streams, cuda)
    assert msr._strict and msr.stats.degraded
    for g, w in zip(per, want):
        _same_stream_frames(g, w)
    msr = framebatch.MultiStreamReceiver(4, **FLEET_GEO, device=cuda)

    def boom(*_a, **_k):
        raise RuntimeError("a real device failure")
    monkeypatch.setattr(msr, "_decode" if site == "decode" else "_scan",
                        boom)
    with pytest.raises(RuntimeError, match="real device failure"):
        for lo in range(0, 12000, 1500):
            msr.push_many([x[lo:lo + 1500] for x in streams])
        msr.flush()
    assert not msr.stats.degraded


def test_fleet_watchdog_launches_on_the_callers_thread(cuda, monkeypatch):
    import threading

    from ziria_tpu_torch.utils import faults
    streams = _fleet_streams(4, seed=14)
    want, _m = _fleet_run(streams, cuda)
    seen = set()
    for mod, name in ((vc, "_acs"), (vc, "traceback")):
        fn = getattr(mod, name)

        def tapped(*a, fn=fn, **k):
            seen.add(threading.get_ident())
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, tapped)
    with faults.inject(faults.FaultSpec("rx.stream_*_multi", "hang",
                                        every=2, delay_s=0.5)) as p:
        per, msr = _fleet_run(streams, cuda, watchdog_s=0.1)
    assert len(p.fired) >= 2 and not msr.stats.degraded
    assert seen == {threading.get_ident()}
    assert threading.active_count() == 1 or all(
        not t.name.startswith("ziria") for t in threading.enumerate())
    for g, w in zip(per, want):
        _same_stream_frames(g, w)


def test_threefry_draw_on_card_equals_cpu(cuda):
    """The channel's draws on the card equal the CPU's bit for bit:
    keys, words, uniforms and randint are integer ops, and the normal's
    erfinv uses only correctly rounded float ops (frexp, add, multiply,
    divide, sqrt, the float64 FMA twin)."""
    from ziria_tpu_torch.utils import threefry

    keys = threefry.fold_in(threefry.prng_key(20261017), torch.arange(16))
    kc = keys.to(cuda)
    assert torch.equal(threefry.bits(kc, (513, 2)).cpu(),
                       threefry.bits(keys, (513, 2)))
    assert torch.equal(threefry.uniform(kc, (4096,)).cpu(),
                       threefry.uniform(keys, (4096,)))
    assert torch.equal(threefry.normal(kc, (4096, 2)).cpu(),
                       threefry.normal(keys, (4096, 2)))
    assert torch.equal(threefry.randint(kc, (), 0, 1200).cpu(),
                       threefry.randint(keys, (), 0, 1200))


def test_link_on_card_fused_equals_staged_and_cpu(cuda):
    """loopback_many on the card: fused (default and fused_demap) equal
    to staged lane for lane, every frame right, and equal to the CPU's
    run; impair_many row i equal to impair_one at lane i."""
    from ziria_tpu_torch.phy import channel, link

    rng = np.random.default_rng(21)
    rates = [sorted(params.RATES)[i % 8] for i in range(16)]
    psdus = [rng.integers(0, 256, 200).astype(np.uint8) for _ in rates]
    kw = dict(snr_db=25.0, cfo=rng.uniform(-0.01, 0.01, 16),
              delay=rng.integers(0, 200, 16), seed=4, add_fcs=True,
              check_fcs=True)
    fu = link.loopback_many(psdus, rates, device=cuda, **kw)
    st = link.loopback_many(psdus, rates, fused=False, device=cuda, **kw)
    fd = link.loopback_many(psdus, rates, fused_demap=True, device=cuda, **kw)
    cpu = link.loopback_many(psdus, rates, device="cpu", **kw)
    for other in (st, fd, cpu):
        for a, b in zip(fu, other):
            assert (a.ok, a.rate_mbps, a.length_bytes, a.crc_ok) == \
                (b.ok, b.rate_mbps, b.length_bytes, b.crc_ok)
            assert np.array_equal(a.psdu_bits, b.psdu_bits)
    assert all(r.ok and r.crc_ok for r in fu)
    b = tx.encode_many(psdus, rates, add_fcs=True, device=cuda)
    caps = channel.impair_many(b.samples, b.n_valid[0], 25.0, 0.003, 7, 9,
                               out_len=8192)
    for i in (0, 5, 15):
        one = channel.impair_one(b.samples[i, :b.n_valid[0]], 25.0, 0.003,
                                 7, 9, i, 8192, device=cuda)
        assert torch.equal(one, caps[i])


@pytest.mark.parametrize("site", ["fused", "sweep"])
def test_link_on_card_degrades_only_for_an_injected_fault(cuda, site,
                                                          monkeypatch):
    """On the card a fault injected at ``link.fused`` (``link.sweep``)
    degrades the batch to the staged link (the sweep to its loop of
    loopback_ber_bits) with the same results, counted once; a real
    failure of the device pass raises and degrades nothing."""
    from ziria_tpu_torch.phy import link
    from ziria_tpu_torch.utils import faults, telemetry

    rng = np.random.default_rng(23)
    if site == "fused":
        rates = sorted(params.RATES)
        psdus = [rng.integers(0, 256, 100).astype(np.uint8) for _ in rates]
        kw = dict(snr_db=25.0, cfo=1e-3, delay=30, seed=3, add_fcs=True,
                  check_fcs=True, device=cuda)

        def run():
            return link.loopback_many(psdus, rates, **kw)
        want = link.loopback_many(psdus, rates, fused=False, **kw)
        inner = "_fused_pass"
    else:
        psdus = rng.integers(0, 256, (8, 40)).astype(np.uint8)

        def run():
            return link.sweep_ber(psdus, (6, 54), (0.0, 8.0), (1,),
                                  device=cuda)
        want = run()
        inner = "_sweep_points"
    with telemetry.collect() as reg, faults.inject(
            faults.FaultSpec(f"link.{site}", "fatal", calls=(0,))) as plan:
        got = run()
    assert len(plan.fired) == 1
    assert reg.counters()[f"link.{site}_degraded"] == 1
    if site == "fused":
        for a, b in zip(got, want):
            assert (a.ok, a.rate_mbps, a.length_bytes, a.crc_ok) == \
                (b.ok, b.rate_mbps, b.length_bytes, b.crc_ok)
            assert np.array_equal(a.psdu_bits, b.psdu_bits)
    else:
        assert np.array_equal(got, want)

    def boom(*_a, **_k):
        raise RuntimeError("a real device failure")
    monkeypatch.setattr(link, inner, boom)
    with telemetry.collect() as reg, \
            pytest.raises(RuntimeError, match="real device failure"):
        run()
    assert not [k for k in reg.counters() if "degraded" in k]


@pytest.mark.parametrize("name,mode,backend", [
    ("correlator", "dbg", "jit"),
    ("wifi_rx", "bin", "hybrid")])
def test_compiler_golden_case_on_card(cuda, name, mode, backend, tmp_path):
    """A jit golden case and the flagship receiver on the hybrid backend
    through the port's CLI on the card: each output equal to its
    committed ground file (both exact under tests/test_golden.py's
    tolerances), on the backend asked for, the receiver's heavy
    do-blocks on the device."""
    import os

    from ziria_tpu_torch.frontend import compile_file
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream

    ex = os.path.join(os.path.dirname(__file__), "..", "examples")
    src = os.path.join(ex, f"{name}.zir")
    gold = os.path.join(ex, "golden")
    outf = str(tmp_path / "out")
    assert cli.main([
        f"--src={src}", f"--input-file-name={gold}/{name}.infile",
        f"--input-file-mode={mode}", f"--output-file-name={outf}",
        f"--output-file-mode={mode}", f"--backend={backend}"]) == 0
    assert cli.LAST_RUN["backend"] == backend
    ty = compile_file(src).out_ty
    got = read_stream(StreamSpec(ty=ty, path=outf, mode=mode))
    want = read_stream(StreamSpec(
        ty=ty, path=f"{gold}/{name}.outfile.ground", mode=mode))
    np.testing.assert_array_equal(got, want)
    if backend == "hybrid":
        assert cli.LAST_RUN["blocks_device"] > 0


def test_fxp_primitives_on_card_equal_cpu(cuda):
    """Every ops/fxp primitive (the float64 DFT products included) and
    ext_math function on the card, bitwise equal to the CPU's."""
    from chip_smoke import fxp_primitive_checks

    done = fxp_primitive_checks(np.random.default_rng(11), cuda)
    assert "dft64_q14" in done and "atan2_int16" in done


@pytest.mark.parametrize("window", [None, 1024])
def test_fxp_batch_decode_on_card_equals_cpu(cuda, window):
    """decode_data_batch_fxp on the card: one ACS and one traceback
    launch, every PSDU right and the bits equal to the CPU's decode of
    the same quantized frames (exact and windowed)."""
    from ziria_tpu_torch.phy.wifi import rx_fxp

    rng = np.random.default_rng(12)
    rate = params.RATES[54]
    n_bytes = 300
    n_sym = params.n_symbols(n_bytes, rate)
    psdus = rng.integers(0, 256, (16, n_bytes)).astype(np.uint8)
    frames = tx.encode_batch(psdus, 54, device="cpu")
    frames = frames + 0.02 * torch.from_numpy(
        rng.normal(size=tuple(frames.shape)).astype(np.float32))
    fq = rx_fxp.quantize_frame(frames)
    vc.reset_launches()
    got, svc = rx_fxp.decode_data_batch_fxp(fq.to(cuda), rate, n_sym,
                                            8 * n_bytes,
                                            viterbi_window=window)
    torch.cuda.synchronize()
    assert vc.LAUNCHES == _only(vc, acs=1, traceback=1)
    want, want_svc = rx_fxp.decode_data_batch_fxp(fq, rate, n_sym,
                                                  8 * n_bytes,
                                                  viterbi_window=window)
    assert torch.equal(got.cpu(), want) and torch.equal(svc.cpu(), want_svc)
    np.testing.assert_array_equal(
        want.numpy(), np.unpackbits(psdus, axis=1, bitorder="little"))


def test_programs_profile_counts_the_kernel_launches(cuda):
    """The observatory on the card: the ACS and traceback kernels the
    profiler saw equal the launch counters' delta over the same block,
    they land in the decode's site, and busy + idle is the window."""
    from ziria_tpu_torch.utils import programs

    rng = np.random.default_rng(2)
    caps = []
    for k, m in enumerate(sorted(params.RATES)):
        s = tx.encode_frame(rng.integers(0, 256, 60).astype(np.uint8), m,
                            add_fcs=True, device="cpu").numpy()
        caps.append(np.concatenate([np.zeros((30 + 9 * k, 2), np.float32),
                                    s]))
    framebatch.receive_many(caps, check_fcs=True, device=cuda)
    obs = programs.Observatory()
    vc.reset_launches()
    with obs.profile("batch", cuda):
        got = framebatch.receive_many(caps, check_fcs=True, device=cuda)
    rep = obs.profiles["batch"]
    assert all(r.ok and r.crc_ok for r in got)
    assert programs.kernel_count(rep, r"acs_kernel", r"fused") == \
        vc.LAUNCHES["acs"] == 1
    assert programs.kernel_count(rep, r"traceback_kernel") == \
        vc.LAUNCHES["traceback"] == 1
    top = [k["name"] for k in rep["sites"]["rx.decode_mixed"]["top_kernels"]]
    assert rep["sites"]["rx.decode_mixed"]["launches"] >= 2
    assert any("acs_kernel" in n for n in top) or \
        rep["sites"]["rx.decode_mixed"]["device_ms"] > 0
    assert rep["kernels"] > 2 and 0 < rep["busy_share"] <= 1
    assert rep["busy_share"] + rep["idle_share"] == pytest.approx(1.0)


def test_serve_main_on_the_card_equals_cpu(cuda, capsys):
    """``python -m ziria_tpu_torch serve`` on the card (the default
    platform): every session's frame served, the stats balanced and
    equal to the CPU run's."""
    import json

    from ziria_tpu_torch.runtime import serve

    argv = ["--lanes", "2", "--sessions", "3", "--frames", "1"]
    reports = []
    for extra in ([], ["--platform=cpu"]):
        assert serve.main(argv + extra) == 0
        reports.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    card, cpu = reports
    assert card["frames"] == cpu["frames"] == 3
    assert card["stats"] == cpu["stats"]
    st = card["stats"]
    assert st["admitted"] == st["closed"] == 3 and st["shed"] == 0


def test_mesh_paths_on_card_equal_unsharded(cuda):
    """Four mesh entries of the one card (the reference tests' virtual
    devices, here on the card with the kernels inside each shard): a
    4-stream fleet equal to its unsharded run with one ACS and one
    traceback launch a shard a decode dispatch; the sharded sweep and
    stream_parallel equal to their one-device runs."""
    import ziria_tpu_torch as z
    from ziria_tpu_torch.backend.execute import run_jit
    from ziria_tpu_torch.parallel import stream_parallel
    from ziria_tpu_torch.parallel.mesh import Mesh
    from ziria_tpu_torch.phy import link

    rng = np.random.default_rng(13)
    # 16-byte PSDUs (FCS included): at 6 Mbit/s 7 symbols, inside a
    # 1024-sample window
    streams = [make_stream(rng, cuda, [6, 54, 24], [16] * 3,
                           lambda j, n: 500, 1e-4 * (i + 1), 1024)[0]
               for i in range(4)]
    geo = dict(chunk_len=4096, frame_len=1024, max_frames_per_chunk=8,
               check_fcs=True)
    mesh = Mesh([cuda] * 4, ("dp",))
    per, st = framebatch.receive_streams(streams, **geo, device=cuda)
    vc.reset_launches()
    with dispatch.count_dispatches() as d:
        got, gst = framebatch.receive_streams(streams, mesh=mesh, **geo,
                                              device=cuda)
    torch.cuda.synchronize()
    decodes = d.counts["rx.stream_decode_multi"]
    assert decodes > 0 and vc.LAUNCHES == _only(vc, acs=4 * decodes,
                                                 traceback=4 * decodes)
    assert tuple(gst) == tuple(st)
    for a, b in zip(got, per):
        assert [f.start for f in a] == [f.start for f in b] and len(a) == 3
        for fa, fb in zip(a, b):
            assert fa.result.ok and fa.result.crc_ok
            assert np.array_equal(fa.result.psdu_bits, fb.result.psdu_bits)
    psdus = rng.integers(0, 256, (8, 40)).astype(np.uint8)
    args = (psdus, [6, 54], [0.0, 6.0], [0])
    np.testing.assert_array_equal(
        link.sweep_ber_sharded(*args, mesh=mesh, device=cuda),
        link.sweep_ber(*args, device=cuda))
    prog = z.pipe(z.zmap(lambda x: x * 3 + 1, name="aff"),
                  z.map_accum(lambda s, x: (s + 1, x + s), 7, name="ctr",
                              advance=lambda s, n: s + n))
    xs = np.arange(4 * 300 + 13, dtype=np.int32)
    np.testing.assert_array_equal(
        stream_parallel(prog, xs, Mesh([cuda] * 4, ("sp",))),
        run_jit(prog, xs, device=cuda))


def test_nccl_world_of_one(cuda):
    """init_multihost brings an NCCL group of one up on the card (an
    all_reduce through it) and tears it down."""
    import socket

    import torch.distributed as dist

    from ziria_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert multihost.init_multihost(f"127.0.0.1:{port}", 1, 0,
                                    device="cuda", timeout_s=60)
    try:
        v = torch.arange(4, device=cuda)
        dist.all_reduce(v)
        assert dist.get_backend() == "nccl" and v.tolist() == [0, 1, 2, 3]
    finally:
        multihost.shutdown_multihost()
    assert not dist.is_initialized()
