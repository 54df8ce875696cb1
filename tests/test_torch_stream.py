"""The port's streaming receiver (backend/framebatch.receive_stream,
StreamReceiver) against the JAX package's, on the CPU.

Streams come from the reference's ``link.stream_many`` (only the tests
import both packages) at the reference suite's geometry: chunk 4096,
window 1024, K = 8, 16-byte PSDUs. One module fixture runs the JAX
receiver on the 8-rate stream in both modes; the scenario streams reuse
its compiled programs. Every emitted frame is compared with the
reference's field for field, exactly: start, ok, rate, length, payload
bits and FCS status, and the stats and dispatch counts too.
"""

import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.phy import link
from ziria_tpu.utils import dispatch as jdispatch
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import coding, interleave, modulate, ofdm
from ziria_tpu_torch.phy.wifi import params, tx
from ziria_tpu_torch.utils import dispatch

N_BYTES = 12                     # + 4 FCS bytes = 16-byte PSDUs
CHUNK, FRAME_LEN, K = 4096, 1024, 8
GEO = dict(chunk_len=CHUNK, frame_len=FRAME_LEN, max_frames_per_chunk=K,
           check_fcs=True)
RATES = sorted(params.RATES)


def same_frames(got, want):
    """Two StreamFrame lists equal start for start, field for field."""
    assert [f.start for f in got] == [int(f.start) for f in want]
    for g, w in zip(got, want):
        g, w = g.result, w.result
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        wb = np.asarray(w.psdu_bits)
        assert g.psdu_bits.dtype == wb.dtype
        np.testing.assert_array_equal(g.psdu_bits, wb)


def both(stream, **kw):
    """(port, reference) receive_stream results at the suite geometry,
    each with its package's dispatch counts: ((frames, stats, counts,
    gauges), ...)."""
    out = []
    for fb, disp, extra in ((framebatch, dispatch, {"device": "cpu"}),
                            (jfb, jdispatch, {})):
        with disp.count_dispatches() as d:
            frames, stats = fb.receive_stream(stream, **GEO, **kw, **extra)
        out.append((frames, stats, dict(d.counts), dict(d.gauges)))
    return out


def payloads(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, N_BYTES).astype(np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def corpus():
    """All 8 rates on one stream (random gaps, CFO, a delay, AWGN at 30
    dB, FCS appended) through both packages in both modes."""
    stream, starts = link.stream_many(
        payloads(8, 20260804), RATES, snr_db=30.0, cfo=1e-4, delay=60,
        seed=5, add_fcs=True, tail=FRAME_LEN)
    return (stream, starts, both(stream, streaming=True),
            both(stream, streaming=False))


def test_stream_equals_reference_in_both_modes(corpus):
    stream, starts, streamed, oracle = corpus
    for (got, *_g), (want, *_w) in (streamed, oracle):
        same_frames(got, want)
        assert [f.start for f in got] == list(starts)
        assert sorted(f.result.rate_mbps for f in got) == RATES
        assert all(f.result.ok and f.result.crc_ok for f in got)
    same_frames(streamed[0][0], oracle[0][0])


def test_stream_stats_and_dispatch_counts_equal_reference(corpus):
    _stream, starts, streamed, oracle = corpus
    for (_g, gst, gcounts, ggauges), (_w, wst, wcounts, wgauges) in (
            streamed, oracle):
        assert gst == wst
        assert gcounts == wcounts
        assert ggauges == wgauges
    (_g, st, counts, gauges), _w = streamed
    assert st.chunks >= 2 and st.frames == len(starts)
    assert st.max_in_flight == 2 and st.overflow_chunks == 0
    assert counts["rx.stream_chunk"] == st.chunks
    assert 1 <= counts["rx.stream_decode"] <= st.chunks
    assert gauges["rx.stream_inflight"] == 2
    (_g, _st, counts_p, _gp), _w = oracle
    assert counts_p["rx.decode_bucketed"] == len(starts)


def _straddle():
    # 54 Mbps frames are 480 samples on air; a 3260-sample gap puts
    # frame 1 at 3800, in chunk 0's overlap and across its 4096 end
    stream, starts = link.stream_many(
        payloads(2, 9), [54, 54], gaps=[3260], snr_db=30.0, cfo=1e-4,
        delay=60, seed=6, add_fcs=True, tail=FRAME_LEN)
    assert starts[1] == 3800 and starts[1] + 480 > CHUNK
    return stream, starts


def _minimum_gap():
    # two 960-sample 6 Mbps frames 10 samples apart
    stream, starts = link.stream_many(
        payloads(2, 10), [6, 6], gaps=[10], snr_db=30.0, cfo=1e-4,
        delay=60, seed=7, add_fcs=True, tail=FRAME_LEN)
    assert starts[1] - starts[0] == 970
    return stream, starts


def _preamble(corpus):
    stream0, starts0 = corpus[:2]
    return stream0[int(starts0[0]): int(starts0[0]) + 320]   # STS + LTS


def _overflow(corpus):
    # nine bare preambles in one chunk's owned region, K = 8
    pre = _preamble(corpus)
    rng = np.random.default_rng(11)
    stream = rng.normal(scale=0.01, size=(CHUNK + 512, 2)) \
        .astype(np.float32)
    for i in range(9):
        stream[i * 360: i * 360 + 320] += pre
    return stream, None


def _failure_lanes():
    # frame 1's SIGNAL re-encoded with its parity bit flipped, and the
    # stream cut 500 samples into frame 2's DATA
    stream, starts = link.stream_many(
        payloads(3, 13), [24, 24, 24], gaps=[400, 400], snr_db=np.inf,
        cfo=0.0, delay=60, seed=14, add_fcs=True, tail=FRAME_LEN)
    sig = tx.signal_field_bits(params.RATES[24], N_BYTES + 4)
    sig[17] ^= 1
    syms = modulate.modulate(interleave.interleave(
        coding.conv_encode(sig), 48, 1), 1)
    s1 = int(starts[1])
    stream[s1 + 320: s1 + 400] = ofdm.ofdm_modulate(ofdm.map_subcarriers(
        syms[None], symbol_index0=0))[0].numpy()
    return stream[: int(starts[2]) + 500], starts


@pytest.mark.parametrize("case", ["straddle", "minimum_gap", "overflow",
                                  "failure_lanes"])
def test_stream_scenario_equals_reference(corpus, case):
    stream, starts = {"straddle": _straddle, "minimum_gap": _minimum_gap,
                      "failure_lanes": _failure_lanes,
                      "overflow": lambda: _overflow(corpus)}[case]()
    (got, gst, gcounts, ggauges), (want, wst, wcounts, wgauges) = \
        both(stream)
    same_frames(got, want)
    assert (gst, gcounts, ggauges) == (wst, wcounts, wgauges)
    if case == "overflow":
        assert gst.overflow_chunks >= 1 and 1 <= len(got) <= K
        return
    assert [f.start for f in got] == list(starts)
    if case == "failure_lanes":
        r0, r1, r2 = (f.result for f in got)
        assert r0.ok and r0.crc_ok
        assert not r1.ok and r1.rate_mbps == 0
        assert (r2.ok, r2.rate_mbps, r2.length_bytes) == \
            (False, 24, N_BYTES + 4)
    else:
        assert all(f.result.ok and f.result.crc_ok for f in got)
    if case == "straddle":
        assert gst.chunks == 2
