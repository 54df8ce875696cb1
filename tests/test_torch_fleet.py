"""The port's S-stream fleet (backend/framebatch.MultiStreamReceiver,
receive_streams; rx.multi_stream_chunk_graph, stream_decode_multi_graph)
against S lone port receivers and the JAX package's unsharded fleet, on
the CPU, at the reference suite's geometry (chunk 4096, window 1024,
K 8, S 8, 16-byte PSDUs).

The streams are made with numpy and the port's TX (``chip_smoke.
make_stream``, AWGN at 25 dB): all 8 rates across the fleet, a frame
straddling its chunk boundary, an all-noise stream, an empty one, ragged
lengths. One module fixture runs the port's fleet, S lone port receivers
and the reference fleet under dispatch counters; frames compare field
for field, stats, dispatch counts and gauges exactly.
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_stream
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.utils import dispatch as jdispatch
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import rx
from ziria_tpu_torch.utils import dispatch

PSDU = 16                        # bytes on air, FCS included
CHUNK, FRAME_LEN, K, S = 4096, 1024, 8, 8
GEO = dict(chunk_len=CHUNK, frame_len=FRAME_LEN, max_frames_per_chunk=K,
           check_fcs=True)
# per stream: rates, and the gap after each frame (None: U[300, 600))
LOAD = [([6, 54], None), ([54, 54], [3260]), None, ([24, 36, 48], None),
        ([9, 12], [1200]), ([18], None), (), ([48, 6], [700])]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run the module's torch work on one thread: the suite runs on
    several workers at once, and every worker's 8-thread OpenMP pool
    spinning on one host's cores slowed the whole run many times over
    (the fleet's S*K-lane tensors cross torch's parallel grain)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_frames(got, want):
    """Two StreamFrame lists equal start for start, field for field."""
    assert [int(f.start) for f in got] == [int(f.start) for f in want]
    for g, w in zip(got, want):
        g, w = g.result, w.result
        assert (g.ok, g.rate_mbps, g.length_bytes, g.crc_ok) == \
            (w.ok, w.rate_mbps, w.length_bytes, w.crc_ok)
        np.testing.assert_array_equal(g.psdu_bits, np.asarray(w.psdu_bits))


def fleet_streams(seed=20261017):
    """The 8 streams of LOAD (None: noise only; (): empty) and each
    one's true starts."""
    rng = np.random.default_rng(seed)
    streams, starts = [], []
    for i, load in enumerate(LOAD):
        if load is None:
            streams.append(rng.normal(scale=0.05, size=(CHUNK + 2000, 2))
                           .astype(np.float32))
            starts.append([])
            continue
        if not load:
            streams.append(np.zeros((0, 2), np.float32))
            starts.append([])
            continue
        rates, gaps = load
        x, st, _truth = make_stream(
            rng, "cpu", rates, [PSDU] * len(rates),
            lambda j, n: gaps[j] if j < len(gaps or ())
            else int(rng.integers(300, 600)),
            1e-4 * (i + 1), FRAME_LEN)
        streams.append(x)
        starts.append([int(s) for s in st])
    return streams, starts


def both_fleets(streams, **kw):
    """(port, reference) receive_streams results, each (per-stream
    frames, stats, dispatch counts, gauges)."""
    out = []
    for fb, disp, extra in ((framebatch, dispatch, {"device": "cpu"}),
                            (jfb, jdispatch, {})):
        with disp.count_dispatches() as d:
            per, st = fb.receive_streams(streams, **GEO, **kw, **extra)
        out.append((per, st, dict(d.counts), dict(d.gauges)))
    return out


@pytest.fixture(scope="module")
def corpus():
    streams, starts = fleet_streams()
    port, ref = both_fleets(streams)
    with dispatch.count_dispatches() as d:
        lone, lone_st = framebatch.receive_streams(
            streams, multi=False, device="cpu", **GEO)
    return streams, starts, port, ref, (lone, lone_st, dict(d.counts))


def test_fleet_equals_lone_receivers_and_reference(corpus):
    streams, starts, (per, st, counts, gauges), ref, lone = corpus
    r_per, r_st, r_counts, r_gauges = ref
    lone_per, lone_st, lone_counts = lone
    for i in range(S):
        same_frames(per[i], lone_per[i])
        same_frames(per[i], r_per[i])
        assert [f.start for f in per[i]] == starts[i]
        assert all(f.result.ok and f.result.crc_ok for f in per[i])
    assert {f.result.rate_mbps for p in per for f in p} == \
        {6, 9, 12, 18, 24, 36, 48, 54}
    assert per[2] == [] and per[6] == []
    # the straddling frame starts in chunk 0's overlap, crosses its end,
    # and is emitted once, equal to per-capture receive over its window
    assert starts[1][1] == 3800 and starts[1][1] + 480 > CHUNK
    f = per[1][1]
    ref1 = rx.receive(streams[1][f.start:f.start + FRAME_LEN],
                      check_fcs=True, device="cpu")
    same_frames([f], [framebatch.StreamFrame(f.start, ref1)])
    # stats, dispatch counts and gauges are the reference fleet's
    assert tuple(st) == tuple(r_st)
    assert counts == r_counts and gauges == r_gauges
    assert st.streams == S and st.chunk_steps >= 2
    assert counts["rx.stream_chunk_multi"] == st.chunk_steps
    assert counts["rx.stream_decode_multi"] <= st.chunk_steps
    assert sum(counts.values()) <= 2 * st.chunk_steps
    assert st.max_in_flight == 2 and gauges["rx.stream_inflight"] == 2
    assert gauges["rx.active_streams"] == st.max_active_streams == 7
    assert "rx.stream_carry_depth[s6]" not in gauges
    # S lone receivers pay a scan per stream chunk
    assert lone_counts["rx.stream_chunk"] == lone_st.chunk_steps \
        > st.chunk_steps
    assert lone_st.frames == st.frames


def test_all_noise_fleet_and_one_stream(corpus):
    streams, _starts, (per, *_p), _ref, _lone = corpus
    rng = np.random.default_rng(31)
    noise = [rng.normal(scale=0.05, size=(2 * CHUNK, 2)).astype(np.float32)
             for _ in range(S)]
    (got, st, counts, gauges), (r_got, r_st, r_counts, r_gauges) = \
        both_fleets(noise)
    assert got == [[] for _ in range(S)] and r_got == got
    assert tuple(st) == tuple(r_st) and counts == r_counts
    assert gauges == r_gauges
    # one step each, and no decode, for the whole fleet
    assert counts == {"rx.stream_chunk_multi": st.chunk_steps}
    # S = 1: the fleet of one stream is that stream's lone receiver (and
    # lane 0 of the reference fleet)
    with dispatch.count_dispatches() as d:
        one, st1 = framebatch.receive_streams(streams[:1], **GEO,
                                              device="cpu")
    lone, lst = framebatch.receive_stream(streams[0], **GEO, device="cpu")
    same_frames(one[0], lone)
    same_frames(one[0], per[0])
    assert (st1.chunk_steps, st1.frames) == (lst.chunks, lst.frames)
    assert st1.streams == 1 and st1.max_active_streams == 1
    assert sum(d.counts.values()) <= 2 * st1.chunk_steps


def test_ragged_pushes_thread_the_carries(corpus):
    streams, _starts, (per, *_p), _ref, _lone = corpus
    msr = framebatch.MultiStreamReceiver(S, **GEO, device="cpu")
    jmsr = jfb.MultiStreamReceiver(S, **GEO)
    got, jgot = [], []
    for a, b in [(0, 500), (500, 3500), (3500, 4200), (4200, 7000),
                 (7000, None)]:
        for i in range(S):
            got += msr.push(i, streams[i][a:b])
            jgot += jmsr.push(i, streams[i][a:b])
    got += msr.flush()
    jgot += jmsr.flush()
    assert [(i, f.start) for i, f in got] == \
        [(i, int(f.start)) for i, f in jgot]
    assert tuple(msr.stats) == tuple(jmsr.stats)
    for i in range(S):
        same_frames([f for j, f in got if j == i], per[i])
        c, jc = msr.carry(i), jmsr.carry(i)
        assert (c.offset, c.emitted, c.watermark) == \
            (jc.offset, jc.emitted, jc.watermark)
        np.testing.assert_array_equal(c.tail, np.asarray(jc.tail))
        assert c.offset + c.tail.shape[0] == streams[i].shape[0]
    assert msr.carry(1).watermark > 0 and msr.carry(6).watermark == 0
    assert len(msr.carries) == S
    with pytest.raises(RuntimeError):
        msr.push(0, streams[0][:8])
    with pytest.raises(RuntimeError):
        msr.push_many([s[:0] for s in streams])


def test_lane_of_the_fleet_programs_equals_one_stream(corpus):
    # lane i of an S-stream scan equals the S = 1 scan on lane i, and
    # each stream's rows of the fleet decode equal its own decode
    streams, *_rest = corpus
    n_sym_b = framebatch.MultiStreamReceiver(S, **GEO, device="cpu") \
        .n_sym_bucket
    chunks = np.zeros((S, CHUNK, 2), np.float32)
    for i, x in enumerate(streams):
        chunks[i, :min(CHUNK, x.shape[0])] = x[:CHUNK]
    valid = torch.tensor([min(CHUNK, x.shape[0]) for x in streams])
    own_lo = torch.full((S,), -192)
    own_hi = torch.full((S,), CHUNK - FRAME_LEN)
    args = (K, FRAME_LEN, n_sym_b)
    fleet = rx.multi_stream_chunk_graph(torch.from_numpy(chunks), valid,
                                        own_lo, own_hi, *args)
    for i in range(S):
        one = rx.stream_chunk_graph(torch.from_numpy(chunks[i:i + 1]),
                                    valid[i:i + 1], own_lo[i:i + 1],
                                    own_hi[i:i + 1], *args)
        for a, b in zip(fleet, one):
            assert torch.equal(a[i:i + 1], b)
    segs = fleet[-1]
    rows = np.zeros((S, K), np.int64)
    ridx = np.zeros((S, K), np.int64)
    nbits = np.zeros((S, K), np.int64)
    npsdu = np.zeros((S, K), np.int64)
    rows[:, :2] = [0, 1]
    ridx[:, :2] = [[i % 8, (i + 3) % 8] for i in range(S)]
    nbits[:, :2] = [[30 + 7 * i, 200 + i] for i in range(S)]
    npsdu[:, :2] = [[128, 64] for _ in range(S)]
    clear, crc = rx.stream_decode_multi_graph(segs, rows, ridx, nbits,
                                              npsdu, n_sym_b)
    assert clear.shape == (S, K, n_sym_b * 216) and crc.shape == (S, K)
    for i in range(S):
        c1, k1 = rx.stream_decode_graph(segs[i], list(rows[i]),
                                        list(ridx[i]), list(nbits[i]),
                                        list(npsdu[i]), n_sym_b)
        assert torch.equal(clear[i, :2], c1[:2])
        assert torch.equal(crc[i, :2], k1[:2])


def test_bad_geometry_knob_mesh_and_stream_ids(monkeypatch):
    with pytest.raises(ValueError, match="n_streams"):
        framebatch.MultiStreamReceiver(0, **GEO, device="cpu")
    with pytest.raises(ValueError, match="capture bucket"):
        framebatch.MultiStreamReceiver(2, chunk_len=4096, frame_len=1000,
                                       device="cpu")
    with pytest.raises(ValueError, match="must exceed"):
        framebatch.MultiStreamReceiver(2, chunk_len=1024, frame_len=1024,
                                       device="cpu")
    # a mesh that does not divide the streams, and a mesh on the lone-
    # receiver path: the reference's errors, word for word
    import jax
    from jax.sharding import Mesh as JMesh
    from ziria_tpu_torch.parallel.mesh import Mesh
    for fb, three, extra in (
            (framebatch, Mesh(["cpu"] * 3, ("dp",)), {"device": "cpu"}),
            (jfb, JMesh(np.array(jax.devices()[:3]), ("dp",)), {})):
        msgs = []
        for call in (lambda: fb.MultiStreamReceiver(8, mesh=three, **GEO,
                                                    **extra),
                     lambda: fb.receive_streams(
                         [np.zeros((8, 2), np.float32)], mesh=three,
                         multi=False, **GEO, **extra)):
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
        if fb is framebatch:
            port_msgs = msgs
    assert msgs == port_msgs
    assert "must divide the mesh (3 devices)" in msgs[0]
    assert "needs the fleet path" in msgs[1]
    per, stats = framebatch.receive_streams([], **GEO, device="cpu")
    assert per == [] and stats.streams == 0
    msr = framebatch.MultiStreamReceiver(4, **GEO, device="cpu")
    for exc, call in (
            (IndexError, lambda: msr.push(7, np.zeros((4, 2)))),
            (IndexError, lambda: msr.push(-1, np.zeros((4, 2)))),
            (KeyError, lambda: msr.push_many({9: np.zeros((4, 2))})),
            (IndexError, lambda: msr.checkpoint(4)),
            (IndexError, lambda: msr.carry(11)),
            (IndexError, lambda: msr.quarantined(5)),
            (IndexError, lambda: msr.flush_stream(4)),
            (IndexError, lambda: msr.reset_stream(-2)),
            (IndexError, lambda: msr.restore_stream(6, b"x"))):
        with pytest.raises(exc, match=r"known\s+ids are 0\.\.3"):
            call()
    with pytest.raises(ValueError, match="4 streams need 4 slabs"):
        msr.push_many([np.zeros((4, 2), np.float32)])
    with pytest.raises(ValueError, match="stream 1.*\\(n, 2\\)"):
        msr.push(1, np.zeros((4, 3)))
    with pytest.raises(ValueError, match="stream 2.*non-finite"):
        msr.push(2, np.full((4, 2), np.nan, np.float32))
    # the knob: default on, "0" off, an explicit argument wins
    monkeypatch.delenv("ZIRIA_MULTI_STREAM", raising=False)
    assert framebatch.multi_stream_enabled(None)
    monkeypatch.setenv("ZIRIA_MULTI_STREAM", "0")
    assert not framebatch.multi_stream_enabled(None)
    assert framebatch.multi_stream_enabled(True)
    monkeypatch.setenv("ZIRIA_MULTI_STREAM", "8")
    assert framebatch.multi_stream_enabled(None)
    assert not framebatch.multi_stream_enabled(False)
    # a fleet built from a Geometry takes its width from it
    from ziria_tpu_torch.utils import geometry
    g = geometry.Geometry(n_streams=3, chunk_len=CHUNK, frame_len=FRAME_LEN)
    assert framebatch.MultiStreamReceiver(geometry=g, device="cpu").s == 3
