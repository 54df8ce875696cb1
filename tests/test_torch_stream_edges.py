"""Edges of the port's streaming receiver against the JAX package's, on
the CPU, at test_torch_stream.py's geometry (chunk 4096, window 1024,
K = 8, 16-byte PSDUs): a stream that starts mid-preamble, a plateau in
the deferred overlap, all-noise chunks, slabs pushed across chunk
boundaries, the per-lane detector cap and the multi-frame detector.
Frames, stats and dispatch counts compare exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_stream import FRAME_LEN, GEO, K, RATES, both, payloads, \
    same_frames
from ziria_tpu.ops import sync as jsync
from ziria_tpu.phy import link
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import sync
from ziria_tpu_torch.phy.wifi import rx
from ziria_tpu_torch.utils import geometry

CHUNK = GEO["chunk_len"]


@pytest.fixture(scope="module")
def stream8():
    """The 8-rate stream of test_torch_stream.py and its reference
    frames."""
    stream, starts = link.stream_many(
        payloads(8, 20260804), RATES, snr_db=30.0, cfo=1e-4, delay=60,
        seed=5, add_fcs=True, tail=FRAME_LEN)
    return stream, starts, both(stream)[1][0]


def test_head_truncated_preamble_equals_reference(stream8):
    # the stream starts 40 samples into frame 0's preamble: its start
    # clamps to 0 on the stream's first chunk (own_lo = -192)
    full, starts = link.stream_many(
        payloads(2, 15), [24, 54], gaps=[400], snr_db=30.0, cfo=1e-4,
        delay=0, seed=16, add_fcs=True, tail=FRAME_LEN)
    stream = full[40:]
    (got, gst, gc, gg), (want, wst, wc, wg) = both(stream)
    same_frames(got, want)
    assert (gst, gc, gg) == (wst, wc, wg)
    assert [f.start for f in got] == [0, int(starts[1]) - 40]
    assert got[1].result.ok and got[1].result.crc_ok


def test_deferred_overlap_plateau_is_not_overflow(stream8):
    # K preambles owned by chunk 0 and one more past its stride and the
    # 224-sample slack of the overflow cap: the next chunk's frame
    stream0, starts0, _want = stream8
    pre = stream0[int(starts0[0]): int(starts0[0]) + 320]
    rng = np.random.default_rng(16)
    stream = rng.normal(scale=0.01, size=(CHUNK + 2048, 2)) \
        .astype(np.float32)
    for i in range(K):
        stream[i * 360: i * 360 + 320] += pre
    stream[3400: 3720] += pre
    (got, gst, gc, gg), (want, wst, wc, wg) = both(stream)
    same_frames(got, want)
    assert (gst, gc, gg) == (wst, wc, wg)
    assert gst.overflow_chunks == 0
    assert any(f.start >= CHUNK - FRAME_LEN for f in got)


def test_all_noise_chunks_scan_once_and_never_decode():
    rng = np.random.default_rng(12)
    stream = rng.normal(scale=0.05, size=(2 * CHUNK, 2)).astype(np.float32)
    (got, gst, gc, gg), (want, wst, wc, wg) = both(stream)
    assert got == [] and want == []
    assert (gst, gc, gg) == (wst, wc, wg)
    assert gst.frames == 0 and gst.overflow_chunks == 0
    assert gc == {"rx.stream_chunk": gst.chunks}


def test_push_flush_across_slabs_equals_one_shot(stream8):
    stream, starts, want = stream8
    sr = framebatch.StreamReceiver(**GEO, device="cpu")
    got = []
    cuts = [0, 777, 3000, 4100, 9001, stream.shape[0]]
    for a, b in zip(cuts, cuts[1:]):
        got += sr.push(stream[a:b])
    assert sr.carry.offset + sr.carry.tail.shape[0] == stream.shape[0]
    got += sr.flush()
    assert sr.carry.emitted == len(got) == len(starts)
    same_frames(got, want)
    assert sr.flush() == []
    with pytest.raises(RuntimeError):
        sr.push(stream[:8])


def test_stream_bucket_graph_equals_host_rule():
    # the per-lane detector cap of a window of `cap` samples: the host
    # rule at every true count up to it, and the reference's ladder
    import jax.numpy as jnp

    for cap in (512, FRAME_LEN, 4 * FRAME_LEN):
        nv = torch.arange(0, cap + 1)
        got = rx._stream_bucket_graph(nv, cap).numpy()
        np.testing.assert_array_equal(
            got, [geometry.capture_bucket(int(v)) for v in nv])
        np.testing.assert_array_equal(got, np.asarray(
            jrx._stream_bucket_graph(jnp.asarray(nv.numpy()), cap)))
    assert [geometry.capture_bucket(n) for n in (0, 1, 512, 513, 4096)] == \
        [jrx._stream_bucket(n) for n in (0, 1, 512, 513, 4096)]


def test_locate_frames_equals_reference(stream8):
    stream, starts, _want = stream8
    rng = np.random.default_rng(17)
    offs = [0, 300, 1500, 2900, int(starts[4]) - 900]
    chunks = np.stack([stream[o: o + CHUNK] for o in offs])
    chunks[2] += rng.normal(scale=0.05, size=chunks[2].shape)
    lim = np.array([CHUNK, 3500, CHUNK, 2000, CHUNK - 1])
    ovf = np.array([3072 + 224, 800, CHUNK, 3072, 10_000])
    for k in (1, 3, K):
        f, s, o = sync.locate_frames(torch.from_numpy(chunks), k,
                                     limit=torch.from_numpy(lim),
                                     overflow_limit=torch.from_numpy(ovf))
        for b in range(len(offs)):
            wf, ws, wo = jsync.locate_frames(chunks[b], k, limit=lim[b],
                                             overflow_limit=ovf[b])
            np.testing.assert_array_equal(f[b].numpy(), np.asarray(wf))
            np.testing.assert_array_equal(s[b].numpy(), np.asarray(ws))
            assert bool(o[b]) == bool(wo)
    # K = 1 on a one-frame capture: the start locate_frame picks
    cap = stream[int(starts[0]) - 40: int(starts[0]) - 40 + FRAME_LEN]
    d1, s1, _e = sync.locate_frame(torch.from_numpy(cap)[None])
    fk, sk, ovf1 = sync.locate_frames(torch.from_numpy(cap)[None], 1)
    assert bool(d1[0]) and bool(fk[0, 0]) and not bool(ovf1[0])
    assert int(sk[0, 0]) == int(s1[0]) == 40
