"""State, configuration and containment of the port's streaming receiver
against the JAX package's, on the CPU: checkpoints written by one
package restored in the other, torn and mismatched blobs, the
``Geometry`` object, sanitize-and-quarantine, an injected transient
fault, and ``receive_many_device``. Frames, stats and counters compare
exactly (test_torch_stream.py's geometry and 8-rate stream).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_receive import _same_results, corpus  # noqa: F401
from test_torch_stream import FRAME_LEN, GEO, RATES, payloads, same_frames
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.phy import link
from ziria_tpu.phy.wifi import rx as jrx
from ziria_tpu.runtime import resilience as jres
from ziria_tpu.utils import faults as jfaults, geometry as jgeo, \
    telemetry as jtm
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.phy.wifi import rx
from ziria_tpu_torch.runtime import resilience
from ziria_tpu_torch.utils import faults, geometry, telemetry
from ziria_tpu_torch.utils.dispatch import pad_lanes

CUTS = [0, 777, 3000, 4100, 9001]


@pytest.fixture(scope="module")
def stream8():
    """The 8-rate stream, its reference frames through one receiver
    pushed in slabs, and the reference checkpoint after the first three
    slabs (with the frames drained into it)."""
    stream, starts = link.stream_many(
        payloads(8, 20260804), RATES, snr_db=30.0, cfo=1e-4, delay=60,
        seed=5, add_fcs=True, tail=FRAME_LEN)
    slabs = [stream[a:b] for a, b in
             zip(CUTS, CUTS[1:] + [stream.shape[0]])]
    sr = jfb.StreamReceiver(**GEO)
    head = [f for s in slabs[:3] for f in sr.push(s)]
    blob, drained = sr.checkpoint()
    rest = [f for s in slabs[3:] for f in sr.push(s)] + sr.flush()
    return slabs, head + drained + rest, blob


def _port(**kw):
    return framebatch.StreamReceiver(**GEO, device="cpu", **kw)


def _run(sr, slabs):
    return [f for s in slabs for f in sr.push(s)] + sr.flush()


def test_checkpoints_restore_across_packages(stream8):
    slabs, want, jblob = stream8
    # the reference's checkpoint resumes in the port
    got = _run(_port(checkpoint=jblob), slabs[3:])
    same_frames(want[len(want) - len(got):], got)
    # and the port's in the reference
    sr = _port()
    head = [f for s in slabs[:3] for f in sr.push(s)]
    blob, drained = sr.checkpoint()
    assert resilience.restore_carry(blob).geometry == \
        jres.restore_carry(jblob).geometry
    rest = _run(jfb.StreamReceiver(**GEO, checkpoint=blob), slabs[3:])
    same_frames(head + drained + _run(_port(checkpoint=blob), slabs[3:]),
                want)
    same_frames(head + drained + rest, want)


def test_torn_and_mismatched_checkpoints_raise(stream8):
    _slabs, _want, jblob = stream8
    st = resilience.restore_carry(jblob)
    torn = [jblob[: len(jblob) // 2], b"", b"not a checkpoint"]
    flipped = bytearray(jblob)
    flipped[len(flipped) // 3] ^= 0xFF
    for bad in torn + [bytes(flipped)]:
        with pytest.raises(resilience.CarryCheckpointError):
            _port(checkpoint=bad)
    with pytest.raises(resilience.CarryCheckpointError, match="mismatch"):
        _port(checkpoint=jblob, dead_zone=300)
    with pytest.raises(resilience.CarryCheckpointError, match="lacks"):
        _port(checkpoint=resilience.checkpoint_carry(
            framebatch.StreamCarry(st.tail, st.offset, st.emitted)))
    # a blob from before the sco_track and fused_demap keys restores
    legacy = {k: v for k, v in st.geometry.items()
              if k not in ("sco_track", "fused_demap")}
    blob = resilience.checkpoint_carry(st, seen=st.seen, geometry=legacy)
    assert _port(checkpoint=blob).carry.offset == st.offset


def test_geometry_equals_reference(corpus, monkeypatch):  # noqa: F811
    g = geometry.Geometry(chunk_len=4096, viterbi_metric="int16",
                          sco_track=True)
    jg = jgeo.Geometry(**g.as_dict())
    assert geometry.DEFAULT.as_dict() == jgeo.DEFAULT.as_dict()
    assert geometry.Geometry.from_json(g.to_json()) == g
    assert g.to_json() == jg.to_json()
    assert g.replace(min_run=20).min_run == 20
    with pytest.raises(ValueError):
        geometry.Geometry.from_dict({"chunk_len": 1, "bogus": 2})
    monkeypatch.setenv("ZIRIA_VITERBI_RADIX", "4")
    assert dataclasses.asdict(g.resolve()) == \
        dataclasses.asdict(jg.resolve())
    monkeypatch.delenv("ZIRIA_VITERBI_RADIX")
    for n in (3, 40, 513):
        assert (g.sym_bucket(n), g.capture_bucket(n), g.bit_bucket(n)) == \
            (jg.sym_bucket(n), jg.capture_bucket(n), jg.bit_bucket(n))
    for i in (0, 4, 10):
        got = rx.receive(corpus[i], check_fcs=True, geometry=g,
                         device="cpu")
        want = jrx.receive(corpus[i], check_fcs=True, geometry=jg)
        _same_results([got], [want])


def _counters(reg) -> dict:
    if isinstance(reg, telemetry.MetricsRegistry):
        return reg.counters()
    return {k: v for k, v in reg.snapshot().items()
            if "{" not in k and isinstance(v, int)}


def _contained(pkg, slabs, spec=None, **kw):
    """Frames, stats and counters of one package's receiver over the
    slabs, under a fault plan of `spec` (a FaultSpec's fields)."""
    fb, tm, fl = pkg
    extra = {"device": "cpu"} if fb is framebatch else {}
    with tm.collect() as reg, fl.inject(*([fl.FaultSpec(**spec)]
                                           if spec else [])) as plan:
        sr = fb.StreamReceiver(**GEO, **kw, **extra)
        frames = _run(sr, slabs)
    return frames, sr.stats, _counters(reg), list(plan.fired)


PORT = (framebatch, telemetry, faults)
REF = (jfb, jtm, jfaults)


def test_sanitize_quarantine_equals_reference(stream8):
    slabs, _want, _blob = stream8
    slabs = [s.copy() for s in slabs]
    slabs[2][100:110, 0] = np.nan
    slabs[4][7] = np.inf
    got, gst, gc, _gf = _contained(PORT, slabs, sanitize=True)
    want, wst, wc, _wf = _contained(REF, slabs, sanitize=True)
    same_frames(got, want)
    assert (gst, gc) == (wst, wc)
    assert gst.sanitized == 11 and gst.quarantines >= 1
    assert gc["resilience.quarantines"] == gst.quarantines
    with pytest.raises(ValueError, match="non-finite"):
        _port().push(slabs[2])


def test_injected_transient_decode_fault_equals_reference(stream8):
    slabs, want, _blob = stream8
    spec = dict(site="rx.stream_decode", kind="transient", calls=(1,))
    got, gst, gc, gf = _contained(PORT, slabs, spec)
    ref, wst, wc, wf = _contained(REF, slabs, spec)
    same_frames(got, ref)
    same_frames(got, want)
    assert (gst, gc, gf) == (wst, wc, wf)
    assert gf == [("rx.stream_decode", "transient", 1)]
    assert gc["resilience.retries"] == gc["resilience.recovered"] == 1
    assert not gst.degraded
    # the channel kind corrupts a pushed slab as the reference's does
    slab = np.asarray(slabs[0], np.float32)
    corrupted = []
    for fm in (faults, jfaults):
        for prof in ("hostile", "severe", "bursty"):
            with fm.inject(fm.FaultSpec("rx.push", "channel", calls=(1,),
                                        profile=prof), seed=4) as p:
                first, kinds0 = fm.corrupt_slab("rx.push", slab)
                arr, kinds = fm.corrupt_slab("rx.push", slab)
            assert first is slab and kinds0 == ()
            assert kinds == ("channel",) and p.fired == [
                ("rx.push", "channel", 1)]
            corrupted.append(arr)
    for a, b in zip(corrupted[:3], corrupted[3:]):
        assert a.dtype == np.float32 and np.array_equal(a, b)
        assert not np.array_equal(a, slab)


def test_receive_many_device_equals_reference(corpus):  # noqa: F811
    padded = pad_lanes(corpus)
    bucket = geometry.capture_bucket(max(c.shape[0] for c in corpus))
    x = np.zeros((len(padded), bucket, 2), np.float32)
    for i, c in enumerate(padded):
        x[i, :c.shape[0]] = c
    got = framebatch.receive_many_device(x, len(corpus), check_fcs=True,
                                         device="cpu")
    want = jfb.receive_many_device(jnp.asarray(x), len(corpus),
                                   check_fcs=True)
    _same_results(got, want)
    _same_results(got, framebatch.receive_many(
        list(x[:len(corpus)]), check_fcs=True, device="cpu"))
    assert sum(g.ok and g.crc_ok for g in got) == len(RATES)
    with pytest.raises(ValueError, match="bucket"):
        framebatch.receive_many_device(x[:, :1000], 2, device="cpu")
