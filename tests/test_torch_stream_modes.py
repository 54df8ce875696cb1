"""The port's streaming receiver in the decode modes off the default,
and on its degraded twins, against the JAX package's stream, on the
CPU, at test_torch_stream.py's geometry and 8-rate stream: int8
metrics at radix 4 (the reference runs its Pallas kernels in interpret
mode, the port its kernels' plain versions) and ``fused_demap`` (the
rate-switched fused kernel, also in interpret mode there); then a fatal
fault injected at the decode (the rest of the stream decodes through
per-capture ``rx.receive``) and at the chunk scan (the scan runs
unguarded). Frames, stats and counters compare exactly. On the card
only an injected fault degrades the receiver: a real failure of the
decode, the scan, a chunk's read or a per-capture window raises.
"""

import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_stream import FRAME_LEN, GEO, RATES, payloads, same_frames
from test_torch_stream_state import PORT, REF, _contained, _run
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.phy import link
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.utils import faults, telemetry

CARD_FAULT = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(scope="module")
def stream8():
    stream, _starts = link.stream_many(
        payloads(8, 20260804), RATES, snr_db=30.0, cfo=1e-4, delay=60,
        seed=5, add_fcs=True, tail=FRAME_LEN)
    return stream


@pytest.mark.parametrize("knobs", [
    {"viterbi_metric": "int8", "viterbi_radix": 4}, {"fused_demap": True}],
    ids=["int8_radix4", "fused_demap"])
def test_stream_mode_equals_reference(stream8, knobs):
    got, gst = framebatch.receive_stream(stream8, **GEO, device="cpu",
                                         **knobs)
    want, wst = jfb.receive_stream(stream8, **GEO, **knobs)
    same_frames(got, want)
    assert gst == wst
    assert len(got) == len(RATES)
    assert all(f.result.ok and f.result.crc_ok for f in got)


@pytest.mark.parametrize("site", ["rx.stream_decode", "rx.stream_chunk"])
def test_degraded_twin_equals_reference(stream8, site):
    slabs = [stream8[a:a + 3000] for a in range(0, stream8.shape[0], 3000)]
    spec = dict(site=site, kind="fatal", calls=(1,))
    got, gst, gc, gf = _contained(PORT, slabs, spec)
    want, wst, wc, wf = _contained(REF, slabs, spec)
    same_frames(got, want)
    assert (gst, gc, gf) == (wst, wc, wf)
    assert gst.degraded and gc["resilience.degraded"] == 1
    assert gc["resilience.fatal"] == 1 and len(got) == len(RATES)
    assert all(f.result.ok and f.result.crc_ok for f in got)
    # the same injected plan degrades a receiver that holds itself to
    # the card's rule the same way
    with faults.inject(faults.FaultSpec(**spec)):
        sr = framebatch.StreamReceiver(**GEO, device="cpu")
        sr._strict = True
        same_frames(_run(sr, slabs), got)
    assert sr.stats == gst
    sr = framebatch.StreamReceiver(**GEO, device="cpu")
    sr._mark_degraded(scan=site == "rx.stream_chunk")
    assert sr.stats.degraded
    sr.reset_degraded()
    assert not sr.stats.degraded


@pytest.mark.parametrize("site", ["decode", "scan", "read", "window"])
def test_card_fault_raises(stream8, monkeypatch, site):
    # a receiver held to the card's rule (as on a CUDA device): a real
    # failure propagates, and nothing degrades or is counted as contained
    def boom(*_a, **_k):
        raise RuntimeError(CARD_FAULT)

    sr = framebatch.StreamReceiver(**GEO, device="cpu",
                                   streaming=site != "window",
                                   sanitize=site == "window")
    sr._strict = True
    if site == "decode":
        monkeypatch.setattr(sr, "_decode", boom)
    elif site == "scan":
        monkeypatch.setattr(sr, "_scan", boom)
    elif site == "read":
        monkeypatch.setattr(framebatch, "_pull_chunk", boom)
    else:
        monkeypatch.setattr(framebatch._rx, "receive", boom)
    with telemetry.collect() as reg, \
            pytest.raises(RuntimeError, match="illegal memory access"):
        sr.push(stream8)
        sr.flush()
    st = sr.stats
    assert not st.degraded and st.lane_blowups == 0
    assert not [k for k in reg.counters() if k.startswith("resilience.")
                and k != "resilience.fatal"]
