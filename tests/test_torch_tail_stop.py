"""The two exactness facts behind the ACS and traceback kernels of
ziria_tpu_torch/csrc/viterbi.cu, on the CPU (torch and numpy only).

1. The ACS kernel stops a frame's sweep at the first renorm boundary
   (a multiple of 64) at which no later soft pair is live (-0.0 is an
   erasure; NaN and inf are live) and all 64 metrics are +0 bitwise
   (integer: 0), and writes zero decision words and +0 metrics from
   there on. A test-local emulation of that rule on ``acs_plain``
   equals ``acs_plain``'s full sweep bit for bit, in every metric type
   and radix.
2. The traceback kernel composes per-segment state maps and walks all-
   zero chunks in closed form. A test-local model of it equals
   ``traceback_plain``.

``acs_plain`` and ``traceback_plain`` equal the Pallas kernels in
interpret mode (tests/test_torch_viterbi.py), so both rules are chained
to the reference.
"""

import numpy as np
import pytest
import torch

from ziria_tpu_torch.ops import viterbi as tv, viterbi_cuda as vc

TP = 512                 # trellis steps of the emulated frames
EDGE = 256               # the renorm boundary the tails end around
MODES = [(md, r) for md in ("float32", "int16", "int8") for r in (2, 4)]
# lanes of _frames
ALL_ERASED, NO_TAIL, NEG_ZERO, SPECIAL = 17, 18, 19, 20


def _frames(md: str, seed: int = 0) -> torch.Tensor:
    """(21, TP, 2) soft pairs for metric `md`: lane i < 17 live up to
    step EDGE + i - 8 (tails ending 8 before to 8 after the boundary),
    one all-erasure lane, one with no tail, one whose tail is -0.0, and
    SPECIAL: for float32 an inf at step 100 before a tail at 300, for
    the integer metrics long +-qmax runs (the int8 lane reaches the
    -128 rail) before a tail at 400."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(21, TP, 2)) * 2.0).astype(np.float32)
    for i in range(17):
        x[i, EDGE + i - 8:] = 0.0
    x[ALL_ERASED] = 0.0
    x[NEG_ZERO, 300:] = -0.0
    if md == "float32":
        x[SPECIAL, 100, 0] = np.inf
        x[SPECIAL, 300:] = 0.0
        return torch.from_numpy(x)
    q = vc._quantize_for(md, torch.from_numpy(x))
    qmax = tv.QUANT_MAX if md == "int16" else tv.INT8_QUANT_MAX
    q[SPECIAL] = qmax
    q[SPECIAL, 100:250] = -qmax
    q[SPECIAL, 400:] = 0
    return q


def _plus_zero(m: torch.Tensor) -> torch.Tensor:
    bits = m.view(torch.int32) if m.dtype == torch.float32 else m
    return (bits == 0).all(dim=1)


def _stop_emulated(x: torch.Tensor, md: str, radix: int):
    """The ACS kernel's stop rule on acs_plain: (decisions, metrics,
    stop step per lane, metrics at every boundary). A lane stops at the
    first boundary b < Tp after its last live step where the plain
    sweep over steps [0, b) leaves all metrics +0; its decisions are
    that sweep's, zero words after b, and its metrics +0."""
    B, Tp = x.shape[0], x.shape[1]
    live = (x != 0).any(dim=2)
    last = torch.where(live.any(dim=1),
                       Tp - 1 - live.flip(1).to(torch.int8).argmax(dim=1),
                       torch.full((B,), -1))
    dec, met = vc.acs_plain(x, metric_dtype=md, radix=radix)
    stops = torch.full((B,), Tp)
    seen = []
    for b in range(vc.RENORM, Tp, vc.RENORM):
        d_b, m_b = vc.acs_plain(x[:, :b], metric_dtype=md, radix=radix)
        seen.append(m_b)
        stop = (stops == Tp) & (last < b) & _plus_zero(m_b)
        dec[stop] = 0
        dec[stop, :b] = d_b[stop]
        met[stop] = 0
        stops[stop] = b
    return dec, met, stops, seen


@pytest.mark.parametrize("md,radix", MODES)
def test_stop_rule_equals_full_sweep(md, radix):
    x = _frames(md)
    dec, met, stops, seen = _stop_emulated(x, md, radix)
    dec_f, met_f = vc.acs_plain(x, metric_dtype=md, radix=radix)
    assert torch.equal(dec, dec_f)
    assert torch.equal(met.view(torch.int32), met_f.view(torch.int32))
    # the rule does stop the tails early, at the first boundary at least
    # 6 erasures after the last live step, and not where it must not
    for i in range(17):
        last = EDGE + i - 9
        assert stops[i] == -(-(last + 7) // vc.RENORM) * vc.RENORM, i
    assert stops[ALL_ERASED] == vc.RENORM
    assert stops[NO_TAIL] == TP
    assert stops[NEG_ZERO] == 320
    if md == "float32":
        assert stops[SPECIAL] == TP             # inf: NaN metrics
        assert torch.isnan(met_f[SPECIAL]).all()
    else:
        assert stops[SPECIAL] == 448
    if md == "int8":
        assert any((m[SPECIAL] == tv.I8_MIN).any() for m in seen)


def test_quantizer_keeps_erasures_zero():
    x = (np.random.default_rng(1).normal(size=(4, 256, 2)) * 3.0)
    x = x.astype(np.float32)
    x[0, 100:] = 0.0
    x[1, 50:] = -0.0
    x[2] = 0.0
    for qmax in (tv.QUANT_MAX, tv.INT8_QUANT_MAX):
        q, _scale = tv.quantize_llrs(torch.from_numpy(x), qmax)
        assert not q[0, 100:].any() and not q[1, 50:].any()
        assert not q[2].any()


def _zero_walk(s: int, n: int) -> int:
    """Where state s arrives after n steps back over all-zero words (the
    kernel's tb_zero)."""
    return 0 if n >= 6 else (s << n) & 63


def _back(s, w):
    """One step back over decision word w (np.uint64) from the states s
    (int64 array)."""
    bit = (np.uint64(w) >> s.astype(np.uint64)) & np.uint64(1)
    return ((s & 31) << 1) | bit.astype(np.int64)


def _traceback_segmented(dec, metrics, seg_len: int, chunk: int):
    """Model of traceback_kernel: per segment of `seg_len` steps (walked
    `chunk` words at a time from its end; an all-zero chunk in closed
    form) the map end state -> state before the segment for all 64 end
    states; the maps composed backward from the first argmax; then each
    segment walked again from its end state."""
    B, Tp = dec.shape[0], dec.shape[1]
    words = np.ascontiguousarray(dec.numpy()).view("<u8").reshape(B, Tp)
    bits = np.zeros((B, Tp), np.uint8)
    nseg = -(-Tp // seg_len)
    nchunk = seg_len // chunk

    def chunks(f, g):
        for c in reversed(range(nchunk)):
            a = g * seg_len + c * chunk
            n = max(min(Tp - a, chunk), 0)
            yield a, n, words[f, a:a + n]

    for f in range(B):
        maps, live = np.zeros((nseg, 64), np.int64), np.zeros(nseg, bool)
        for g in range(nseg):
            e = np.arange(64)
            for _a, n, w in chunks(f, g):
                if w.any():
                    live[g] = True
                    for t in reversed(range(n)):
                        e = _back(e, w[t])
                else:
                    e = np.array([_zero_walk(s, n) for s in e])
            maps[g] = e
        s = int(np.argmax(metrics[f].numpy()))         # first max
        ends = np.zeros(nseg, np.int64)
        for g in reversed(range(nseg)):
            ends[g] = s
            s = (int(maps[g, s]) if live[g]
                 else _zero_walk(s, min(seg_len, Tp - g * seg_len)))
        for g in range(nseg):
            s = int(ends[g])
            for a, n, w in chunks(f, g):
                if not w.any():
                    for k in range(n):
                        back = n - 1 - k
                        bits[f, a + k] = (s >> (5 - back)) & 1 if back < 6 \
                            else 0
                    s = _zero_walk(s, n)
                    continue
                for t in reversed(range(n)):
                    bits[f, a + t] = s >> 5
                    s = int(_back(np.array([s]), w[t])[0])
    return torch.from_numpy(bits)


def _decisions(kind: str):
    """(decisions, metrics): from the plain ACS over tailed frames
    (float32 or int16 metrics, Tp = 448: whole all-zero segments), or
    random words over Tp = 300 (not a multiple of 64) with a zero run
    and zero tails, and random float32 metrics whose argmax is an odd
    state where a zero tail ends the frame."""
    if kind != "random":
        x = _frames(kind, seed=3)[:, :448]
        x = x[[0, 9, 16, ALL_ERASED, NO_TAIL, NEG_ZERO]]
        return vc.acs_plain(x, metric_dtype=kind)
    rng = np.random.default_rng(4)
    w = rng.integers(0, 2 ** 63, size=(4, 300), dtype=np.int64)
    w[:, 64:128] = 0
    w[1, 200:] = 0
    w[2, 296:] = 0
    w[3, 256:] = 0
    met = rng.normal(size=(4, 64)).astype(np.float32)
    met[[1, 2, 3], [37, 63, 45]] = 9.0
    dec = torch.from_numpy(w.view(np.uint8).reshape(4, 300, 8).copy())
    return dec, torch.from_numpy(met)


@pytest.mark.parametrize("seg_len,chunk", [(256, 256), (64, 64), (96, 32),
                                           (100, 100), (74, 74), (512, 256)])
@pytest.mark.parametrize("kind", ["float32", "int16", "random"])
def test_segmented_traceback_equals_plain(kind, seg_len, chunk):
    dec, met = _decisions(kind)
    want = vc.traceback_plain(dec, met)
    assert torch.equal(_traceback_segmented(dec, met, seg_len, chunk), want)


def test_zero_chunk_closed_form():
    # n steps back over all-zero words, from every state: the state
    # reached and the bits emitted, against the plain walk
    for n in range(12):
        for s0 in range(64):
            s, bits = s0, []
            for _ in range(n):
                bits.append(s >> 5)
                s = (s & 31) << 1
            assert s == _zero_walk(s0, n)
            closed = [(s0 >> (5 - back)) & 1 if back < 6 else 0
                      for back in range(n)]
            assert bits == closed
