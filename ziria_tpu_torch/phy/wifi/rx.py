"""802.11a/g OFDM receiver chain (counterpart of
ziria_tpu/phy/wifi/rx.py): the batched receive path and the
per-capture ``receive``.

Packet detect (STS autocorrelation), CFO estimate and correction,
channel estimate (LTS), SIGNAL decode; then, for the DATA field, FFT,
equalize, pilot tracking, soft demap, deinterleave, depuncture,
Viterbi, descramble and CRC. Every function runs a batch of frames
with the batch axis first, where the reference ran one frame under
``vmap`` (the per-capture ``receive`` and ``decode_data_bucketed`` take
one frame, as the reference's do); the host does only the integer
header parsing between the acquire, gather and decode steps, as in the
reference.

With ``fused_demap`` the demap, deinterleave and depuncture run inside
the decode kernel (ops/viterbi_fused) on the output of one
rate-independent :func:`_front_symbols`. The decode-mode knobs
``viterbi_window``, ``viterbi_metric`` and ``viterbi_radix`` choose the
Viterbi as the reference's do (ops/viterbi_cuda); a ``viterbi_radix``
of None reads ZIRIA_VITERBI_RADIX, a window or metric of None means
the default (off, float32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, cplx, demap as demap_mod, \
    interleave, ofdm, scramble, sync, viterbi, viterbi_cuda, viterbi_fused
from ziria_tpu_torch.ops.crc import check_crc32, check_crc32_masked
from ziria_tpu_torch.phy.wifi.params import (MAX_DBPS, N_SERVICE_BITS,
                                             N_TAIL_BITS,
                                             RATE_MBPS_ORDER, RATES,
                                             SIGNAL_BITS_TO_MBPS,
                                             RateParams, n_symbols)
from ziria_tpu_torch.utils import dispatch, geometry, programs, telemetry
from ziria_tpu_torch.utils.bits import bits_to_uint
from ziria_tpu_torch.utils.dispatch import pow2_ceil

FRAME_DATA_START = 400  # 320 preamble + 80 SIGNAL

#: bounded-|H| guard: a used subcarrier whose |H|^2 is below this
#: fraction of the mean used-bin gain is nulled (its symbols, demap
#: gain and pilot contribution become exact zeros)
H_GUARD_REL = 1e-3


class RxResult(NamedTuple):
    ok: bool
    rate_mbps: int
    length_bytes: int
    psdu_bits: np.ndarray
    crc_ok: Optional[bool]


def equalize(bins, H):
    """Zero-forcing equalization of (B, n_sym, 64, 2) bins by each
    lane's H (B, 64, 2)."""
    return cplx.cdiv(bins, H[:, None].expand_as(bins))


def guard_subcarriers(data, pilots, H):
    """The bounded-|H| null-subcarrier guard over data (B, n_sym, 48, 2)
    and pilots (B, n_sym, 4, 2) with channel estimates H (B, 64, 2).
    Returns (data, pilots, gain (B, 48)), zeroed at nulled bins."""
    dev = H.device
    g = cplx.cabs2(H)                                          # (B, 64)
    gd = g[:, torch.from_numpy(ofdm.DATA_BINS).to(dev)]        # (B, 48)
    gp = g[:, torch.from_numpy(ofdm.PILOT_BINS).to(dev)]       # (B, 4)
    floor = H_GUARD_REL * torch.cat([gd, gp], dim=1).mean(dim=1)
    null_d = gd < floor[:, None]
    null_p = gp < floor[:, None]
    data = torch.where(null_d[:, None, :, None], 0.0, data)
    pilots = torch.where(null_p[:, None, :, None], 0.0, pilots)
    gain = torch.where(null_d, 0.0, gd)
    return data, pilots, gain


def sco_track_enabled(sco_track=None) -> bool:
    """The ``sco_track`` knob: the explicit value, else the
    ZIRIA_RX_SCO_TRACK environment variable (default off)."""
    if sco_track is not None:
        return bool(sco_track)
    return geometry.env_sco_track()


def fused_demap_enabled(fused_demap=None) -> bool:
    """The ``fused_demap`` knob: the explicit value, else the
    ZIRIA_FUSED_DEMAP environment variable (default off)."""
    if fused_demap is not None:
        return bool(fused_demap)
    return geometry.env_fused_demap()


def pilot_phase_correct(data, pilots, symbol_index0: int,
                        sco_track: bool = False):
    """Common-phase derotation of each symbol from its 4 pilots: data
    (B, n_sym, 48, 2), pilots (B, n_sym, 4, 2), pilot polarity index
    starting at symbol_index0.

    ``sco_track`` also removes the per-subcarrier phase ramp that a
    sampling-clock offset leaves: a least-squares slope through the
    origin over the pilot subcarriers (-21, -7, 7, 21), weighted by
    pilot energy, per symbol."""
    expect = ofdm.pilot_values(data.shape[-3], symbol_index0, data.device)
    weighted = pilots * expect[..., None]
    ph = torch.atan2(weighted[..., 1].sum(-1), weighted[..., 0].sum(-1))
    derot = cplx.cexp(-ph)                                  # (B, n_sym, 2)
    data = cplx.cmul(data, derot[..., None, :])
    if not sco_track:
        return data
    dev = data.device
    w = cplx.cmul(weighted, derot[..., None, :])            # common phase out
    res = torch.atan2(w[..., 1], w[..., 0])                 # (B, n_sym, 4)
    k_p = torch.from_numpy(ofdm.PILOT_SC.astype(np.float32)).to(dev)
    e = cplx.cabs2(w)
    num = (e * k_p * res).sum(-1)
    den = (e * k_p * k_p).sum(-1)
    slope = num / torch.clamp(den, min=1e-12)               # rad/subcarrier
    k_d = torch.from_numpy(ofdm.DATA_SC.astype(np.float32)).to(dev)
    ramp = cplx.cexp(-slope[..., None] * k_d)               # (B, n_sym, 48, 2)
    return cplx.cmul(data, ramp)


def decode_signal(frame):
    """Decode the SIGNAL symbol of aligned, CFO-corrected frames
    (B, >=400, 2). Returns (rate_bits (B,), length (B,), parity_ok
    (B,)) as int64, int64 and bool tensors."""
    H = sync.estimate_channel(frame)
    bins = ofdm.ofdm_demodulate(frame[:, 320:400][:, None])  # (B, 1, 64, 2)
    eq = equalize(bins, H)
    data, pilots = ofdm.extract_subcarriers(eq)
    data, pilots, gain = guard_subcarriers(data, pilots, H)
    data = pilot_phase_correct(data, pilots, symbol_index0=0)
    llr = demap_mod.demap(data, 1, gain=gain[:, None])[:, 0]   # (B, 48)
    deint = interleave.deinterleave(llr, 48, 1)
    with telemetry.span("rx.signal_scan"):
        bits = viterbi.viterbi_decode(deint, n_bits=24)
    rate_bits = bits_to_uint(bits[:, 0:4], msb_first=True)
    length = bits_to_uint(bits[:, 5:17])
    parity_ok = bits[:, :18].to(torch.int64).sum(-1) % 2 == 0
    return rate_bits, length, parity_ok


def _front_symbols(frame, n_sym: int, sco_track: bool = False):
    """Aligned frames (B, >=400+80*n_sym, 2) -> (data (B, n_sym, 48, 2),
    gain (B, 48)): channel estimate, (n_sym x 64) matmul FFT, equalize,
    bounded-|H| guard, pilot tracking. The fused decodes take these
    straight into their kernels."""
    H = sync.estimate_channel(frame)
    syms = frame[:, FRAME_DATA_START: FRAME_DATA_START + 80 * n_sym]
    bins = ofdm.ofdm_demodulate(syms.reshape(frame.shape[0], n_sym, 80, 2))
    eq = equalize(bins, H)
    data, pilots = ofdm.extract_subcarriers(eq)
    data, pilots, gain = guard_subcarriers(data, pilots, H)
    return pilot_phase_correct(data, pilots, symbol_index0=1,
                               sco_track=sco_track), gain


def _decode_front(frame, rate: RateParams, n_sym: int,
                  sco_track: bool = False):
    """Aligned frames -> depunctured soft pairs (B, n_sym*n_dbps, 2):
    everything before the Viterbi, at one known rate."""
    data, gain = _front_symbols(frame, n_sym, sco_track)
    llrs = demap_mod.demap(data, rate.n_bpsc,
                           gain=gain[:, None, :].expand(data.shape[:-1]))
    deint = interleave.deinterleave(llrs.reshape(frame.shape[0], -1),
                                    rate.n_cbps, rate.n_bpsc)
    dep = coding.depuncture(deint, rate.coding, fill=0.0)
    return dep.reshape(frame.shape[0], -1, 2)


def _fused_front_applies(viterbi_window, viterbi_metric) -> bool:
    """Where the fused front composes: full-frame decodes at float32
    metrics (the reference's windowed and quantized modes keep the
    unfused front)."""
    return not viterbi_window and (viterbi_metric or "float32") == "float32"


def _decode_back(bits, n_psdu_bits: int):
    """Decoded bits (B, n) -> (psdu bits (B, n_psdu_bits), descrambled
    service bits (B, 16))."""
    clear = scramble.descramble_bits(bits, scramble.recover_seed(bits[:, :7]))
    return (clear[:, N_SERVICE_BITS: N_SERVICE_BITS + n_psdu_bits],
            clear[:, :N_SERVICE_BITS])


def decode_data_batch(frames, rate: RateParams, n_sym: int,
                      n_psdu_bits: int, viterbi_window: int = None,
                      viterbi_metric: str = None, viterbi_radix: int = None,
                      fused_demap: bool = None, sco_track: bool = False):
    """Batched DATA decode at one known rate: aligned, CFO-corrected
    frames (B, >=400+80*n_sym, 2) -> (psdu bits (B, n_psdu_bits),
    service bits (B, 16)). Unfused: the front at that rate, then the
    batch decode of the (window, metric, radix) mode
    (``viterbi_cuda.viterbi_decode_batch_opt``); fused (float32 metrics
    and no window): :func:`_front_symbols`, then the known-rate fused
    kernel (ops/viterbi_fused) and the traceback."""
    T = n_sym * rate.n_dbps
    if fused_demap_enabled(fused_demap) \
            and _fused_front_applies(viterbi_window, viterbi_metric):
        data, gain = _front_symbols(frames, n_sym, sco_track)
        bits = viterbi_fused.viterbi_decode_batch_fused(
            data, gain, rate, n_bits=T, radix=viterbi_radix)
    else:
        dep = _decode_front(frames, rate, n_sym, sco_track)
        bits = viterbi_cuda.viterbi_decode_batch_opt(
            dep, n_bits=T, window=viterbi_window,
            metric_dtype=viterbi_metric, radix=viterbi_radix)
    return _decode_back(bits, n_psdu_bits)


def decode_data_bucketed(frame, rate: RateParams, n_sym_bucket: int,
                         n_bits_real: int, viterbi_window: int = None,
                         viterbi_metric: str = None,
                         viterbi_radix: int = None,
                         fused_demap: bool = None,
                         sco_track: bool = False, fxp: bool = False):
    """DATA decode of ONE frame (FRAME_DATA_START + 80*n_sym_bucket, 2)
    padded to a symbol bucket, with n_bits_real true data bits ->
    (n_sym_bucket * n_dbps,) descrambled bits; steps at or past
    n_bits_real are erasures. Fused (float32 metrics, no window): the
    known-rate fused kernel over one lane; otherwise the front at
    `rate` and the Viterbi of the mode (:func:`_decode_data_bits_unfused`).
    ``fxp``: `frame` is Q11-quantized and the integer interior decodes
    it (rx_fxp.decode_data_bucketed_fxp, the scan decoder); every other
    knob is ignored, as in the reference."""
    if fxp:
        from ziria_tpu_torch.phy.wifi import rx_fxp
        return rx_fxp.decode_data_bucketed_fxp(frame, rate, n_sym_bucket,
                                               n_bits_real)
    if fused_demap_enabled(fused_demap) \
            and _fused_front_applies(viterbi_window, viterbi_metric):
        data, gain = _front_symbols(frame[None], n_sym_bucket, sco_track)
        bits = viterbi_fused.viterbi_decode_batch_fused(
            data, gain, rate, n_bits=n_sym_bucket * rate.n_dbps,
            nbits_real=[int(n_bits_real)], radix=viterbi_radix)
    else:
        bits = _decode_data_bits_unfused(
            frame, rate, n_sym_bucket, n_bits_real, viterbi_window,
            viterbi_metric, viterbi_radix, sco_track)[None]
    return scramble.descramble_bits(
        bits, scramble.recover_seed(bits[:, :7]))[0]


def _decode_data_bits_unfused(frame, rate: RateParams, n_sym_bucket: int,
                              n_bits_real: int, viterbi_window=None,
                              viterbi_metric=None, viterbi_radix=None,
                              sco_track: bool = False):
    """The unfused body of :func:`decode_data_bucketed`: the front at
    `rate`, the erasure mask at n_bits_real, then the reference's
    three-way choice of Viterbi: with a window, the windowed decode of
    the one frame; at radix 4 or int8 metrics, the kernel batch decode
    as a one-lane batch; otherwise the scan decoder, float32 or int16
    (ops/viterbi, the reference's ``lax.scan`` decoders: no kernel).
    Raw decoded bits (n_sym_bucket * n_dbps,)."""
    dep = _decode_front(frame[None], rate, n_sym_bucket, sco_track)
    t = torch.arange(dep.shape[1], device=dep.device)
    dep = torch.where((t < n_bits_real)[None, :, None], dep, 0.0)
    n_bits = n_sym_bucket * rate.n_dbps
    if viterbi_window:
        bits = viterbi_cuda.viterbi_decode_batch_windowed(
            dep, n_bits=n_bits, window=viterbi_window,
            metric_dtype=viterbi_metric, radix=viterbi_radix)
    elif (viterbi._check_radix(viterbi_radix) != 2
          or (viterbi_metric or "float32") == "int8"):
        bits = viterbi_cuda.viterbi_decode_batch(
            dep, n_bits=n_bits, metric_dtype=viterbi_metric,
            radix=viterbi_radix)
    else:
        bits = viterbi.viterbi_decode(dep, n_bits=n_bits,
                                      metric_dtype=viterbi_metric)
    return bits[0]


def mixed_front(frames, rate_idx: Sequence[int], n_bits_real,
                n_sym_bucket: int, sco_track: bool = False):
    """The rate-switched front of the mixed decode: each lane's
    depunctured soft pairs at its own rate, zero-padded to the
    bucket's maximal trellis (n_sym_bucket * MAX_DBPS, 2), with every
    step at or past its true bit count an erasure.

    rate_idx: (B,) HOST ints indexing RATE_MBPS_ORDER. The reference
    evaluates a ``lax.switch`` under ``vmap`` (a select over all 8
    rates' fronts); here the lanes of each rate run that rate's front
    together, which selects the same values.
    n_bits_real: (B,) true data-bit counts (tensor or ints)."""
    B = frames.shape[0]
    dev = frames.device
    t_max = n_sym_bucket * MAX_DBPS
    ridx = np.asarray(rate_idx, np.int64)
    dep = torch.zeros((B, t_max, 2), dtype=torch.float32, device=dev)
    for r in np.unique(ridx):
        lanes = torch.from_numpy(np.flatnonzero(ridx == r)).to(dev)
        part = _decode_front(frames[lanes], RATES[RATE_MBPS_ORDER[r]],
                             n_sym_bucket, sco_track)
        dep[lanes, :part.shape[1]] = part
    nb = torch.as_tensor(n_bits_real, dtype=torch.int64, device=dev)
    t = torch.arange(t_max, device=dev)
    return torch.where((t[None, :] < nb[:, None])[..., None], dep, 0.0)


def decode_data_mixed(frames, rate_idx: Sequence[int], n_bits_real,
                      n_sym_bucket: int, viterbi_window: int = None,
                      viterbi_metric: str = None, viterbi_radix: int = None,
                      sco_track: bool = False, fused_demap: bool = None):
    """Mixed-rate batched DATA decode: frames (B, FRAME_DATA_START +
    80*n_sym_bucket, 2) aligned and CFO-corrected, rate_idx (B,) host
    ints, n_bits_real (B,) true data-bit counts. Returns (B,
    n_sym_bucket * MAX_DBPS) uint8 descrambled bit streams.

    Unfused, each lane's front runs at its own rate
    (:func:`mixed_front`) and the one rate-agnostic Viterbi of the
    (window, metric, radix) mode runs over the whole batch through the
    ACS and traceback kernels (``viterbi_cuda.viterbi_decode_batch_opt``).
    Fused (float32 metrics, no window), one rate-independent
    :func:`_front_symbols` feeds the rate-switched fused kernel
    (ops/viterbi_fused), which demaps, deinterleaves and depunctures
    each lane at its own rate inside the ACS."""
    if fused_demap_enabled(fused_demap) \
            and _fused_front_applies(viterbi_window, viterbi_metric):
        data, gain = _front_symbols(frames, n_sym_bucket, sco_track)
        bits = viterbi_fused.viterbi_decode_mixed_fused(
            data, gain, rate_idx, n_bits_real, radix=viterbi_radix)
    else:
        dep = mixed_front(frames, rate_idx, n_bits_real, n_sym_bucket,
                          sco_track)
        bits = viterbi_cuda.viterbi_decode_batch_opt(
            dep, window=viterbi_window, metric_dtype=viterbi_metric,
            radix=viterbi_radix)
    return scramble.descramble_bits(bits, scramble.recover_seed(bits[:, :7]))


def crc_psdu_many_graph(clear_b, n_psdu_bits):
    """Batched FCS check over the mixed decode's output (B, n) with
    true PSDU bit counts (B,): True iff a lane's PSDU ends in the
    CRC-32 of the rest."""
    return check_crc32_masked(clear_b[:, N_SERVICE_BITS:], n_psdu_bits)


# ------------------------------------------------------ frame acquisition


def _classify_acquire(found: bool, avail: int, rate_bits: int,
                      length_bytes: int, parity_ok: bool):
    """The host decision tree over acquisition outputs. Returns
    (RxResult, None) on any failure, (None, (rate_mbps, n_sym)) for a
    decodable frame. Length checks use the true capture length."""
    fail = RxResult(False, 0, 0, np.zeros(0, np.uint8), None)
    if not found or avail < 400 or not parity_ok:
        return fail, None
    rate_mbps = SIGNAL_BITS_TO_MBPS.get(rate_bits)
    if rate_mbps is None:
        return fail, None
    n_sym = n_symbols(length_bytes, RATES[rate_mbps])
    if avail < FRAME_DATA_START + 80 * n_sym:
        return RxResult(False, rate_mbps, length_bytes,
                        np.zeros(0, np.uint8), None), None
    return None, (rate_mbps, n_sym)


# 16-entry tables over the 4-bit SIGNAL RATE field: mbps (0 for the 8
# invalid codes) and n_dbps, so :func:`classify_acquire_graph` runs
# ``SIGNAL_BITS_TO_MBPS.get`` and ``n_symbols`` as tensor ops
_RB_TO_MBPS = np.zeros(16, np.int64)
_RB_TO_DBPS = np.zeros(16, np.int64)
for _rb, _m in SIGNAL_BITS_TO_MBPS.items():
    _RB_TO_MBPS[_rb] = _m
    _RB_TO_DBPS[_rb] = RATES[_m].n_dbps

# classification codes of the tensor tree and its host readers
ACQ_FAIL, ACQ_TRUNCATED, ACQ_DECODABLE = 0, 1, 2


def classify_acquire_graph(found, avail, rate_bits, length_bytes,
                           parity_ok):
    """The tensor twin of :func:`_classify_acquire`, elementwise over a
    batch of acquisitions on their device (no host read). Returns
    (status, rate_mbps, length_bytes, n_sym) as int64 tensors: status
    ``ACQ_FAIL`` (no detect, short capture, bad parity or unknown rate;
    rate and length 0, as the host tree's failure), ``ACQ_TRUNCATED``
    (the capture cannot hold the claimed DATA field; rate and length
    as parsed) or ``ACQ_DECODABLE``."""
    dev = found.device
    rb = rate_bits.to(torch.int64) & 15
    mbps = torch.from_numpy(_RB_TO_MBPS).to(dev)[rb]
    dbps = torch.from_numpy(_RB_TO_DBPS).to(dev)[rb]
    avail = avail.to(torch.int64)
    length = length_bytes.to(torch.int64)
    known = found.bool() & (avail >= 400) & parity_ok.bool() & (mbps > 0)
    n_bits = N_SERVICE_BITS + 8 * length + N_TAIL_BITS
    n_sym = torch.div(n_bits + dbps - 1, torch.clamp(dbps, min=1),
                      rounding_mode="floor")
    fits = avail >= FRAME_DATA_START + 80 * n_sym
    status = torch.where(known, torch.where(fits, ACQ_DECODABLE,
                                            ACQ_TRUNCATED), ACQ_FAIL)
    zero = torch.zeros_like(mbps)
    return (status, torch.where(known, mbps, zero),
            torch.where(known, length, zero), torch.where(known, n_sym, zero))


def acquire_frame_graph(x, n_valid, limit):
    """Batched acquisition: STS detect, LTS peak-pick, coarse+fine CFO,
    frame alignment, CFO rotation of the 400-sample head and the
    SIGNAL decode. x (B, L, 2) bucket-padded captures; n_valid (B,)
    true capture lengths; limit (B,) each lane's own power-of-two
    bucket. Returns per lane (found, start, eps, rate_bits, length,
    parity_ok); `found` folds in the >= 400-sample availability gate."""
    detected, start, eps = sync.locate_frame(x, limit=limit)
    avail = n_valid - start
    head = sync.correct_cfo(sync.dynamic_slice(x, start, 400), eps)
    rate_bits, length, parity_ok = decode_signal(head)
    found = detected & (avail >= 400)
    return found, start, eps, rate_bits, length, parity_ok


class _LaneAcq(NamedTuple):
    """A decodable lane of a batched acquisition, as host values."""
    row: int                    # row in the padded capture batch
    start: int
    eps: float
    avail: int
    rate_mbps: int
    length_bytes: int
    n_sym: int


def acquire_batch(x_dev, n_valid, limits, n_lanes: int):
    """Batched acquisition over a device-resident capture batch: one
    batched graph, one device-to-host read of its six small outputs,
    and the host decision tree. x_dev (R, L, 2); n_valid, limits (R,)
    ints; the first `n_lanes` rows are real. Returns (results, lanes):
    results[i] is the failure RxResult of an undecodable lane (None
    otherwise), lanes is [(i, _LaneAcq)] for the decodable ones."""
    dev = x_dev.device
    nv = torch.as_tensor(np.asarray(n_valid), dtype=torch.int64,
                         device=dev)
    lim = torch.as_tensor(np.asarray(limits), dtype=torch.int64,
                          device=dev)
    programs.note_site("rx.acquire_many", acquire_frame_graph, x_dev, nv,
                       lim)
    with dispatch.timed("rx.acquire_many"):
        outs = acquire_frame_graph(x_dev, nv, lim)
    # one transfer: every field is exact in float64 (eps is float32)
    host = torch.stack([o.to(torch.float64) for o in outs], 1).cpu().numpy()
    found_b, start_b, eps_b, rb_b, ln_b, pk_b = host.T
    n_valid = np.asarray(n_valid)
    results = [None] * n_lanes
    lanes = []
    for i in range(n_lanes):
        start = int(start_b[i])
        avail = int(n_valid[i]) - start
        res, ok = _classify_acquire(bool(found_b[i]), avail, int(rb_b[i]),
                                    int(ln_b[i]), bool(pk_b[i]))
        if ok is None:
            results[i] = res
            continue
        rate_mbps, n_sym = ok
        lanes.append((i, _LaneAcq(i, start, float(np.float32(eps_b[i])),
                                  avail, rate_mbps, int(ln_b[i]), n_sym)))
    return results, lanes


def acquire_many(captures, max_samples: int = 1 << 16, device="cuda"):
    """Batched acquisition front end: N captures (each (n, 2) float32
    array-like) -> (results, x_dev, lanes) as :func:`acquire_batch`,
    with x_dev the (pow2(N), L, 2) bucket-padded capture batch on
    `device`, kept there for the gather step. Every lane shares one
    capture bucket; each lane's own bucket caps its detection."""
    if not len(captures):
        return [], torch.zeros((0, 0, 2), device=device), []
    with telemetry.span("rx.acquire_pad"):
        xs = [np.asarray(s, np.float32)[:max_samples] for s in captures]
        n_valid = np.asarray([x.shape[0] for x in xs], np.int64)
        bucket = geometry.capture_bucket(int(n_valid.max()))
        n_lanes = len(xs)
        n_rows = pow2_ceil(n_lanes)
        x_pad = np.zeros((n_rows, bucket, 2), np.float32)
        for i, x in enumerate(xs):
            x_pad[i, :x.shape[0]] = x
        if n_lanes < n_rows:
            x_pad[n_lanes:] = x_pad[0]
        nv_pad = np.full((n_rows,), n_valid[0], np.int64)
        nv_pad[:n_lanes] = n_valid
        limits = np.asarray([geometry.capture_bucket(int(v))
                             for v in nv_pad], np.int64)
        x_dev = torch.from_numpy(x_pad).to(device)
    results, lanes = acquire_batch(x_dev, nv_pad, limits, n_lanes)
    return results, x_dev, lanes


def gather_segment_graph(x, start, eps, avail, n_sym_bucket: int):
    """Each lane's data region of (B, L, 2) captures at its own start,
    zeroed past its available samples and derotated by its own CFO, at
    one symbol bucket: (B, FRAME_DATA_START + 80*n_sym_bucket, 2).
    start, eps and avail are (B,) tensors on x's device; nothing is
    read back to the host. `x` must be padded so start + the segment
    never clamps (a start past the end clamps, as the reference's
    ``dynamic_slice`` does)."""
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    seg = sync.dynamic_slice(x, start, need_b)
    keep = torch.arange(need_b, device=x.device)[None, :] \
        < avail.clamp(max=need_b)[:, None]
    return sync.correct_cfo(torch.where(keep[..., None], seg, 0.0), eps)


def gather_segments_many(x_dev, lanes, n_sym_bucket: int):
    """Slice every lane's data region at its own start, zero it past
    the lane's available samples and apply its own CFO rotation, at one
    common symbol bucket: (len(lanes), FRAME_DATA_START +
    80*n_sym_bucket, 2) on x_dev's device. `lanes` are _LaneAcq rows,
    already padded to the target lane count."""
    dev = x_dev.device
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    cols = torch.tensor([[la.row, la.start, la.avail] for la in lanes],
                        device=dev)
    eps = torch.tensor([la.eps for la in lanes], dtype=torch.float32,
                       device=dev)
    # tail-pad so start + need_b stays in range (the reference pads
    # because dynamic_slice would clamp the start and shift the lane)
    x = torch.nn.functional.pad(x_dev[cols[:, 0]], (0, 0, 0, need_b))
    with dispatch.timed("rx.gather"):
        return gather_segment_graph(x, cols[:, 1], eps, cols[:, 2],
                                    n_sym_bucket)


# ------------------------------------------------- per-capture receive


class _Acquired(NamedTuple):
    """A detected, SIGNAL-parsed capture, ready for a DATA decode."""
    frame_np: np.ndarray        # samples from the frame start (float32)
    avail: int                  # true capture samples past the start
    eps: float                  # CFO estimate (a float32 value)
    rate_mbps: int
    length_bytes: int
    n_sym: int


def _sym_bucket(n_sym: int) -> int:
    """The power-of-two DATA symbol bucket (``geometry.sym_bucket``;
    named for :func:`receive`, whose ``geometry`` parameter hides the
    module)."""
    return geometry.sym_bucket(n_sym)


def _bucket_pad(x: np.ndarray):
    """Zero-pad a capture (n, 2) to its power-of-two bucket
    (``geometry.capture_bucket``, the reference's ``_stream_bucket``,
    which both acquisition paths share). Returns (padded, n_valid)."""
    n_valid = x.shape[0]
    bucket = geometry.capture_bucket(n_valid)
    if bucket != n_valid:
        x = np.concatenate(
            [x, np.zeros((bucket - n_valid, 2), np.float32)], axis=0)
    return x, n_valid


def sync_frame(samples):
    """Locate and align the frame in each of (B, n, 2) pre-segmented
    captures: (found, frame_start, cfo), ``sync.locate_frame`` over
    each lane's whole length."""
    return sync.locate_frame(samples)


def _host(*ts):
    """Small device tensors -> one float64 numpy row each, in one
    device-to-host read (every value is exact in float64)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts])
    return flat.cpu().numpy()


def _acquire_frame(samples, max_samples: int = 1 << 16, device="cuda"):
    """Detect, align and CFO-correct ONE capture and parse its SIGNAL
    field: the per-capture acquisition of :func:`receive` (the batched
    ``acquire_many`` equals it lane for lane). Returns (RxResult, None)
    on any failure, (None, _Acquired) on success."""
    x, n_valid = _bucket_pad(np.asarray(samples, np.float32)[:max_samples])
    x_dev = torch.from_numpy(x).to(device)[None]
    with dispatch.timed("rx.sync"):
        found, start, eps = sync_frame(x_dev)
    found_h, start_h, eps_h = _host(found, start, eps)
    found, start = bool(found_h), int(start_h)
    avail = n_valid - start
    rate_bits = length_bytes = 0
    parity_ok = False
    if found and avail >= 400:
        # the 400-sample head now, the data region after the SIGNAL
        # parse: both rotations start at the frame start
        with dispatch.timed("rx.cfo_head"):
            head = sync.correct_cfo(x_dev[:, start:start + 400], eps)
        with dispatch.timed("rx.signal"):
            sig = decode_signal(head)
        rb, ln, pk = _host(*sig)
        rate_bits, length_bytes, parity_ok = int(rb), int(ln), bool(pk)
    res, ok = _classify_acquire(found, avail, rate_bits, length_bytes,
                                parity_ok)
    if ok is None:
        return res, None
    rate_mbps, n_sym = ok
    return None, _Acquired(x[start:], avail, float(eps_h), rate_mbps,
                           length_bytes, n_sym)


def _padded_segment(acq: _Acquired, n_sym_bucket: int, device="cuda"):
    """The acquired frame's data region padded to `n_sym_bucket`
    symbols and CFO-corrected, on `device`: (FRAME_DATA_START +
    80*n_sym_bucket, 2). The batched ``gather_segments_many`` gives
    the same values for a whole batch."""
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    frame_pad = np.zeros((need_b, 2), np.float32)
    n = min(acq.avail, need_b)
    frame_pad[:n] = acq.frame_np[:n]
    eps = torch.tensor([acq.eps], dtype=torch.float32, device=device)
    with dispatch.timed("rx.cfo_segment"):
        return sync.correct_cfo(
            torch.from_numpy(frame_pad).to(device)[None], eps)[0]


def _agc_quantize(seg: torch.Tensor, preamble: np.ndarray) -> torch.Tensor:
    """The fixed-point boundary of ``receive(fxp=True)``: `seg` scaled to
    unit average power over the real preamble, then quantized to Q11.
    The RMS is numpy float64 on the host, as the reference's. The
    reference divides a float32 array by it in float32, the divisor
    rounded to float32; here both float32 values are divided in float64
    and the quotient rounded to float32, which is that same correctly
    rounded quotient on every device."""
    from ziria_tpu_torch.phy.wifi import rx_fxp
    rms = float(np.sqrt(np.mean(preamble.astype(np.float64) ** 2) * 2.0))
    div = float(np.float32(max(rms, 1e-12)))
    return rx_fxp.quantize_frame(
        (seg.to(torch.float64) / div).to(torch.float32))


def check_device(device, caller: str) -> torch.device:
    """`device` as a torch.device; raises when it is CUDA and no card
    is there (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: device='cuda' but torch.cuda.is_available() is "
            f"False (pass device='cpu' to run on the CPU)")
    return device


def receive(samples, check_fcs: bool = False,
            max_samples: int = 1 << 16, fxp: bool = False,
            viterbi_window: int = None,
            viterbi_metric: str = None,
            viterbi_radix: int = None,
            fused_demap: bool = None,
            sco_track: bool = None,
            geometry=None, device="cuda") -> RxResult:
    """Per-capture receiver: detect, align, CFO-correct, parse SIGNAL,
    then decode the DATA field at the parsed rate, padded to a
    power-of-two symbol bucket with the true bit count masking the
    rest (:func:`decode_data_bucketed`). One capture ((n, 2) float32
    array-like) -> one :class:`RxResult`, field for field the
    reference's ``rx.receive``.

    The default decode is the scan decoder (the reference's is
    ``lax.scan``, no kernel), as is ``viterbi_metric="int16"`` at radix
    2; ``viterbi_radix=4`` (None reads ZIRIA_VITERBI_RADIX) and int8
    metrics run the ACS and traceback kernels over one lane,
    ``viterbi_window`` the windowed decode; ``fused_demap`` (or
    ZIRIA_FUSED_DEMAP) runs the known-rate fused kernel and the
    traceback kernel instead, at float32 metrics without a window.
    ``sco_track`` (or ZIRIA_RX_SCO_TRACK) adds the pilot phase-ramp
    tracking. ``geometry`` (a ``utils.geometry.Geometry``) supplies the
    default of every decode-mode knob left None. Runs on `device`
    ("cuda" by default; the tests pass "cpu").

    ``fxp=True`` routes the DATA decode through the Q15 integer interior
    (phy/wifi/rx_fxp.py): acquisition and SIGNAL stay float32; the
    aligned data region is AGC-normalized by the preamble RMS
    (:func:`_agc_quantize`) and quantized to Q11,
    after which every decode op is exact integer arithmetic. The
    window, metric, radix, SCO and fused knobs are ignored under it.
    The integer interior is exact on equal input, but its Q11 input is
    not the reference's bit for bit: the float32 acquisition and CFO
    rotation before it round differently (XLA's float32 sin, cos and
    atan2 are its own), so a few Q11 samples of a capture can differ
    by one LSB. The whole receive is held field for field to the
    reference's (tests/test_torch_rx_fxp_lowsnr.py bounds the Q11
    difference on 64 captures down to low SNR)."""
    if geometry is not None:
        viterbi_window = (geometry.viterbi_window
                          if viterbi_window is None else viterbi_window)
        viterbi_metric = (geometry.viterbi_metric
                          if viterbi_metric is None else viterbi_metric)
        viterbi_radix = (geometry.viterbi_radix
                         if viterbi_radix is None else viterbi_radix)
        fused_demap = (geometry.fused_demap
                       if fused_demap is None else fused_demap)
        sco_track = (geometry.sco_track
                     if sco_track is None else sco_track)
    device = check_device(device, "receive")
    with cplx.exact_fp32():
        res, acq = _acquire_frame(samples, max_samples, device)
        if acq is None:
            return res
        rate = RATES[acq.rate_mbps]
        n_sym_b = _sym_bucket(acq.n_sym)
        seg = _padded_segment(acq, n_sym_b, device)
        if fxp:
            seg = _agc_quantize(seg, acq.frame_np[:320])
        with dispatch.timed("rx.decode_bucketed"):
            if fxp:
                clear = decode_data_bucketed(
                    seg, rate, n_sym_b, acq.n_sym * rate.n_dbps, fxp=True)
            else:
                clear = decode_data_bucketed(
                    seg, rate, n_sym_b, acq.n_sym * rate.n_dbps,
                    viterbi_window, viterbi_metric,
                    viterbi._check_radix(viterbi_radix),
                    fused_demap_enabled(fused_demap),
                    sco_track_enabled(sco_track))
        psdu = clear[N_SERVICE_BITS: N_SERVICE_BITS + 8 * acq.length_bytes]
        crc = bool(check_crc32(psdu)) if check_fcs else None
        return RxResult(True, acq.rate_mbps, acq.length_bytes,
                        psdu.cpu().numpy(), crc)


# ------------------------------------------------------ streaming receiver
#
# The per-chunk device half of ``backend/framebatch.StreamReceiver``:
# :func:`stream_chunk_graph` turns long multi-frame chunks into K
# candidate lanes each (multi-frame detect, per-candidate windows, the
# batched per-window acquisition, the gather at one fixed symbol
# bucket) without reading the host; :func:`stream_decode_graph` decodes
# a chunk's decodable lanes. Between the two the host runs only the
# integer decision tree, on one transfer of the chunk's small outputs.


def _stream_bucket_graph(n_valid: torch.Tensor, cap: int) -> torch.Tensor:
    """Tensor twin of ``geometry.capture_bucket`` (the reference's
    ``_stream_bucket``) for true sample counts up to the window length
    `cap`: an exact compare ladder (float log2 would not be exact)."""
    b = torch.full_like(n_valid, geometry.CAPTURE_BUCKET_MIN)
    m = geometry.CAPTURE_BUCKET_MIN
    while m < cap:
        m *= 2
        b = torch.where(n_valid > m // 2, torch.full_like(b, m), b)
    return b


def stream_chunk_graph(chunk, chunk_valid, own_lo, own_hi, k: int,
                       win_len: int, n_sym_bucket: int,
                       threshold: float = 0.75, min_run: int = 33,
                       dead_zone: int = 320):
    """The chunk scan of S streams' chunks (S, n, 2), with per-stream
    (S,) int64 tensors chunk_valid (real samples), own_lo and own_hi
    (the owned start range): the reference's ``stream_chunk_graph``
    over a leading stream axis (S = 1 for one stream).

    1. ``sync.locate_frames``: up to k starts per chunk over its valid
       samples, the overflow scan capped at own_hi + 224 (a frame
       aligned at s can cross the plateau gate as late as s + 224);
    2. ownership: starts in [own_lo, own_hi) are the chunk's, clamped
       to 0 (own_lo is -192 on a stream's first chunk, for a
       head-truncated preamble, else 0);
    3. each candidate's win_len-sample window at clip(start, 0, n) of
       the chunk tail-padded by win_len, its true count and own
       power-of-two bucket as its detector cap;
    4. the batched per-window acquisition (:func:`acquire_frame_graph`);
    5. the gather of every window's data region at n_sym_bucket.

    Returns (own, starts, overflow, found, fstart, eps, rate_bits,
    length, parity_ok, n_valid, segs): (S, k) per lane, overflow (S,),
    segs (S, k, FRAME_DATA_START + 80*n_sym_bucket, 2). No value is
    read back to the host."""
    streams, n = chunk.shape[:2]
    dev = chunk.device
    found, starts, overflow = sync.locate_frames(
        chunk, k, limit=chunk_valid, threshold=threshold, min_run=min_run,
        dead_zone=dead_zone, overflow_limit=own_hi + 224)
    own = found & (starts >= own_lo[:, None]) & (starts < own_hi[:, None])
    starts = torch.where(own, starts.clamp(min=0), starts)
    safe = starts.clamp(0, n)
    chunk_pad = torch.nn.functional.pad(chunk, (0, 0, 0, win_len))
    idx = (safe[..., None] + torch.arange(win_len, device=dev))[..., None]
    wins = torch.gather(chunk_pad[:, None].expand(-1, k, -1, -1), 2,
                        idx.expand(-1, -1, -1, 2))
    wins = wins.reshape(streams * k, win_len, 2)
    nv = (chunk_valid[:, None] - safe).clamp(0, win_len).reshape(-1)
    lim = _stream_bucket_graph(nv, win_len)
    f2, fstart, eps, rb, ln, pk = acquire_frame_graph(wins, nv, lim)
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    wins_pad = torch.nn.functional.pad(wins, (0, 0, 0, need_b))
    segs = gather_segment_graph(wins_pad, fstart, eps, nv - fstart,
                                n_sym_bucket)
    lanes = [t.reshape(streams, k)
             for t in (f2, fstart, eps, rb, ln, pk, nv)]
    return (own, starts, overflow, *lanes,
            segs.reshape((streams, k) + segs.shape[1:]))


def stream_decode_graph(segs, rows, ridx, nbits, npsdu, n_sym_bucket: int,
                        viterbi_window: int = None,
                        viterbi_metric: str = None,
                        viterbi_radix: int = None,
                        sco_track: bool = False,
                        fused_demap: bool = False):
    """The decode of a chunk's decodable lanes (the body of the
    reference's ``_jit_stream_decode``): segs (k, need_b, 2) from
    :func:`stream_chunk_graph`, rows (k,) the lane rows to decode
    (padded to k with the first), ridx and nbits (k,) host ints, npsdu
    (k,) PSDU bit counts, all host ints. Row-selects on the device, runs
    :func:`decode_data_mixed` and always the masked CRC
    (:func:`crc_psdu_many_graph`). Returns (clear (k, n_sym_bucket *
    MAX_DBPS) uint8, crc (k,) bool), both on segs' device."""
    # both index rows in one upload, without a stream sync
    rows_t, npsdu_t = torch.tensor([rows, npsdu]).to(segs.device,
                                                     non_blocking=True)
    clear = decode_data_mixed(segs[rows_t], ridx, nbits, n_sym_bucket,
                              viterbi_window, viterbi_metric,
                              viterbi_radix, sco_track=sco_track,
                              fused_demap=fused_demap)
    return clear, crc_psdu_many_graph(clear, npsdu_t)


# ---------------------------------------------------- S-stream fleet
#
# The device half of ``backend/framebatch.MultiStreamReceiver``: S
# streams' chunks ride one scan on a leading stream axis, and every
# stream's decodable lanes one flattened (S*K)-lane decode. Each lane's
# values are those of the single-stream programs on that lane, so the
# fleet emits what S lone receivers would.


def multi_stream_chunk_graph(chunks, valid, own_lo, own_hi, k: int,
                             win_len: int, n_sym_bucket: int,
                             threshold: float = 0.75, min_run: int = 33,
                             dead_zone: int = 320):
    """The fleet's chunk scan (the reference's ``multi_stream_chunk_graph``
    :1088): chunks (S, chunk_len, 2), per-stream (S,) valid, own_lo and
    own_hi; an idle or quarantined lane rides ``valid == 0`` and finds
    nothing. :func:`stream_chunk_graph` already takes the stream axis,
    and lane i of the result is its S = 1 call on lane i."""
    return stream_chunk_graph(chunks, valid, own_lo, own_hi, k, win_len,
                              n_sym_bucket, threshold, min_run, dead_zone)


def stream_decode_multi_graph(segs, rows, ridx, nbits, npsdu,
                              n_sym_bucket: int, viterbi_window: int = None,
                              viterbi_metric: str = None,
                              viterbi_radix: int = None,
                              sco_track: bool = False,
                              fused_demap: bool = False):
    """The fleet's decode (the body of the reference's
    ``_jit_stream_decode_multi`` :1137): segs (S, K, need_b, 2) from the
    scan; rows, ridx, nbits and npsdu (S, K) host ints, each stream's
    decodable lanes first and zeros after (a zero-bit pad lane decodes
    to erasures, and is discarded). Per-stream row select on the
    device, one (S*K)-lane :func:`decode_data_mixed` and one masked CRC.
    Returns (clear (S, K, n_sym_bucket * MAX_DBPS) uint8, crc (S, K)
    bool) on segs' device, with no host read."""
    s, kk = segs.shape[:2]
    rows = np.asarray(rows, np.int64)
    # both index tables in one upload, without a stream sync
    idx = torch.from_numpy(np.stack(
        [rows.reshape(-1), np.asarray(npsdu, np.int64).reshape(-1)])) \
        .to(segs.device, non_blocking=True)
    lane = torch.arange(s, device=segs.device).repeat_interleave(kk)
    clear = decode_data_mixed(segs[lane, idx[0]], np.asarray(ridx).reshape(-1),
                              np.asarray(nbits).reshape(-1), n_sym_bucket,
                              viterbi_window, viterbi_metric, viterbi_radix,
                              sco_track=sco_track, fused_demap=fused_demap)
    crc = crc_psdu_many_graph(clear, idx[1])
    return clear.reshape(s, kk, -1), crc.reshape(s, kk)
