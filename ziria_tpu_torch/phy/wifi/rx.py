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
rate-independent :func:`_front_symbols`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, cplx, demap as demap_mod, \
    interleave, ofdm, scramble, sync, viterbi, viterbi_cuda, viterbi_fused
from ziria_tpu_torch.ops.crc import check_crc32, check_crc32_masked
from ziria_tpu_torch.phy.wifi.params import (MAX_DBPS, N_SERVICE_BITS,
                                             RATE_MBPS_ORDER, RATES,
                                             SIGNAL_BITS_TO_MBPS,
                                             RateParams, n_symbols)
from ziria_tpu_torch.utils import geometry
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


# the reference's decode-mode knobs, the values (besides None) of the
# default mode the port runs, and the ROADMAP.md item that ports the rest
_DEFAULT_MODE = {"viterbi_window": (0,), "viterbi_metric": ("float32",),
                 "viterbi_radix": (2,)}
_DECODE_MODES_ITEM = "queue 1, 'Decode modes off the default'"


def check_decode_knobs(caller: str, viterbi_window=None, viterbi_metric=None,
                       viterbi_radix=None, fused: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item that ports
    it, for a decode mode the port does not run yet: a window, a
    quantized metric, radix 4, or (with the fused front on) radix 4."""
    if fused and viterbi_radix == 4:
        raise NotImplementedError(
            f"{caller}(fused_demap=True, viterbi_radix=4) is not ported "
            f"yet: the fused kernels run radix 2 (ROADMAP.md queue 2, "
            f"the radix-4 item)")
    for name, value in (("viterbi_window", viterbi_window),
                        ("viterbi_metric", viterbi_metric),
                        ("viterbi_radix", viterbi_radix)):
        if value is not None and value not in _DEFAULT_MODE[name]:
            raise NotImplementedError(
                f"{caller}({name}={value!r}) is not ported yet; it runs "
                f"only the default decode mode (ROADMAP.md "
                f"{_DECODE_MODES_ITEM})")


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
    ACS and traceback kernels; fused: :func:`_front_symbols`, then the
    known-rate fused kernel (ops/viterbi_fused) and the traceback."""
    fused = fused_demap_enabled(fused_demap) \
        and _fused_front_applies(viterbi_window, viterbi_metric)
    check_decode_knobs("decode_data_batch", viterbi_window, viterbi_metric,
                       viterbi_radix, fused)
    T = n_sym * rate.n_dbps
    if fused:
        data, gain = _front_symbols(frames, n_sym, sco_track)
        bits = viterbi_fused.viterbi_decode_batch_fused(data, gain, rate,
                                                        n_bits=T)
    else:
        dep = _decode_front(frames, rate, n_sym, sco_track)
        bits = viterbi_cuda.viterbi_decode_batch(dep)[:, :T]
    return _decode_back(bits, n_psdu_bits)


def decode_data_bucketed(frame, rate: RateParams, n_sym_bucket: int,
                         n_bits_real: int, viterbi_window: int = None,
                         viterbi_metric: str = None,
                         viterbi_radix: int = None,
                         fused_demap: bool = None,
                         sco_track: bool = False):
    """DATA decode of ONE frame (FRAME_DATA_START + 80*n_sym_bucket, 2)
    padded to a symbol bucket, with n_bits_real true data bits ->
    (n_sym_bucket * n_dbps,) descrambled bits; steps at or past
    n_bits_real are erasures. Fused: the known-rate fused kernel over
    one lane; otherwise the front at `rate` and the scan decoder."""
    fused = fused_demap_enabled(fused_demap) \
        and _fused_front_applies(viterbi_window, viterbi_metric)
    check_decode_knobs("decode_data_bucketed", viterbi_window,
                       viterbi_metric, viterbi_radix, fused)
    if fused:
        data, gain = _front_symbols(frame[None], n_sym_bucket, sco_track)
        bits = viterbi_fused.viterbi_decode_batch_fused(
            data, gain, rate, n_bits=n_sym_bucket * rate.n_dbps,
            nbits_real=[int(n_bits_real)])
    else:
        bits = _decode_data_bits_unfused(frame, rate, n_sym_bucket,
                                         n_bits_real, sco_track)[None]
    return scramble.descramble_bits(
        bits, scramble.recover_seed(bits[:, :7]))[0]


def _decode_data_bits_unfused(frame, rate: RateParams, n_sym_bucket: int,
                              n_bits_real: int, sco_track: bool = False):
    """The unfused body of :func:`decode_data_bucketed` at the default
    decode mode: the front at `rate`, the erasure mask at n_bits_real,
    then the scan decoder (ops/viterbi, the reference's ``lax.scan``
    decoder: no kernel). Raw decoded bits (n_sym_bucket * n_dbps,)."""
    dep = _decode_front(frame[None], rate, n_sym_bucket, sco_track)[0]
    t = torch.arange(dep.shape[0], device=dep.device)
    dep = torch.where((t < n_bits_real)[:, None], dep, 0.0)
    return viterbi.viterbi_decode(dep[None],
                                  n_bits=n_sym_bucket * rate.n_dbps)[0]


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
    (:func:`mixed_front`) and the one rate-agnostic Viterbi runs over
    the whole batch through the ACS and traceback kernels
    (ops/viterbi_cuda). Fused, one rate-independent
    :func:`_front_symbols` feeds the rate-switched fused kernel
    (ops/viterbi_fused), which demaps, deinterleaves and depunctures
    each lane at its own rate inside the ACS."""
    fused = fused_demap_enabled(fused_demap) \
        and _fused_front_applies(viterbi_window, viterbi_metric)
    check_decode_knobs("decode_data_mixed", viterbi_window, viterbi_metric,
                       viterbi_radix, fused)
    if fused:
        data, gain = _front_symbols(frames, n_sym_bucket, sco_track)
        bits = viterbi_fused.viterbi_decode_mixed_fused(data, gain, rate_idx,
                                                        n_bits_real)
    else:
        dep = mixed_front(frames, rate_idx, n_bits_real, n_sym_bucket,
                          sco_track)
        bits = viterbi_cuda.viterbi_decode_batch(dep)
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
    limits = np.asarray([geometry.capture_bucket(int(v)) for v in nv_pad],
                        np.int64)
    x_dev = torch.from_numpy(x_pad).to(device)
    results, lanes = acquire_batch(x_dev, nv_pad, limits, n_lanes)
    return results, x_dev, lanes


def gather_segments_many(x_dev, lanes, n_sym_bucket: int):
    """Slice every lane's data region at its own start, zero it past
    the lane's available samples and apply its own CFO rotation, at one
    common symbol bucket: (len(lanes), FRAME_DATA_START +
    80*n_sym_bucket, 2) on x_dev's device. `lanes` are _LaneAcq rows,
    already padded to the target lane count."""
    dev = x_dev.device
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    rows = torch.tensor([la.row for la in lanes], device=dev)
    start = torch.tensor([la.start for la in lanes], device=dev)
    eps = torch.tensor([la.eps for la in lanes], dtype=torch.float32,
                       device=dev)
    avail = torch.tensor([la.avail for la in lanes], device=dev)
    # tail-pad so start + need_b stays in range (the reference pads
    # because dynamic_slice would clamp the start and shift the lane)
    x = torch.nn.functional.pad(x_dev[rows], (0, 0, 0, need_b))
    seg = sync.dynamic_slice(x, start, need_b)
    n = avail.clamp(max=need_b)
    keep = torch.arange(need_b, device=dev)[None, :] < n[:, None]
    seg = torch.where(keep[..., None], seg, 0.0)
    return sync.correct_cfo(seg, eps)


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


def _acquire_frame(samples, max_samples: int = 1 << 16, device="cpu"):
    """Detect, align and CFO-correct ONE capture and parse its SIGNAL
    field: the per-capture acquisition of :func:`receive` (the batched
    ``acquire_many`` equals it lane for lane). Returns (RxResult, None)
    on any failure, (None, _Acquired) on success."""
    x, n_valid = _bucket_pad(np.asarray(samples, np.float32)[:max_samples])
    x_dev = torch.from_numpy(x).to(device)[None]
    found, start, eps = sync_frame(x_dev)
    found_h, start_h, eps_h = _host(found, start, eps)
    found, start = bool(found_h), int(start_h)
    avail = n_valid - start
    rate_bits = length_bytes = 0
    parity_ok = False
    if found and avail >= 400:
        # the 400-sample head now, the data region after the SIGNAL
        # parse: both rotations start at the frame start
        head = sync.correct_cfo(x_dev[:, start:start + 400], eps)
        rb, ln, pk = _host(*decode_signal(head))
        rate_bits, length_bytes, parity_ok = int(rb), int(ln), bool(pk)
    res, ok = _classify_acquire(found, avail, rate_bits, length_bytes,
                                parity_ok)
    if ok is None:
        return res, None
    rate_mbps, n_sym = ok
    return None, _Acquired(x[start:], avail, float(eps_h), rate_mbps,
                           length_bytes, n_sym)


def _padded_segment(acq: _Acquired, n_sym_bucket: int, device="cpu"):
    """The acquired frame's data region padded to `n_sym_bucket`
    symbols and CFO-corrected, on `device`: (FRAME_DATA_START +
    80*n_sym_bucket, 2). The batched ``gather_segments_many`` gives
    the same values for a whole batch."""
    need_b = FRAME_DATA_START + 80 * n_sym_bucket
    frame_pad = np.zeros((need_b, 2), np.float32)
    n = min(acq.avail, need_b)
    frame_pad[:n] = acq.frame_np[:n]
    eps = torch.tensor([acq.eps], dtype=torch.float32, device=device)
    return sync.correct_cfo(torch.from_numpy(frame_pad).to(device)[None],
                            eps)[0]


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
    ``lax.scan``, no kernel); ``fused_demap`` (or ZIRIA_FUSED_DEMAP)
    runs the known-rate fused kernel and the traceback kernel instead.
    ``sco_track`` (or ZIRIA_RX_SCO_TRACK) adds the pilot phase-ramp
    tracking. Runs on `device` ("cuda" by default; the tests pass
    "cpu"). ``fxp``, a ``geometry`` object, a window, a quantized
    metric and radix 4 raise NotImplementedError naming the ROADMAP.md
    item that ports them."""
    if fxp:
        raise NotImplementedError(
            "receive(fxp=True) is not ported yet (ROADMAP.md queue 1, "
            "item 9, 'Fixed-point path and entry points')")
    if geometry is not None:
        raise NotImplementedError(
            "receive(geometry=...) is not ported yet; the port has the "
            "default bucket rules only (ROADMAP.md queue 1, item 6, "
            "'Observability, geometry and bench on GPU')")
    fused = fused_demap_enabled(fused_demap) \
        and _fused_front_applies(viterbi_window, viterbi_metric)
    check_decode_knobs("receive", viterbi_window, viterbi_metric,
                       viterbi_radix, fused)
    device = check_device(device, "receive")
    with cplx.exact_fp32():
        res, acq = _acquire_frame(samples, max_samples, device)
        if acq is None:
            return res
        rate = RATES[acq.rate_mbps]
        n_sym_b = _sym_bucket(acq.n_sym)
        seg = _padded_segment(acq, n_sym_b, device)
        clear = decode_data_bucketed(seg, rate, n_sym_b,
                                     acq.n_sym * rate.n_dbps,
                                     fused_demap=fused,
                                     sco_track=sco_track_enabled(sco_track))
        psdu = clear[N_SERVICE_BITS: N_SERVICE_BITS + 8 * acq.length_bytes]
        crc = bool(check_crc32(psdu)) if check_fcs else None
        return RxResult(True, acq.rate_mbps, acq.length_bytes,
                        psdu.cpu().numpy(), crc)
