"""802.11a/g OFDM receiver chain, the batched receive path
(counterpart of ziria_tpu/phy/wifi/rx.py).

Packet detect (STS autocorrelation), CFO estimate and correction,
channel estimate (LTS), SIGNAL decode; then, for the DATA field, FFT,
equalize, pilot tracking, soft demap, deinterleave, depuncture,
Viterbi, descramble and CRC. Every function runs a batch of frames
with the batch axis first, where the reference ran one frame under
``vmap``; the host does only the integer header parsing between the
acquire, gather and decode steps, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, cplx, demap as demap_mod, \
    interleave, ofdm, scramble, sync, viterbi, viterbi_cuda
from ziria_tpu_torch.ops.crc import check_crc32_masked
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


def pilot_phase_correct(data, pilots, symbol_index0: int):
    """Common-phase derotation of each symbol from its 4 pilots: data
    (B, n_sym, 48, 2), pilots (B, n_sym, 4, 2), pilot polarity index
    starting at symbol_index0 (the reference's ``sco_track=False``
    branch)."""
    expect = ofdm.pilot_values(data.shape[-3], symbol_index0, data.device)
    weighted = pilots * expect[..., None]
    ph = torch.atan2(weighted[..., 1].sum(-1), weighted[..., 0].sum(-1))
    derot = cplx.cexp(-ph)                                  # (B, n_sym, 2)
    return cplx.cmul(data, derot[..., None, :])


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


def _front_symbols(frame, n_sym: int):
    """Aligned frames (B, >=400+80*n_sym, 2) -> (data (B, n_sym, 48, 2),
    gain (B, 48)): channel estimate, (n_sym x 64) matmul FFT, equalize,
    bounded-|H| guard, pilot tracking."""
    H = sync.estimate_channel(frame)
    syms = frame[:, FRAME_DATA_START: FRAME_DATA_START + 80 * n_sym]
    bins = ofdm.ofdm_demodulate(syms.reshape(frame.shape[0], n_sym, 80, 2))
    eq = equalize(bins, H)
    data, pilots = ofdm.extract_subcarriers(eq)
    data, pilots, gain = guard_subcarriers(data, pilots, H)
    return pilot_phase_correct(data, pilots, symbol_index0=1), gain


def _decode_front(frame, rate: RateParams, n_sym: int):
    """Aligned frames -> depunctured soft pairs (B, n_sym*n_dbps, 2):
    everything before the Viterbi, at one known rate."""
    data, gain = _front_symbols(frame, n_sym)
    llrs = demap_mod.demap(data, rate.n_bpsc,
                           gain=gain[:, None, :].expand(data.shape[:-1]))
    deint = interleave.deinterleave(llrs.reshape(frame.shape[0], -1),
                                    rate.n_cbps, rate.n_bpsc)
    dep = coding.depuncture(deint, rate.coding, fill=0.0)
    return dep.reshape(frame.shape[0], -1, 2)


def mixed_front(frames, rate_idx: Sequence[int], n_bits_real,
                n_sym_bucket: int):
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
                             n_sym_bucket)
        dep[lanes, :part.shape[1]] = part
    nb = torch.as_tensor(n_bits_real, dtype=torch.int64, device=dev)
    t = torch.arange(t_max, device=dev)
    return torch.where((t[None, :] < nb[:, None])[..., None], dep, 0.0)


def decode_data_mixed(frames, rate_idx: Sequence[int], n_bits_real,
                      n_sym_bucket: int):
    """Mixed-rate batched DATA decode: frames (B, FRAME_DATA_START +
    80*n_sym_bucket, 2) aligned and CFO-corrected, rate_idx (B,) host
    ints, n_bits_real (B,) true data-bit counts. Returns (B,
    n_sym_bucket * MAX_DBPS) uint8 descrambled bit streams.

    Each lane's front runs at its own rate (:func:`mixed_front`); the
    one rate-agnostic Viterbi then runs over the whole batch through
    the CUDA kernels (ops/viterbi_cuda)."""
    dep = mixed_front(frames, rate_idx, n_bits_real, n_sym_bucket)
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
