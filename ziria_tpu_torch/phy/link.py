"""TX -> channel -> RX loopback link, BER sweeps and stream stimulus
(counterpart of ziria_tpu/phy/link.py).

``loopback_many`` runs N mixed-rate frames through the batched TX
(``tx.encode_many_graph``), the batched channel
(``channel.impair_many_graph``) and the receiver, in three modes that
agree lane for lane:

- fused (default; ZIRIA_FUSED_LINK=0 turns it off): encode -> channel
  -> acquire -> ``rx.classify_acquire_graph`` -> gather -> mixed decode
  -> masked CRC over the whole batch on the device, the host reading
  only once everything is launched; the reference's ``_jit_fused_link``
  chain as one device-resident pass;
- staged (``fused=False``): encode, channel, then
  ``framebatch.receive_many_device`` (acquire, one host read, gather,
  decode);
- per frame (``batched_tx=False``, ZIRIA_BATCHED_TX=0): ``encode_frame``,
  ``channel.impair_one`` and ``rx.receive`` a frame at a time.

Each lane's channel draws the reference's noise (``utils/threefry``,
the lane-key schedule of ``channel.lane_key``) over the same capture
bucket in every mode, so the modes and the reference decode the same
samples. The fused link replays the batch through the staged one only
when a decoded SIGNAL claims another valid header than the TX sent (a
parity escape): the fused decode runs at the TX geometry, the staged one
at the decoded one. On a CUDA device nothing else degrades a mode:
only an injected fault does (``framebatch._contained``); a kernel that
fails to build or launch raises.

``sweep_ber`` runs a BER waterfall over (rate, SNR, seed[, profile]):
one loop on the device over the points into a preallocated int32 error
buffer, read once at the end, count for count a loop of
``loopback_ber_bits``. ``stream_many`` and ``stream_many_multi`` make
the streaming receivers' stimulus.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.ops.viterbi import _check_radix
from ziria_tpu_torch.phy import channel
from ziria_tpu_torch.phy import profiles as chanprof
from ziria_tpu_torch.phy.wifi import rx, tx
from ziria_tpu_torch.phy.wifi.params import N_SERVICE_BITS, \
    RATE_MBPS_ORDER, RATES, n_symbols
from ziria_tpu_torch.runtime import resilience
from ziria_tpu_torch.utils import dispatch, geometry as _geometry, \
    telemetry, threefry
from ziria_tpu_torch.utils.dispatch import pad_lanes, pow2_ceil


def _degrade_or_raise(e: BaseException, device: torch.device,
                      counter: str) -> None:
    """Let failure `e` degrade a link pass or raise it: on a CUDA device
    only an injected fault degrades. A degrade sets the
    ``link.degraded_mode`` gauge and counts `counter`."""
    if not framebatch._contained(e, device.type == "cuda"):
        raise e
    dispatch.record_gauge("link.degraded_mode", 1.0)
    telemetry.count(counter)


def batched_tx_enabled(batched_tx: Optional[bool] = None) -> bool:
    """The ``batched_tx`` knob: the explicit value, else
    ZIRIA_BATCHED_TX (default on)."""
    if batched_tx is not None:
        return batched_tx
    return os.environ.get("ZIRIA_BATCHED_TX", "1") != "0"


def fused_link_enabled(fused: Optional[bool] = None) -> bool:
    """The ``fused`` knob of ``loopback_many``: the explicit value,
    else ZIRIA_FUSED_LINK (default on)."""
    if fused is not None:
        return fused
    return os.environ.get("ZIRIA_FUSED_LINK", "1") != "0"


def transmit_many(psdus: Sequence, rates_mbps: Sequence[int],
                  add_fcs: bool = False, batched_tx: Optional[bool] = None,
                  device="cuda") -> List[np.ndarray]:
    """N mixed-rate, mixed-length frames -> per-frame (n, 2) float32
    sample arrays at their true lengths: one ``encode_many`` and one
    copy to the host (default), or ``encode_frame`` a frame at a time
    (``batched_tx=False``); equal either way. The empty batch is []."""
    if not len(psdus):
        return []
    if not batched_tx_enabled(batched_tx):
        return [tx.encode_frame(p, m, add_fcs=add_fcs, device=device)
                .cpu().numpy() for p, m in zip(psdus, rates_mbps)]
    txb = tx.encode_many(psdus, rates_mbps, add_fcs=add_fcs, device=device)
    arr = txb.samples[:len(psdus)].cpu().numpy()
    return [arr[i, :int(v)] for i, v in enumerate(txb.n_valid)]


def _lane_param(v, n: int, dtype) -> np.ndarray:
    return np.broadcast_to(np.asarray(v, dtype), (n,)).copy()


def _link_buckets(psdus, rates_mbps, add_fcs: bool, dly_max: int,
                  tap_pad: int = 0):
    """The link's (symbol bucket, capture bucket): the common symbol
    bucket's frame length plus the worst delay and the FIR ring
    (``tap_pad``, max taps - 1 of a profiled link), at the receiver's
    capture-bucket rule. Every mode calls this: a lane's noise is drawn
    over the whole capture, so the bucket is part of the result."""
    fcs_bytes = 4 if add_fcs else 0
    sym_b = max(tx._sym_bucket(n_symbols(
        int(np.asarray(p).size) + fcs_bytes, RATES[m]))
        for p, m in zip(psdus, rates_mbps))
    return sym_b, _geometry.capture_bucket(
        400 + 80 * sym_b + int(dly_max) + int(tap_pad))


class _LinkGeometry:
    """The batch geometry of the staged and fused link: the shared TX
    prep (``tx.batch_host_prep``) plus the link's row tables (channel
    parameters, capture bucket, per-lane decode bit counts), rows
    padded by the pad_lanes rule."""

    def __init__(self, psdus, rates_mbps, snr, eps, dly, add_fcs,
                 tap_pad: int = 0):
        n = len(psdus)
        self.n = n
        self.prep = prep = tx.batch_host_prep(psdus, rates_mbps, add_fcs)
        self.n_sym = prep.n_sym
        self.sym_b = prep.n_sym_bucket
        self.nbits_b = prep.nbits_b
        self.ridx_b = prep.ridx_b
        _sym_b, self.l_cap = _link_buckets(psdus, rates_mbps, add_fcs,
                                           int(dly.max()), tap_pad)
        self.rows = pow2_ceil(n)
        lanes = pad_lanes(list(range(n)))
        self.nv_tx = np.asarray([400 + 80 * int(self.n_sym[i])
                                 for i in lanes], np.int64)
        self.ndata_b = np.asarray(
            [int(self.n_sym[i]) * RATES[rates_mbps[i]].n_dbps
             for i in lanes], np.int64)

        def _pad_rows(a):
            return np.concatenate(
                [a, np.broadcast_to(a[0], (self.rows - n,) + a.shape[1:])])
        self.snr = _pad_rows(snr)
        self.eps = _pad_rows(eps)
        self.dly = _pad_rows(dly).astype(np.int64)

    def channel_args(self, device):
        """(n_valid, snr, eps, delay) row tensors on `device`."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (self.nv_tx, self.snr, self.eps, self.dly))


def loopback_many(psdus, rates_mbps: Sequence[int], snr_db=np.inf, cfo=0.0,
                  delay=0, seed: int = 0, add_fcs: bool = False,
                  check_fcs: bool = False,
                  batched_tx: Optional[bool] = None,
                  fused: Optional[bool] = None,
                  viterbi_window: int = None, viterbi_metric: str = None,
                  viterbi_radix: int = None, channel_profile=None,
                  sco_track: Optional[bool] = None,
                  fused_demap: Optional[bool] = None, geometry=None,
                  device="cuda") -> List:
    """The N-frame mixed-rate loopback: fused (default), staged
    (``fused=False``) or per frame (``batched_tx=False``), as the
    module docstring says. ``snr_db``/``cfo``/``delay`` are scalars or
    per-lane sequences (``np.inf`` SNR adds no noise); lane keys derive
    from ``seed`` by fold-in. ``channel_profile`` is a profile name, a
    per-lane sequence or None (ZIRIA_CHANNEL_PROFILE; all flat is the
    unprofiled channel). The decode knobs (``viterbi_window``,
    ``viterbi_metric``, ``viterbi_radix``, ``sco_track``,
    ``fused_demap``, or a ``geometry`` for those left None) pass to the
    receiver. Returns per-frame :class:`rx.RxResult`, equal lane for
    lane across the modes and to the reference's, on `device`."""
    n = len(psdus)
    if len(rates_mbps) != n:
        raise ValueError(f"{n} PSDUs but {len(rates_mbps)} rates")
    if n == 0:
        return []
    device = rx.check_device(device, "loopback_many")
    snr = _lane_param(snr_db, n, np.float32)
    eps = _lane_param(cfo, n, np.float32)
    dly = _lane_param(delay, n, np.int64)
    if (dly < 0).any():
        raise ValueError("negative delay")
    if geometry is not None:
        viterbi_window = (geometry.viterbi_window
                          if viterbi_window is None else viterbi_window)
        viterbi_metric = (geometry.viterbi_metric
                          if viterbi_metric is None else viterbi_metric)
        viterbi_radix = (geometry.viterbi_radix
                         if viterbi_radix is None else viterbi_radix)
        sco_track = geometry.sco_track if sco_track is None else sco_track
        fused_demap = (geometry.fused_demap
                       if fused_demap is None else fused_demap)
    knobs = dict(viterbi_window=viterbi_window,
                 viterbi_metric=viterbi_metric,
                 viterbi_radix=_check_radix(viterbi_radix),
                 sco_track=rx.sco_track_enabled(sco_track),
                 fused_demap=rx.fused_demap_enabled(fused_demap))
    prof_key = chanprof.resolve_profiles(channel_profile, n)
    tap_pad = 0 if prof_key is None else max(
        len(chanprof.get_profile(nm).taps) for nm in prof_key) - 1
    _sym_b, l_cap = _link_buckets(psdus, rates_mbps, add_fcs,
                                  int(dly.max()), tap_pad)
    if not batched_tx_enabled(batched_tx):
        out = []
        for i in range(n):
            s = tx.encode_frame(psdus[i], rates_mbps[i], add_fcs=add_fcs,
                                device=device)
            cap = channel.impair_one(
                s, snr[i], eps[i], int(dly[i]), seed, i, l_cap,
                profile=None if prof_key is None else prof_key[i],
                device=device)
            out.append(rx.receive(cap.cpu().numpy(), check_fcs=check_fcs,
                                  device=device, **knobs))
        return out
    geo = _LinkGeometry(psdus, rates_mbps, snr, eps, dly, add_fcs, tap_pad)
    prof_rows = None if prof_key is None else tuple(
        prof_key[i] for i in pad_lanes(list(range(n))))
    if fused_link_enabled(fused):
        return _loopback_fused(geo, seed, check_fcs, knobs, prof_rows,
                               device)
    return _loopback_staged(geo, seed, check_fcs, knobs, prof_rows, device)


def _link_captures(geo: _LinkGeometry, seed, prof_rows, device):
    """The batch's encode and channel: (rows, l_cap, 2) captures on
    `device`."""
    samples = tx.encode_prep(geo.prep, device)
    nv, snr, eps, dly = geo.channel_args(device)
    with dispatch.timed("channel.impair_many"):
        return channel.impair_many_graph(samples, nv, snr, eps, dly, seed,
                                         geo.l_cap, prof_rows)


def _loopback_staged(geo: _LinkGeometry, seed, check_fcs, knobs,
                     prof_rows, device) -> List:
    """The staged link: encode, channel, then ``receive_many_device``
    over the capture batch on the device."""
    caps = _link_captures(geo, seed, prof_rows, device)
    return framebatch.receive_many_device(caps, geo.n, check_fcs=check_fcs,
                                          device=device, **knobs)


def _fused_pass(geo: _LinkGeometry, seed, knobs, prof_rows, device):
    """The fused link's device pass, every step launched before any
    host read: encode, channel, acquire, classify, gather every row at
    the TX symbol bucket, the mixed decode at the TX geometry, the
    masked CRC. Returns (status, mbps, length, n_sym, clear, crc_ok)
    on `device`."""
    caps = _link_captures(geo, seed, prof_rows, device)
    sym_b = geo.sym_b
    with cplx.exact_fp32():
        nv = torch.full((caps.shape[0],), geo.l_cap, dtype=torch.int64,
                        device=device)
        with dispatch.timed("rx.acquire_many"):
            found, start, eps_hat, rb, ln, pk = rx.acquire_frame_graph(
                caps, nv, nv)
        status, mbps, length, nsym = rx.classify_acquire_graph(
            found, nv - start, rb, ln, pk)
        caps_pad = torch.nn.functional.pad(
            caps, (0, 0, 0, rx.FRAME_DATA_START + 80 * sym_b))
        with dispatch.timed("rx.gather"):
            segs = rx.gather_segment_graph(caps_pad, start, eps_hat,
                                           nv - start, sym_b)
        with dispatch.timed("rx.decode_mixed"):
            clear = rx.decode_data_mixed(
                segs, geo.ridx_b, [int(v) for v in geo.ndata_b], sym_b,
                knobs["viterbi_window"], knobs["viterbi_metric"],
                knobs["viterbi_radix"], sco_track=knobs["sco_track"],
                fused_demap=knobs["fused_demap"])
        nbits = torch.from_numpy(geo.nbits_b.astype(np.int64)).to(device)
        with dispatch.timed("rx.crc_many"):
            crc_ok = rx.crc_psdu_many_graph(clear, nbits)
    return status, mbps, length, nsym, clear, crc_ok


def _loopback_fused(geo: _LinkGeometry, seed, check_fcs, knobs,
                    prof_rows, device) -> List:
    """The fused link: :func:`_fused_pass`, one host read of the
    classification, then the per-lane results (:func:`_fused_results`).
    A decodable lane whose SIGNAL claims another header than the TX
    sent replays the batch through the staged link."""
    try:
        status, mbps, length, nsym, clear, crc_ok = resilience.guarded(
            "link.fused", _fused_pass, geo, seed, knobs, prof_rows, device)
        head = torch.stack([status, mbps, length, nsym]).cpu().numpy()
    except Exception as e:    # noqa: BLE001 - _degrade_or_raise decides
        _degrade_or_raise(e, device, "link.fused_degraded")
        return _loopback_staged(geo, seed, check_fcs, knobs, prof_rows,
                                device)
    dispatch.record_gauge("link.degraded_mode", 0.0)
    results = _fused_results(geo, head, clear, crc_ok if check_fcs
                             else None)
    if results is None:
        return _loopback_staged(geo, seed, check_fcs, knobs, prof_rows,
                                device)
    return results


def _fused_results(geo: _LinkGeometry, head, clear, crc_ok):
    """The fused link's per-lane :class:`rx.RxResult` from the host
    classification `head` (status, mbps, length, n_sym rows) and the
    device's decoded bits (one read; `crc_ok` None without the FCS
    check), or None when a decodable lane's SIGNAL disagrees with what
    the TX sent."""
    status, mbps, length, nsym = head
    results: List = [None] * geo.n
    clear_np = crc_np = None
    for i in range(geo.n):
        st = int(status[i])
        if st == rx.ACQ_FAIL:
            results[i] = rx.RxResult(False, 0, 0, np.zeros(0, np.uint8),
                                     None)
            continue
        m, ln = int(mbps[i]), int(length[i])
        if st == rx.ACQ_TRUNCATED:
            results[i] = rx.RxResult(False, m, ln, np.zeros(0, np.uint8),
                                     None)
            continue
        if (m != RATE_MBPS_ORDER[int(geo.ridx_b[i])]
                or 8 * ln != int(geo.nbits_b[i])
                or int(nsym[i]) != int(geo.n_sym[i])):
            return None
        if clear_np is None:
            clear_np = clear.cpu().numpy()
            crc_np = None if crc_ok is None else crc_ok.cpu().numpy()
        psdu = clear_np[i][N_SERVICE_BITS: N_SERVICE_BITS + 8 * ln]
        crc = None if crc_np is None else bool(crc_np[i])
        results[i] = rx.RxResult(True, m, ln, psdu, crc)
    return results


# ------------------------------------------------------- stream stimulus


def stream_many(psdus, rates_mbps: Sequence[int], gaps=None, snr_db=np.inf,
                cfo: float = 0.0, delay: int = 0, seed: int = 0,
                add_fcs: bool = False, tail: int = 2048,
                batched_tx: Optional[bool] = None, channel_profile=None,
                _lane: int = 0, device="cuda"):
    """A continuous multi-frame (n, 2) float32 stream, the streaming
    receivers' stimulus: N mixed-rate frames (``transmit_many``) at
    seeded gaps in [300, 600) (or `gaps`, N - 1 of them), `delay` idle
    samples first and `tail` last, then ``channel.impair_stream`` over
    the whole stream (CFO, AWGN at `snr_db` relative to frame power,
    the profile's faults; ``channel_profile`` None reads
    ZIRIA_CHANNEL_PROFILE). Returns (stream, true frame starts); under
    an ``sco`` profile the starts are the pre-resample positions."""
    n = len(psdus)
    prof_names = chanprof.resolve_profiles(channel_profile, 1)
    prof_name = None if prof_names is None else prof_names[0]
    if len(rates_mbps) != n:
        raise ValueError(f"{n} PSDUs but {len(rates_mbps)} rates")
    if n == 0:
        if np.isfinite(snr_db):
            raise ValueError("stream_many with zero frames has no "
                             "frame power to reference snr_db against;"
                             " synthesize noise directly")
        return (np.zeros((int(tail), 2), np.float32),
                np.zeros((0,), np.int64))
    frames = transmit_many(psdus, rates_mbps, add_fcs=add_fcs,
                           batched_tx=batched_tx, device=device)
    rng = np.random.default_rng(seed)
    if gaps is None:
        gaps = rng.integers(300, 600, size=max(n - 1, 0))
    gaps = np.asarray(gaps, np.int64)
    if gaps.shape[0] != n - 1:
        raise ValueError(f"{n} frames need {n - 1} gaps, "
                         f"got {gaps.shape[0]}")
    if n > 1 and (gaps < 0).any():
        raise ValueError("negative gap")
    if int(delay) < 0:
        raise ValueError("negative delay")
    starts = np.zeros(n, np.int64)
    pos = int(delay)
    for i, f in enumerate(frames):
        starts[i] = pos
        pos += f.shape[0] + (int(gaps[i]) if i < n - 1 else 0)
    stream = np.zeros((pos + int(tail), 2), np.float32)
    n_signal = 0
    for s, f in zip(starts, frames):
        stream[s: s + f.shape[0]] = f
        n_signal += f.shape[0]
    return (channel.impair_stream(stream, n_signal, snr_db, cfo, seed,
                                  profile=prof_name, lane=_lane,
                                  device=device), starts)


class ArrivalSpec(NamedTuple):
    """A seeded ragged-arrival shape for ``stream_many_multi``: slab
    sizes uniform in ``[slab_lo, slab_hi)`` samples and inter-arrival
    gaps in ``[gap_lo, gap_hi]`` ticks (0: the same tick). Each stream
    draws its own schedule from its folded seed."""
    slab_lo: int = 256
    slab_hi: int = 2048
    gap_lo: int = 0
    gap_hi: int = 2


def arrival_schedule(stream: np.ndarray, spec: ArrivalSpec,
                     seed: int) -> List:
    """Cut one stream into a seeded arrival schedule ``[(tick, slab),
    ...]``: ticks non-decreasing, the slabs concatenating back to the
    stream exactly."""
    if spec.slab_lo < 1 or spec.slab_hi <= spec.slab_lo:
        raise ValueError(
            f"arrival slab range [{spec.slab_lo}, {spec.slab_hi}) "
            f"is empty or non-positive")
    if spec.gap_lo < 0 or spec.gap_hi < spec.gap_lo:
        raise ValueError(
            f"arrival gap range [{spec.gap_lo}, {spec.gap_hi}] "
            f"is empty or negative")
    rng = np.random.default_rng(seed)
    out, pos, tick, n = [], 0, 0, int(stream.shape[0])
    while pos < n:
        k = int(rng.integers(spec.slab_lo, spec.slab_hi))
        out.append((tick, stream[pos: pos + k]))
        pos += k
        tick += int(rng.integers(spec.gap_lo, spec.gap_hi + 1))
    return out


def _stream_seed(seed: int, i: int) -> int:
    """Stream i's seed in ``stream_many_multi``: an affine map mod the
    prime 2^31 - 1, injective, so no stream's draws depend on the
    others."""
    return (int(seed) * 1000003 + 7919 * (int(i) + 1)) % (2 ** 31 - 1)


def stream_many_multi(psdus_per_stream, rates_per_stream, snr_db=np.inf,
                      cfo=0.0, delay=0, seed: int = 0, add_fcs: bool = False,
                      tail: int = 2048, gaps=None,
                      batched_tx: Optional[bool] = None,
                      arrival: Optional[ArrivalSpec] = None,
                      channel_profile=None, device="cuda"):
    """S streams, the multi-stream receiver's stimulus: stream i is
    ``stream_many(psdus_per_stream[i], rates_per_stream[i], ...)`` at
    the folded seed ``_stream_seed(seed, i)``. ``snr_db``/``cfo``/
    ``delay`` are scalars or per-stream; ``gaps`` None or S gap
    sequences; ``channel_profile`` a name or per-stream sequence.
    Returns (streams, starts_per_stream), and with ``arrival`` also
    each stream's seeded arrival schedule."""
    s = len(psdus_per_stream)
    if len(rates_per_stream) != s:
        raise ValueError(f"{s} streams of PSDUs but "
                         f"{len(rates_per_stream)} of rates")
    if gaps is not None and len(gaps) != s:
        raise ValueError(f"{s} streams need {s} gap sequences, "
                         f"got {len(gaps)}")
    prof_key = chanprof.resolve_profiles(channel_profile, s)
    snr = _lane_param(snr_db, s, np.float64)
    eps = _lane_param(cfo, s, np.float64)
    dly = _lane_param(delay, s, np.int64)
    streams, starts = [], []
    for i in range(s):
        st, sts = stream_many(
            psdus_per_stream[i], rates_per_stream[i],
            gaps=None if gaps is None else gaps[i],
            snr_db=float(snr[i]), cfo=float(eps[i]), delay=int(dly[i]),
            seed=_stream_seed(seed, i), add_fcs=add_fcs, tail=tail,
            batched_tx=batched_tx,
            # "flat", not None: the fleet already read the env default
            channel_profile="flat" if prof_key is None else prof_key[i],
            device=device)
        streams.append(st)
        starts.append(sts)
    if arrival is None:
        return streams, starts
    schedules = [arrival_schedule(streams[i], arrival,
                                  _stream_seed(seed, i) + 1)
                 for i in range(s)]
    return streams, starts, schedules


# ------------------------------------------------------------ BER sweeps


def _point_noisy(frames, seed: int, snr, pname):
    """One BER point's channel: AWGN at `snr` with keys split from
    `seed` (the lanes' keys do not depend on the other rates), or the
    profile's perfect-sync channel around the same AWGN."""
    keys = threefry.split(threefry.prng_key(seed, frames.device),
                          frames.shape[0])
    prof = None if pname is None else chanprof.get_profile(pname)
    if prof is None or prof.is_flat:
        return channel.awgn(keys, frames, snr)
    return channel.impair_profile_point_graph(frames, keys, snr, prof.name)


def loopback_ber_bits(psdus, rate_mbps: int, snr_db: float, seed: int,
                      batched_tx: Optional[bool] = None, profile=None,
                      sco_track: Optional[bool] = None,
                      device="cuda") -> np.ndarray:
    """Perfect-sync single-rate BER loopback: (B, n_bytes) PSDUs encoded
    together (``tx.encode_batch``; ``encode_frame`` a frame at a time
    with ``batched_tx=False``), AWGN with keys split from `seed`
    (``profile``: its multipath, SCO and drift before, its bursts
    after), the batched DATA decode. Returns the decoded PSDU bits
    (B, 8*n_bytes) uint8."""
    psdus = np.asarray(psdus, np.uint8)
    rate = RATES[rate_mbps]
    n_bytes = psdus.shape[1]
    n_sym = n_symbols(n_bytes, rate)
    names = chanprof.resolve_profiles(profile, 1, use_env=False)
    device = rx.check_device(device, "loopback_ber_bits")
    if batched_tx_enabled(batched_tx):
        frames = tx.encode_batch(psdus, rate_mbps, device=device)
    else:
        frames = torch.stack([tx.encode_frame(p, rate_mbps, device=device)
                              for p in psdus])
    with cplx.exact_fp32():
        with dispatch.timed("channel.awgn_batch"):
            noisy = _point_noisy(frames, seed, snr_db,
                                 None if names is None else names[0])
        with dispatch.timed("rx.decode_batch"):
            got, _ = rx.decode_data_batch(
                noisy, rate, n_sym, 8 * n_bytes,
                sco_track=rx.sco_track_enabled(sco_track))
    return got.cpu().numpy()


def _sweep_points(frames_by_rate, want, rates_key, n_bytes, snr_flat,
                  seed_flat, profiles_key, sco_track, device):
    """The sweep's device loop: every (snr, seed) point's error counts
    into one int32 buffer (points, n_profiles * n_rates), profile-major;
    no host read."""
    profs = profiles_key or (None,)
    errbuf = torch.zeros((len(snr_flat), len(profs) * len(rates_key)),
                         dtype=torch.int32, device=device)
    with cplx.exact_fp32():
        for p, (snr, seed) in enumerate(zip(snr_flat, seed_flat)):
            col = 0
            for pname in profs:
                for frames, m in zip(frames_by_rate, rates_key):
                    noisy = _point_noisy(frames, int(seed), float(snr),
                                         pname)
                    got, _ = rx.decode_data_batch(
                        noisy, RATES[m], n_symbols(n_bytes, RATES[m]),
                        8 * n_bytes, sco_track=sco_track)
                    errbuf[p, col] = (got != want).sum(dtype=torch.int32)
                    col += 1
    return errbuf


def sweep_ber(psdus, rates_mbps: Sequence[int], snr_grid: Sequence[float],
              seeds: Sequence[int], profiles: Optional[Sequence] = None,
              sco_track: Optional[bool] = None, device="cuda") -> np.ndarray:
    """A BER waterfall: every rate over every (snr, seed) point, each
    point the perfect-sync step of :func:`loopback_ber_bits` (the same
    split keys and ops), as one loop on the device into a preallocated
    int32 error buffer read once at the end. Returns int64 error counts
    (len(rates), len(snr_grid), len(seeds)); with ``profiles`` (profile
    names) (len(rates), len(profiles), len(snr_grid), len(seeds)), the
    ``"flat"`` column equal to the unprofiled sweep. Divide by
    ``psdus.shape[0] * 8 * psdus.shape[1]`` for the BER. The frames of
    each rate are encoded once."""
    psdus = np.asarray(psdus, np.uint8)
    if psdus.ndim != 2:
        raise ValueError("psdus must be (B, n_bytes)")
    n_bytes = psdus.shape[1]
    rates_key = tuple(int(m) for m in rates_mbps)
    profiles_key = None if profiles is None else tuple(
        chanprof.get_profile(p).name for p in profiles)
    if profiles_key == ():
        raise ValueError("profiles must be a non-empty sequence of "
                         "profile names, or None for the unprofiled "
                         "3-axis sweep")
    n_prof = 1 if profiles_key is None else len(profiles_key)
    device = rx.check_device(device, "sweep_ber")
    sco_track = rx.sco_track_enabled(sco_track)
    snrs = np.asarray(snr_grid, np.float32)
    seed_arr = np.asarray(seeds, np.int64)
    snr_flat = np.repeat(snrs, seed_arr.shape[0])      # snr major
    seed_flat = np.tile(seed_arr, snrs.shape[0])
    bits = np.stack(tx._host_psdu_bits(psdus, False))
    want = torch.from_numpy(bits).to(device)
    frames_by_rate = [tx.encode_batch(psdus, m, device=device)
                      for m in rates_key]

    def _shape(errs):
        errs = errs.reshape(snrs.shape[0], seed_arr.shape[0], n_prof,
                            len(rates_key))
        out = np.transpose(errs, (3, 2, 0, 1))
        return out[:, 0] if profiles_key is None else out

    try:
        errbuf = resilience.guarded(
            "link.sweep", _sweep_points, frames_by_rate, want, rates_key,
            n_bytes, snr_flat, seed_flat, profiles_key, sco_track, device)
        errs = errbuf.cpu().numpy().astype(np.int64)
    except Exception as e:    # noqa: BLE001 - _degrade_or_raise decides
        _degrade_or_raise(e, device, "link.sweep_degraded")
        return _shape(_sweep_ber_loop(psdus, rates_key, snr_flat,
                                      seed_flat, bits, profiles_key,
                                      sco_track, device))
    dispatch.record_gauge("link.degraded_mode", 0.0)
    return _shape(errs)


def _sweep_ber_loop(psdus, rates_key, snr_flat, seed_flat, bits,
                    profiles_key=None, sco_track: bool = False,
                    device="cuda") -> np.ndarray:
    """The sweep as a loop of :func:`loopback_ber_bits` over the same
    points (a host read a point): the count-for-count twin
    ``sweep_ber`` degrades to. Flat (points, n_prof * n_rates) counts,
    profile-major."""
    n_rates = len(rates_key)
    profs = profiles_key or (None,)
    errs = np.zeros((len(snr_flat), len(profs) * n_rates), np.int64)
    for p, (snr, seed) in enumerate(zip(snr_flat, seed_flat)):
        for pi, pname in enumerate(profs):
            for r, m in enumerate(rates_key):
                got = loopback_ber_bits(psdus, m, float(snr), int(seed),
                                        profile=pname, sco_track=sco_track,
                                        device=device)
                errs[p, pi * n_rates + r] = int((got != bits).sum())
    return errs


def sweep_ber_sharded(psdus, rates_mbps: Sequence[int],
                      snr_grid: Sequence[float], seeds: Sequence[int],
                      mesh=None, axis: str = "dp",
                      profiles: Optional[Sequence] = None,
                      sco_track: Optional[bool] = None) -> np.ndarray:
    """The sweep with its frame lanes sharded over a device mesh: not
    ported yet."""
    raise NotImplementedError(
        "sweep_ber_sharded is not ported yet (ROADMAP.md queue 1, item 5, "
        "'parallel/'); run sweep_ber on one device")
