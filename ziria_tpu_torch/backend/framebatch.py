"""Frame-batched and streaming library receivers (counterpart of
ziria_tpu/backend/framebatch.py: ``receive_many`` :210,
``_mixed_decode_tail`` :287, ``receive_many_device`` :344, the
single-stream receiver :405-1230 (``StreamReceiver``,
``receive_stream``), the S-stream fleet :1232-2041
(``MultiStreamReceiver``, ``receive_streams``) and the link's thin
re-exports ``transmit_many`` :2044 and ``loopback_many`` :2056)."""

from __future__ import annotations

import os
import time
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ziria_tpu_torch.ops import cplx, viterbi
from ziria_tpu_torch.phy.wifi import rx as _rx
from ziria_tpu_torch.phy.wifi.params import N_SERVICE_BITS, RATE_INDEX, \
    RATES
from ziria_tpu_torch.runtime import resilience
from ziria_tpu_torch.utils import dispatch, faults, telemetry
from ziria_tpu_torch.utils import geometry as _geometry
from ziria_tpu_torch.utils.dispatch import pad_lanes


def batched_acquire_enabled(batched_acquire=None) -> bool:
    """The ``batched_acquire`` knob: the explicit value, else the
    ZIRIA_BATCHED_ACQUIRE environment variable (default on)."""
    if batched_acquire is not None:
        return bool(batched_acquire)
    return os.environ.get("ZIRIA_BATCHED_ACQUIRE", "1") != "0"


def receive_many(captures: Sequence[Any], check_fcs: bool = False,
                 max_samples: int = 1 << 16, device="cuda", *,
                 viterbi_window: Optional[int] = None,
                 viterbi_metric: Optional[str] = None,
                 viterbi_radix: Optional[int] = None,
                 batched_acquire: Optional[bool] = None,
                 sco_track: Optional[bool] = None,
                 fused_demap: Optional[bool] = None) -> List[Any]:
    """N captures ((n, 2) float32 array-likes) -> N :class:`rx.RxResult`s,
    field for field the reference's ``receive_many``:

    1. acquire (``rx.acquire_many``): detect, LTS peak-pick, CFO,
       alignment and SIGNAL decode of every lane in one batch; the
       host parses the headers and picks one symbol bucket. With
       ``batched_acquire=False`` (or ZIRIA_BATCHED_ACQUIRE=0), the
       per-capture ``rx._acquire_frame`` instead;
    2. gather (``rx.gather_segments_many``, or ``rx._padded_segment``
       per capture): each decodable lane's data region at its own
       start, derotated by its own CFO;
    3. decode (``rx.decode_data_mixed``): every rate's front, then one
       Viterbi over the whole mixed-rate batch (the CUDA ACS and
       traceback kernels on the card) in the mode the knobs pick:
       ``viterbi_window`` (the windowed decode: the windows of every
       lane as one batch), ``viterbi_metric`` ("int16", "int8": the
       integer ACS kernels on per-frame quantized soft values),
       ``viterbi_radix`` (4: two steps per ACS iteration; None reads
       ZIRIA_VITERBI_RADIX); with ``fused_demap`` (or
       ZIRIA_FUSED_DEMAP=1) at float32 metrics and no window, one
       rate-independent front and the rate-switched fused kernel;
       ``sco_track`` (or ZIRIA_RX_SCO_TRACK=1) adds pilot phase-ramp
       tracking;
    4. with ``check_fcs``, the masked CRC of every lane.

    Runs on `device` ("cuda" by default; the tests pass "cpu", where
    the kernels' plain versions run)."""
    batched_acquire = batched_acquire_enabled(batched_acquire)
    sco_track = _rx.sco_track_enabled(sco_track)
    fused_demap = _rx.fused_demap_enabled(fused_demap)
    device = _rx.check_device(device, "receive_many")
    with cplx.exact_fp32():
        if batched_acquire:
            results, x_dev, acqs = _rx.acquire_many(captures, max_samples,
                                                    device)
        else:
            results, acqs = [None] * len(captures), []
            for i, s in enumerate(captures):
                res, acq = _rx._acquire_frame(s, max_samples, device)
                if acq is None:
                    results[i] = res
                else:
                    acqs.append((i, acq))
        if not acqs:
            return results
        # one common symbol bucket for the whole batch: shorter frames
        # carry zero-LLR erasures up to it
        n_sym_b = max(_geometry.sym_bucket(a.n_sym) for _i, a in acqs)
        padded = pad_lanes(acqs)
        if batched_acquire:
            segs = _rx.gather_segments_many(x_dev, [a for _i, a in padded],
                                            n_sym_b)
        else:
            segs = torch.stack([_rx._padded_segment(a, n_sym_b, device)
                                for _i, a in padded])
        return _mixed_decode_tail(acqs, padded, segs, n_sym_b, results,
                                  check_fcs, viterbi_window, viterbi_metric,
                                  viterbi_radix, sco_track, fused_demap)


def _mixed_decode_tail(acqs, padded, segs, n_sym_b: int,
                       results: List[Any], check_fcs: bool,
                       viterbi_window=None, viterbi_metric=None,
                       viterbi_radix=None, sco_track: bool = False,
                       fused_demap: bool = False):
    """The mixed-rate decode over the lane-padded segments, the
    batched FCS check when asked, and the per-lane PSDU slices.
    `acqs` is [(i, acq)] for the real lanes, `padded` the pad_lanes
    list `segs` was built from."""
    ridx = [RATE_INDEX[a.rate_mbps] for _i, a in padded]
    nbits = [a.n_sym * RATES[a.rate_mbps].n_dbps for _i, a in padded]
    with dispatch.timed("rx.decode_mixed"):
        clear_dev = _rx.decode_data_mixed(
            segs, ridx, nbits, n_sym_b, viterbi_window, viterbi_metric,
            viterbi._check_radix(viterbi_radix), sco_track=sco_track,
            fused_demap=fused_demap)
    crc_b = None
    if check_fcs:
        npsdu = torch.tensor([8 * a.length_bytes for _i, a in padded],
                             device=segs.device)
        with dispatch.timed("rx.crc_many"):
            crc_dev = _rx.crc_psdu_many_graph(clear_dev, npsdu)
        crc_b = crc_dev.cpu().numpy()
    clear = clear_dev.cpu().numpy()
    for k, (i, a) in enumerate(acqs):
        psdu = clear[k][N_SERVICE_BITS: N_SERVICE_BITS
                        + 8 * a.length_bytes]
        crc = bool(crc_b[k]) if check_fcs else None
        results[i] = _rx.RxResult(True, a.rate_mbps, a.length_bytes,
                                  psdu, crc)
    return results


def receive_many_device(x_dev, n_lanes: int, check_fcs: bool = False,
                        viterbi_window: Optional[int] = None,
                        viterbi_metric: Optional[str] = None,
                        viterbi_radix: Optional[int] = None,
                        sco_track: Optional[bool] = None,
                        fused_demap: Optional[bool] = None,
                        device="cuda") -> List[Any]:
    """Batched receive over a capture batch already on the device:
    x_dev (R, L, 2), R a power-of-two lane count (rows past `n_lanes`
    repeating row 0) and L a power-of-two capture bucket of at least
    512, every row's whole length its capture. Acquire, gather and the
    mixed decode as in :func:`receive_many`, field for field equal to
    it on the same padded captures. `x_dev` moves to `device` ("cuda"
    by default) if it is elsewhere."""
    device = _rx.check_device(device, "receive_many_device")
    x_dev = torch.as_tensor(x_dev, dtype=torch.float32, device=device)
    l_cap = int(x_dev.shape[1])
    if l_cap != _geometry.capture_bucket(l_cap):
        raise ValueError(
            f"capture length {l_cap} is not a power-of-two >= 512 "
            f"bucket; per-capture receive would pad to "
            f"{_geometry.capture_bucket(l_cap)} and the identity contract "
            f"needs identical geometry")
    nv = np.full((int(x_dev.shape[0]),), l_cap, np.int64)
    with cplx.exact_fp32():
        results, lanes = _rx.acquire_batch(x_dev, nv, nv, n_lanes)
        if not lanes:
            return results
        n_sym_b = max(_geometry.sym_bucket(a.n_sym) for _i, a in lanes)
        padded = pad_lanes(lanes)
        segs = _rx.gather_segments_many(x_dev, [a for _i, a in padded],
                                        n_sym_b)
        return _mixed_decode_tail(lanes, padded, segs, n_sym_b, results,
                                  check_fcs, viterbi_window, viterbi_metric,
                                  viterbi_radix,
                                  _rx.sco_track_enabled(sco_track),
                                  _rx.fused_demap_enabled(fused_demap))


# ------------------------------------------------------ streaming receiver
#
# An unbounded I/Q stream is cut into overlapping chunks of chunk_len
# samples, stride chunk_len - frame_len. Each chunk costs at most two
# steps: the scan (rx.stream_chunk_graph) and, when a lane is
# decodable, the fixed-geometry decode (rx.stream_decode_graph). Host
# state (tail samples, offset, frames emitted, dedupe set) carries
# across chunks, so every frame is owned by exactly one chunk and
# equals per-capture rx.receive of stream[start : start + frame_len].
# Chunk i is launched before chunk i-1 is drained; its small outputs
# go to the host in one copy started at launch.


def streaming_rx_enabled(streaming: Optional[bool] = None) -> bool:
    """The ``streaming`` knob: the explicit value, else the
    ZIRIA_STREAMING_RX environment variable (default on). Off runs the
    per-capture oracle over the same detected windows."""
    if streaming is not None:
        return streaming
    return os.environ.get("ZIRIA_STREAMING_RX", "1") != "0"


class StreamFrame(NamedTuple):
    """One emitted frame: `start` in stream coordinates and the
    `rx.RxResult` of per-capture ``rx.receive(stream[start : start +
    frame_len])``."""
    start: int
    result: Any


class StreamCarry(NamedTuple):
    """The cross-chunk carry: the not-yet-owned tail samples, the
    stream coordinate of their first sample, the frames emitted so far
    and the dedupe watermark."""
    tail: np.ndarray
    offset: int
    emitted: int
    watermark: int = 0


class StreamStats(NamedTuple):
    chunks: int                # chunk scans issued
    frames: int                # StreamFrames emitted
    overflow_chunks: int       # chunks reporting > K eligible plateaus
    max_in_flight: int         # high-water chunks in flight
    sanitized: int = 0         # non-finite samples zeroed (sanitize=True)
    quarantines: int = 0       # times the stream entered quarantine
    lane_blowups: int = 0      # per-window oracle decode blowups caught
    degraded: bool = False     # a step degraded to its twin


def _chunk_candidates(seen, off, own, starts, k: int):
    """Prune `seen` to the watermark `off`, then collect the chunk's
    owned, unseen (abs_start, lane row) candidates in stream order.
    Returns (pruned seen, candidates)."""
    seen = {s for s in seen if s >= off}
    cands = []
    for j in range(k):
        if not own[j]:
            continue
        abs_start = off + int(starts[j])
        if abs_start in seen:
            continue
        seen.add(abs_start)
        cands.append((abs_start, j))
    cands.sort()
    return seen, cands


def _slab_array(samples, name: str) -> np.ndarray:
    """A pushed slab as (n, 2) float32 I/Q pairs, or a ValueError
    naming the stream."""
    try:
        arr = np.asarray(samples, np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{name}: pushed slab is not float-convertible "
            f"((n, 2) I/Q sample pairs expected): {e}") from None
    if arr.size == 0:
        return arr.reshape(0, 2)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(
            f"{name}: pushed slab has shape {arr.shape}, want (n, 2) "
            f"I/Q sample pairs")
    return arr


class _LaneHealth:
    """Per-stream quarantine state, shared by both receivers:
    non-finite input poisons the lane at once, ``blowup_limit``
    per-window decode blowups poison it too; a poisoned lane scans with
    valid 0 (nothing found, its lanemates untouched) and rejoins after
    ``rejoin_after`` consecutive clean chunks."""

    __slots__ = ("blowup_limit", "rejoin_after", "quarantined", "clean",
                 "blowups", "quarantines")

    def __init__(self, blowup_limit: int = 2, rejoin_after: int = 3):
        self.blowup_limit = max(1, int(blowup_limit))
        self.rejoin_after = max(1, int(rejoin_after))
        self.quarantined = False
        self.clean = 0          # consecutive clean chunks in quarantine
        self.blowups = 0        # per-lane decode blowups
        self.quarantines = 0    # times this lane entered quarantine

    def poison(self) -> None:
        if not self.quarantined:
            self.quarantines += 1
            telemetry.count("resilience.quarantines")
        self.quarantined = True
        self.clean = 0

    def blowup(self) -> None:
        self.blowups += 1
        if self.blowups >= self.blowup_limit:
            self.poison()
            self.blowups = 0

    def step(self, dirty: bool) -> bool:
        """Advance one consumed chunk; True: it rides quarantined. A
        chunk's blowups arrive one drain after its step, so they are
        not reset here."""
        if dirty:
            self.clean = 0
            return self.quarantined
        if self.quarantined:
            self.clean += 1
            if self.clean >= self.rejoin_after:
                self.quarantined = False
                self.clean = 0
                self.blowups = 0
            return True
        return False


#: geometry keys that postdate shipped checkpoint blobs, with the
#: behavior a blob without them had
_LEGACY_GEOMETRY_DEFAULTS = {"sco_track": False, "fused_demap": False}


def _validate_checkpoint(st, mine: dict) -> None:
    """Refuse a checkpoint whose geometry fingerprint is absent,
    partial or different from the restoring receiver's."""
    geo = dict(st.geometry)
    for k_, v_ in _LEGACY_GEOMETRY_DEFAULTS.items():
        geo.setdefault(k_, v_)
    missing = [k_ for k_ in mine if k_ not in geo]
    if missing:
        raise resilience.CarryCheckpointError(
            f"checkpoint lacks geometry fields {missing}; "
            f"use StreamReceiver.checkpoint() (or pass the "
            f"receiver geometry to checkpoint_carry) so the "
            f"restore can be validated")
    bad = {k_: (geo[k_], mine[k_]) for k_ in mine if geo[k_] != mine[k_]}
    if bad:
        raise resilience.CarryCheckpointError(
            f"checkpoint geometry mismatch (checkpoint, "
            f"receiver): {bad}")


def _stream_geometry(r) -> dict:
    """The checkpoint's geometry fingerprint: everything a restoring
    receiver must match. The decode knobs are stored as the receiver
    holds them: viterbi_window and viterbi_metric as the caller left
    them (None when defaulted), the radix, sco_track and fused_demap
    resolved."""
    return {"chunk_len": r.chunk_len, "frame_len": r.frame_len,
            "k": r.k, "n_sym_bucket": r.n_sym_bucket,
            "check_fcs": bool(r.check_fcs),
            "threshold": r._threshold, "min_run": r._min_run,
            "dead_zone": r._dead_zone,
            "viterbi_window": r.viterbi_window,
            "viterbi_metric": r.viterbi_metric,
            "viterbi_radix": r.viterbi_radix,
            "sco_track": bool(r.sco_track),
            "fused_demap": bool(r.fused_demap)}


#: the chunk scan's per-lane outputs, in the order they travel to the
#: host (overflow rides as a k-wide row)
_CHUNK_FIELDS = ("own", "starts", "overflow", "found", "fstart", "eps",
                 "rb", "ln", "pk", "nv")


def _to_host(t):
    """Start the copy of device tensor `t` to the host. Returns (host
    tensor, event or None); read the tensor after
    :func:`_await_device`."""
    if t.device.type != "cuda":
        return t, None
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _await_device(done, timeout_s: Optional[float]) -> None:
    """Wait for `done` (an event or None). With a watchdog timeout the
    caller's thread polls the event and raises
    ``resilience.DispatchTimeout`` past it: a device that stops
    answering is never waited on for ever, and no other thread is
    involved."""
    if done is None:
        return
    if timeout_s is None:
        done.synchronize()
        return
    deadline = time.monotonic() + timeout_s
    while not done.query():
        if time.monotonic() > deadline:
            raise resilience.DispatchTimeout(
                f"DEADLINE_EXCEEDED: the device did not finish within "
                f"the {timeout_s}s watchdog")
        time.sleep(1e-4)


def _stage_chunk(outs):
    """Start the one host copy of a chunk scan's small outputs: every
    (S, k) field and the overflow flags, stacked as float64 (each value
    exact there). Returns (host tensor, event or None, segs); segs stay
    on the device for the decode."""
    *small, segs = outs
    k = small[0].shape[1]
    small[2] = small[2][:, None].expand(-1, k)
    return (*_to_host(torch.stack([t.to(torch.float64) for t in small])),
            segs)


def _pull_chunk(staged, timeout_s: Optional[float] = None):
    """Wait for a chunk's staged copy and read it: (own, starts,
    overflow, found, fstart, rb, ln, pk, nv, segs), each (S, k) on the
    host but overflow (S,) and segs (S, k, need_b, 2) on the device. A
    device fault of the chunk surfaces here, where callers re-run the
    chunk."""
    host, done, segs = staged
    _await_device(done, timeout_s)
    v = dict(zip(_CHUNK_FIELDS, host.numpy()))
    as_int = {f: v[f].astype(np.int64) for f in
              ("starts", "fstart", "rb", "ln", "nv")}
    return (v["own"] != 0, as_int["starts"], v["overflow"][:, 0] != 0,
            v["found"] != 0, as_int["fstart"], as_int["rb"], as_int["ln"],
            v["pk"] != 0, as_int["nv"], segs)


def _record_degraded(entered: bool) -> None:
    """The rx.degraded_mode gauge, and on entry the resilience.degraded
    counter."""
    dispatch.record_gauge("rx.degraded_mode", 1.0 if entered else 0.0)
    if entered:
        telemetry.count("resilience.degraded")


def _contained(e: BaseException, strict: bool) -> bool:
    """Whether failure `e` may degrade a receiver rather than raise.
    Off the card every failure may, as in the reference. On the card
    (`strict`) only an injected fault may: a real CUDA fault is sticky
    and a kernel that fails to build or launch must not be carried on
    with a plain version, so those raise."""
    if not strict:
        return True
    if isinstance(e, resilience.DispatchFailed):
        e = e.last
    return isinstance(e, faults.InjectedFault)


def _guarded_decode(r, label: str, dec, *args):
    """The guarded decode and its host read, in one transfer: a device
    fault (or the watchdog's timeout) surfaces at the read, so the read
    sits inside the same containment (one guarded re-run, then None
    with the receiver marked degraded; a failure :func:`_contained`
    refuses raises). Returns (clear, crc) as host arrays, or None."""
    for attempt in (0, 1):
        try:
            clear, crc = resilience.guarded(label, dec, *args,
                                            policy=r._policy)
            host, done = _to_host(
                torch.cat([clear, crc[..., None].to(torch.uint8)], -1))
            _await_device(done, r._policy.timeout_s)
            host = host.numpy()
            return host[..., :-1], host[..., -1] != 0
        except resilience.DispatchFailed as e:
            if not _contained(e, r._strict):
                raise
            break
        except Exception as e:   # noqa: BLE001 - fault at the read
            if not _contained(e, r._strict):
                raise
            if attempt:
                break
            telemetry.count("resilience.async_rescans")
    r._mark_degraded(scan=False)
    return None


def _gate_finite(arr: np.ndarray, name: str, sanitize: bool,
                 health: _LaneHealth):
    """Reject a slab with non-finite samples (an error naming the
    stream), or under ``sanitize`` zero them and quarantine the lane.
    Returns (arr, n_bad)."""
    if arr.size == 0:
        return arr, 0
    bad = ~np.isfinite(arr)
    if not bad.any():
        return arr, 0
    n_bad = int(bad.any(axis=-1).sum())
    if not sanitize:
        raise ValueError(
            f"{name}: pushed slab carries {n_bad} non-finite "
            f"sample(s); reject at the source or construct the "
            f"receiver with sanitize=True to zero-and-quarantine")
    arr = np.where(bad, np.float32(0), arr)
    health.poison()
    telemetry.count("resilience.sanitized", n_bad)
    return arr, n_bad


def _configure(r, who: str, geo: _geometry.Geometry, device, *,
               chunk_len, frame_len, max_frames_per_chunk, check_fcs,
               threshold, min_run, dead_zone, viterbi_window,
               viterbi_metric, viterbi_radix, sanitize, max_retries,
               watchdog_s, sco_track, fused_demap) -> None:
    """Resolve a stream's geometry and knobs (``geo``'s value for each
    one left None), check them, and set them on receiver `r`: the one
    place both receivers take their per-stream settings from, so a
    fleet lane runs exactly as a lone receiver."""
    chunk_len = geo.chunk_len if chunk_len is None else chunk_len
    frame_len = geo.frame_len if frame_len is None else frame_len
    max_frames_per_chunk = (geo.max_frames_per_chunk
                            if max_frames_per_chunk is None
                            else max_frames_per_chunk)
    threshold = geo.threshold if threshold is None else threshold
    min_run = geo.min_run if min_run is None else min_run
    dead_zone = geo.dead_zone if dead_zone is None else dead_zone
    viterbi_window = (geo.viterbi_window if viterbi_window is None
                      else viterbi_window)
    viterbi_metric = (geo.viterbi_metric if viterbi_metric is None
                      else viterbi_metric)
    viterbi_radix = (geo.viterbi_radix if viterbi_radix is None
                     else viterbi_radix)
    sco_track = geo.sco_track if sco_track is None else sco_track
    fused_demap = geo.fused_demap if fused_demap is None else fused_demap

    if frame_len != geo.capture_bucket(frame_len):
        raise ValueError(
            f"frame_len {frame_len} is not a power-of-two >= "
            f"{geo.capture_bucket_min} capture bucket; per-capture "
            f"receive would pad to {geo.capture_bucket(frame_len)} "
            f"and the identity contract needs identical geometry")
    if chunk_len <= frame_len:
        raise ValueError(
            f"chunk_len {chunk_len} must exceed the frame_len "
            f"{frame_len} overlap (the owned region would be empty)")
    r.device = _rx.check_device(device, who)
    r.chunk_len = int(chunk_len)
    r.frame_len = int(frame_len)
    r.stride = r.chunk_len - r.frame_len
    r.k = int(max_frames_per_chunk)
    # the largest DATA field a frame_len window holds, bucketed: the
    # stream's one decode geometry
    r.n_sym_bucket = geo.sym_bucket(
        max(1, (r.frame_len - _rx.FRAME_DATA_START) // 80))
    r.check_fcs = check_fcs
    r.viterbi_window = viterbi_window
    r.viterbi_metric = viterbi_metric
    r.viterbi_radix = viterbi._check_radix(viterbi_radix)
    r.sco_track = _rx.sco_track_enabled(sco_track)
    r.fused_demap = _rx.fused_demap_enabled(fused_demap)
    r._threshold = float(threshold)
    r._min_run = int(min_run)
    r._dead_zone = int(dead_zone)
    r.sanitize = bool(sanitize)
    r._policy = resilience.default_policy(max_retries=max_retries,
                                          timeout_s=watchdog_s)
    # on the card only an injected fault is contained (_contained)
    r._strict = r.device.type == "cuda"


class StreamReceiver:
    """Push-driven streaming receiver: feed sample slabs with
    :meth:`push`, close the stream with :meth:`flush`; both return the
    :class:`StreamFrame` s that became decodable.

    Geometry: `chunk_len` samples a scan with `frame_len` of overlap
    (`frame_len` a power-of-two capture bucket of at least 512 holding
    the longest frame), so a frame starting in a chunk's owned region
    (its first chunk_len - frame_len samples) lies inside that chunk.
    Up to `max_frames_per_chunk` (K) frames a chunk; more raises the
    chunk's overflow flag (counted in :class:`StreamStats`). ``geometry``
    supplies the default of every knob left None. ``checkpoint`` (a blob
    of :meth:`checkpoint`, of either package) resumes a stream.
    ``max_retries`` (None reads ZIRIA_MAX_RETRIES) and ``watchdog_s``
    set the guarded steps' policy (``resilience.default_policy``);
    ``blowup_limit`` and ``rejoin_after`` the quarantine's
    (:class:`_LaneHealth`). Runs on `device` ("cuda" by default; the
    tests pass "cpu")."""

    def __init__(self, chunk_len: Optional[int] = None,
                 frame_len: Optional[int] = None,
                 max_frames_per_chunk: Optional[int] = None,
                 check_fcs: bool = False,
                 threshold: Optional[float] = None,
                 min_run: Optional[int] = None,
                 dead_zone: Optional[int] = None,
                 viterbi_window: Optional[int] = None,
                 viterbi_metric: Optional[str] = None,
                 viterbi_radix: Optional[int] = None,
                 streaming: Optional[bool] = None,
                 sanitize: bool = False,
                 max_retries: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 blowup_limit: int = 2, rejoin_after: int = 3,
                 checkpoint: Optional[bytes] = None,
                 sco_track: Optional[bool] = None,
                 fused_demap: Optional[bool] = None,
                 geometry: Optional[_geometry.Geometry] = None,
                 device="cuda"):
        _configure(self, "StreamReceiver",
                   geometry if geometry is not None else _geometry.DEFAULT,
                   device, chunk_len=chunk_len, frame_len=frame_len,
                   max_frames_per_chunk=max_frames_per_chunk,
                   check_fcs=check_fcs, threshold=threshold,
                   min_run=min_run, dead_zone=dead_zone,
                   viterbi_window=viterbi_window,
                   viterbi_metric=viterbi_metric,
                   viterbi_radix=viterbi_radix, sanitize=sanitize,
                   max_retries=max_retries, watchdog_s=watchdog_s,
                   sco_track=sco_track, fused_demap=fused_demap)
        self.streaming = streaming_rx_enabled(streaming)
        self._health = _LaneHealth(blowup_limit, rejoin_after)
        self._dirty = False        # non-finite input since last chunk
        self._sanitized = 0
        self._lane_blowups = 0
        self._degraded = False        # decode -> per-capture twin
        self._scan_degraded = False   # scan -> its unguarded twin
        self._tail = np.zeros((0, 2), np.float32)
        self._offset = 0
        self._emitted = 0
        self._watermark = 0
        self._seen = set()
        self._pending = None       # (offset, host chunk, valid, own_hi,
        #                            staged outputs)
        self._inflight = 0
        self._chunks = 0
        self._overflow_chunks = 0
        self._max_in_flight = 0
        self._flushed = False
        if checkpoint is not None:
            st = resilience.restore_carry(checkpoint)
            _validate_checkpoint(st, self._geometry())
            self._tail = np.asarray(st.tail, np.float32)
            self._offset = int(st.offset)
            self._emitted = int(st.emitted)
            self._watermark = int(st.watermark)
            self._seen = set(st.seen)
            # a quarantined receiver must resume quarantined
            rs = st.state
            self._health.quarantined = bool(rs.get("quarantined", False))
            self._health.clean = int(rs.get("clean", 0))
            self._health.blowups = int(rs.get("blowups", 0))
            self._health.quarantines = int(rs.get("quarantines", 0))
            self._dirty = bool(rs.get("dirty", False))
            self._sanitized = int(rs.get("sanitized", 0))
            self._lane_blowups = int(rs.get("lane_blowups", 0))
            self._degraded = bool(rs.get("degraded", False))
            self._scan_degraded = bool(rs.get("scan_degraded", False))

    # -- state ----------------------------------------------------------

    @property
    def carry(self) -> StreamCarry:
        return StreamCarry(self._tail, self._offset, self._emitted,
                           self._watermark)

    @property
    def stats(self) -> StreamStats:
        return StreamStats(self._chunks, self._emitted,
                           self._overflow_chunks, self._max_in_flight,
                           self._sanitized, self._health.quarantines,
                           self._lane_blowups,
                           self._degraded or self._scan_degraded)

    def _geometry(self) -> dict:
        return _stream_geometry(self)

    def _runtime_state(self) -> dict:
        """Quarantine health, degraded flags and containment counters:
        the checkpoint's runtime state."""
        return {"quarantined": self._health.quarantined,
                "clean": self._health.clean,
                "blowups": self._health.blowups,
                "quarantines": self._health.quarantines,
                "dirty": self._dirty,
                "sanitized": self._sanitized,
                "lane_blowups": self._lane_blowups,
                "degraded": self._degraded,
                "scan_degraded": self._scan_degraded}

    def checkpoint(self):
        """Serialize the live stream state after draining the chunk in
        flight, whose frames are returned alongside. Returns
        ``(state_bytes, frames)``; ``StreamReceiver(checkpoint=
        state_bytes, ...)`` at the same geometry resumes with the same
        emissions as the uninterrupted run."""
        if self._flushed:
            raise RuntimeError("checkpoint after flush")
        out: List[StreamFrame] = []
        if self._pending is not None:
            pend, self._pending = self._pending, None
            out = self._drain(pend)
        return resilience.checkpoint_carry(
            self.carry, seen=self._seen, geometry=self._geometry(),
            state=self._runtime_state()), out

    # -- the push surface -----------------------------------------------

    def push(self, samples) -> List[StreamFrame]:
        """Append samples ((n, 2) float pairs) and scan every chunk
        that completes. Returns the frames emitted. A malformed slab
        raises; non-finite samples raise, or under ``sanitize=True``
        are zeroed and quarantine the stream."""
        if self._flushed:
            raise RuntimeError("push after flush")
        arr = _slab_array(samples, "stream")
        arr, _kinds = faults.corrupt_slab("rx.push", arr)
        arr, n_bad = _gate_finite(arr, "stream", self.sanitize,
                                  self._health)
        if n_bad:
            self._sanitized += n_bad
            self._dirty = True
        if arr.size:
            self._tail = np.concatenate([self._tail, arr], axis=0)

        out: List[StreamFrame] = []
        while self._tail.shape[0] >= self.chunk_len:
            q = self._health.step(self._dirty)
            self._dirty = False
            out += self._launch(self._tail[:self.chunk_len],
                                0 if q else self.chunk_len, self.stride)
            self._tail = self._tail[self.stride:]
            self._offset += self.stride
            dispatch.record_gauge("rx.stream_carry_depth",
                                  self._tail.shape[0])
        return out

    def flush(self) -> List[StreamFrame]:
        """Close the stream: scan the carried tail (zero-padded to the
        chunk length, owning every remaining start) and drain the chunk
        in flight. Idempotent."""
        if self._flushed:
            return []
        self._flushed = True
        out: List[StreamFrame] = []
        valid = self._tail.shape[0]
        if valid:
            q = self._health.step(self._dirty)
            self._dirty = False
            arr = np.zeros((self.chunk_len, 2), np.float32)
            arr[:valid] = self._tail
            out += self._launch(arr, 0 if q else valid, valid)
        if self._pending is not None:
            pend, self._pending = self._pending, None
            out += self._drain(pend)
        return out

    # -- chunk lifecycle ------------------------------------------------

    def _upload(self, arr, valid: int, off: int, own_hi: int):
        """A chunk and its (valid, own_lo, own_hi) on the device, as
        the scan's arguments. The stream's first chunk owns starts down
        to -192 (a head-truncated preamble, clamped to 0 as
        per-capture acquisition clamps it); on a later chunk a negative
        start is the previous chunk's frame."""
        own_lo = -192 if off == 0 else 0
        chunk = torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True)[None]
        lanes = torch.tensor([[valid], [own_lo], [own_hi]]).to(
            self.device, non_blocking=True)
        return (chunk, *lanes)

    def _scan(self, chunk, valid, own_lo, own_hi):
        with cplx.exact_fp32():
            return _rx.stream_chunk_graph(
                chunk, valid, own_lo, own_hi, self.k, self.frame_len,
                self.n_sym_bucket, self._threshold, self._min_run,
                self._dead_zone)

    def _launch(self, arr, valid: int, own_hi: int) -> List[StreamFrame]:
        """Launch chunk i's upload and scan, then drain chunk i-1.
        Returns chunk i-1's emissions."""
        staged = self._scan_dispatch(
            self._upload(arr, valid, self._offset, own_hi))
        dispatch.record_gauge(
            "rx.degraded_mode",
            1.0 if (self._degraded or self._scan_degraded) else 0.0)
        dispatch.record_gauge(
            "rx.quarantined_streams",
            1.0 if self._health.quarantined else 0.0)
        self._chunks += 1
        self._inflight += 1
        self._max_in_flight = max(self._max_in_flight, self._inflight)
        dispatch.record_gauge("rx.stream_inflight", self._inflight)
        pend, self._pending = self._pending, (self._offset, arr, valid,
                                              own_hi, staged)
        return self._drain(pend) if pend is not None else []

    def _scan_dispatch(self, chunk_args):
        """The guarded chunk scan, degrading to its unguarded twin
        when it fails for good. Returns the staged outputs."""
        if self._scan_degraded:
            return self._eager_chunk(*chunk_args)
        try:
            outs = resilience.guarded("rx.stream_chunk", self._scan,
                                      *chunk_args, policy=self._policy)
        except resilience.DispatchFailed as e:
            if not _contained(e, self._strict):
                raise
            self._mark_degraded(scan=True)
            return self._eager_chunk(*chunk_args)
        return _stage_chunk(outs)

    def _rescan(self, arr, valid: int, off: int, own_hi: int):
        """Re-run a chunk whose outputs were lost at the host read."""
        telemetry.count("resilience.async_rescans")
        return self._scan_dispatch(self._upload(arr, valid, off, own_hi))

    def _drain(self, pend) -> List[StreamFrame]:
        """Read a launched chunk's small outputs, run the host decision
        tree, and emit its frames: one decode of the decodable lanes,
        or per-capture ``rx.receive`` per window in the oracle mode."""
        off, arr, valid, own_hi, staged = pend
        timeout = self._policy.timeout_s
        try:
            got = _pull_chunk(staged, timeout)
        except Exception as e:   # noqa: BLE001 - lost outputs, re-run
            if not _contained(e, self._strict):
                raise
            got = _pull_chunk(self._rescan(arr, valid, off, own_hi), timeout)
        (own, starts, overflow, found, fstart, rb, ln, pk, nv,
         segs) = (v[0] for v in got)
        self._inflight -= 1
        if overflow:
            self._overflow_chunks += 1

        self._watermark = off
        self._seen, cands = _chunk_candidates(self._seen, off, own,
                                              starts, self.k)
        if not self.streaming or self._degraded:
            return self._decode_oracle(cands, starts, arr, valid)

        emit = {}
        # decodable lanes: (abs_start, lane row, rate, n_sym, length)
        lanes = []
        for abs_start, j in cands:
            avail = int(nv[j]) - int(fstart[j])
            res, ok = _rx._classify_acquire(
                bool(found[j]), avail, int(rb[j]), int(ln[j]), bool(pk[j]))
            if ok is None:
                emit[abs_start] = res
            else:
                lanes.append((abs_start, j, ok[0], ok[1], int(ln[j])))
        if lanes:
            # rows always pad to K (lane 0 repeated): one decode
            # geometry for every chunk of the stream
            def row_pad(vals):
                return list(vals) + [vals[0]] * (self.k - len(vals))

            rows = row_pad([j for _s, j, _m, _n, _lb in lanes])
            ridx = row_pad([RATE_INDEX[m] for _s, _j, m, _n, _lb in lanes])
            nbits = row_pad([n_sym * RATES[m].n_dbps
                             for _s, _j, m, n_sym, _lb in lanes])
            npsdu = row_pad([8 * lb for _s, _j, _m, _n, lb in lanes])
            got = _guarded_decode(self, "rx.stream_decode", self._decode,
                                  segs, rows, ridx, nbits, npsdu)
            if got is None:
                # the decode failed for good: the per-capture twin for
                # this chunk and the rest of the stream
                return self._decode_oracle(cands, starts, arr, valid)
            clear, crc = got
            for i, (abs_start, _j, m, _n, lb) in enumerate(lanes):
                psdu = clear[i][N_SERVICE_BITS: N_SERVICE_BITS + 8 * lb]
                emit[abs_start] = _rx.RxResult(
                    True, m, lb, psdu,
                    bool(crc[i]) if self.check_fcs else None)
        out = [StreamFrame(s, emit[s]) for s in sorted(emit)]
        self._emitted += len(out)
        self._note_emitted(len(out))
        return out

    def _decode(self, segs, rows, ridx, nbits, npsdu):
        with cplx.exact_fp32():
            return _rx.stream_decode_graph(
                segs, rows, ridx, nbits, npsdu, self.n_sym_bucket,
                self.viterbi_window, self.viterbi_metric,
                self.viterbi_radix, self.sco_track, self.fused_demap)

    def _decode_oracle(self, cands, starts, arr,
                       valid: int) -> List[StreamFrame]:
        """Per-capture ``rx.receive`` over the chunk's owned windows:
        the ``streaming=False`` oracle and the degraded decode. Under
        ``sanitize`` or degraded mode a window whose receive raises is
        counted (``resilience.lane_blowups``), dropped and charged to
        the stream's health; in the plain oracle the error propagates."""
        contain = self.sanitize or self._degraded or self._scan_degraded
        out: List[StreamFrame] = []
        for abs_start, j in cands:
            s = int(starts[j])
            win = arr[s: min(s + self.frame_len, valid)]
            try:
                res = _rx.receive(
                    win, check_fcs=self.check_fcs,
                    viterbi_window=self.viterbi_window,
                    viterbi_metric=self.viterbi_metric,
                    viterbi_radix=self.viterbi_radix,
                    sco_track=self.sco_track, device=self.device)
            except Exception as e:   # noqa: BLE001 - counted containment
                if not contain or not _contained(e, self._strict):
                    raise
                self._lane_blowups += 1
                self._health.blowup()
                telemetry.count("resilience.lane_blowups")
                continue
            out.append(StreamFrame(abs_start, res))
        self._emitted += len(out)
        self._note_emitted(len(out))
        return out

    def _eager_chunk(self, chunk, valid, own_lo, own_hi):
        """The degraded scan: the same graph outside the guard,
        labelled ``rx.stream_chunk.eager`` (a fault plan aimed at the
        guarded site never blocks it)."""
        with dispatch.timed("rx.stream_chunk.eager"):
            return _stage_chunk(self._scan(chunk, valid, own_lo, own_hi))

    def _mark_degraded(self, scan: bool) -> None:
        if scan:
            self._scan_degraded = True
        else:
            self._degraded = True
        _record_degraded(True)

    def reset_degraded(self) -> None:
        """Leave degraded mode: the next chunk tries the guarded steps
        again."""
        self._degraded = False
        self._scan_degraded = False
        _record_degraded(False)

    def _note_emitted(self, k: int) -> None:
        if k:
            telemetry.count("rx.stream_frames", k, total=self._emitted)


def receive_stream(samples, chunk_len: Optional[int] = None,
                   frame_len: Optional[int] = None,
                   max_frames_per_chunk: Optional[int] = None,
                   check_fcs: bool = False,
                   threshold: Optional[float] = None,
                   min_run: Optional[int] = None,
                   dead_zone: Optional[int] = None,
                   viterbi_window: Optional[int] = None,
                   viterbi_metric: Optional[str] = None,
                   viterbi_radix: Optional[int] = None,
                   streaming: Optional[bool] = None,
                   sco_track: Optional[bool] = None,
                   fused_demap: Optional[bool] = None,
                   geometry: Optional[_geometry.Geometry] = None,
                   device="cuda"):
    """Decode every frame of a long multi-frame stream ((n, 2) float32
    I/Q) through one :class:`StreamReceiver`. Returns ``(frames,
    stats)``: the position-ordered :class:`StreamFrame` s, each equal
    field for field to per-capture ``rx.receive(stream[start : start +
    frame_len], check_fcs=...)``, and the :class:`StreamStats`."""
    sr = StreamReceiver(chunk_len=chunk_len, frame_len=frame_len,
                        max_frames_per_chunk=max_frames_per_chunk,
                        check_fcs=check_fcs, threshold=threshold,
                        min_run=min_run, dead_zone=dead_zone,
                        viterbi_window=viterbi_window,
                        viterbi_metric=viterbi_metric,
                        viterbi_radix=viterbi_radix,
                        streaming=streaming, sco_track=sco_track,
                        fused_demap=fused_demap, geometry=geometry,
                        device=device)
    frames = sr.push(samples)
    frames += sr.flush()
    return frames, sr.stats


# ------------------------------------------------- S-stream fleet receiver
#
# S independent streams' chunks ride one scan on a leading stream axis
# (rx.multi_stream_chunk_graph) and every stream's decodable lanes one
# flattened decode (rx.stream_decode_multi_graph): at most two steps a
# chunk-step, whatever S is. A host packer fires a chunk-step when at
# least one stream has a full chunk; the others ride it as idle lanes
# with valid 0. Each stream steps through exactly the chunk boundaries
# of a lone StreamReceiver, with its ownership and dedupe, so the fleet
# emits what S lone receivers would, frame for frame.


def multi_stream_enabled(multi: Optional[bool] = None) -> bool:
    """The ``multi`` knob of :func:`receive_streams`: the explicit
    value, else the ZIRIA_MULTI_STREAM environment variable (default
    on; only "0" turns it off, which runs S lone receivers)."""
    if multi is not None:
        return multi
    return os.environ.get("ZIRIA_MULTI_STREAM", "1") != "0"


class MultiStreamStats(NamedTuple):
    streams: int               # S, the fleet width
    chunk_steps: int           # fleet scans issued (S lone receivers:
    #                            their chunks, summed)
    frames: int                # StreamFrames emitted, all streams
    overflow_chunks: int       # per-stream chunk overflow flags raised
    max_in_flight: int         # high-water chunk-steps in flight
    max_active_streams: int    # high-water streams carrying samples
    sanitized: int = 0         # non-finite samples zeroed, fleet-wide
    quarantines: int = 0       # quarantine entries, fleet-wide
    quarantined_streams: int = 0   # streams quarantined now
    lane_blowups: int = 0      # per-window decode blowups caught
    degraded: bool = False     # a fleet step degraded to its twin


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a stream axis sharded over a device mesh is not ported yet "
            "(ROADMAP.md queue 1, item 5, 'parallel/ and the mesh')")


class MultiStreamReceiver:
    """Push-driven S-stream receiver: feed one stream with :meth:`push`
    or a slab per stream with :meth:`push_many`, close with
    :meth:`flush`; each returns the ``(stream, StreamFrame)`` pairs
    that became decodable.

    The geometry and knobs are :class:`StreamReceiver`'s, applied per
    stream (``n_streams`` None takes ``geometry.n_streams``). One
    chunk-step is one (S, chunk_len, 2) upload and one scan, then, when
    any stream has a decodable frame, one flattened decode; chunk-step
    t is launched before t-1 is drained. Per-stream carries are
    :meth:`carry` and :attr:`carries`; a lane's :meth:`checkpoint` is
    exactly a lone receiver's, so blobs restore across the two
    receivers and the two packages. ``mesh`` raises
    NotImplementedError (not ported yet). Runs on `device` ("cuda" by
    default; the tests pass "cpu")."""

    def __init__(self, n_streams: Optional[int] = None,
                 chunk_len: Optional[int] = None,
                 frame_len: Optional[int] = None,
                 max_frames_per_chunk: Optional[int] = None,
                 check_fcs: bool = False,
                 threshold: Optional[float] = None,
                 min_run: Optional[int] = None,
                 dead_zone: Optional[int] = None,
                 viterbi_window: Optional[int] = None,
                 viterbi_metric: Optional[str] = None,
                 viterbi_radix: Optional[int] = None, mesh=None,
                 sanitize: bool = False,
                 max_retries: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 blowup_limit: int = 2, rejoin_after: int = 3,
                 sco_track: Optional[bool] = None,
                 fused_demap: Optional[bool] = None,
                 geometry: Optional[_geometry.Geometry] = None,
                 device="cuda"):
        _no_mesh(mesh)
        geo = geometry if geometry is not None else _geometry.DEFAULT
        n_streams = geo.n_streams if n_streams is None else n_streams
        if n_streams < 1:
            raise ValueError(f"n_streams {n_streams} must be >= 1")
        _configure(self, "MultiStreamReceiver", geo, device,
                   chunk_len=chunk_len, frame_len=frame_len,
                   max_frames_per_chunk=max_frames_per_chunk,
                   check_fcs=check_fcs, threshold=threshold,
                   min_run=min_run, dead_zone=dead_zone,
                   viterbi_window=viterbi_window,
                   viterbi_metric=viterbi_metric,
                   viterbi_radix=viterbi_radix, sanitize=sanitize,
                   max_retries=max_retries, watchdog_s=watchdog_s,
                   sco_track=sco_track, fused_demap=fused_demap)
        self.s = int(n_streams)
        self._health = [_LaneHealth(blowup_limit, rejoin_after)
                        for _ in range(self.s)]
        self._dirty = [False] * self.s
        self._sanitized = 0
        self._lane_blowups = 0
        self._degraded = False        # fleet decode -> per-capture twin
        self._scan_degraded = False   # fleet scan -> its unguarded twin
        self._tails = [np.zeros((0, 2), np.float32) for _ in range(self.s)]
        self._offsets = [0] * self.s
        self._emitted = [0] * self.s
        self._watermarks = [0] * self.s
        self._seen = [set() for _ in range(self.s)]
        self._pending = None   # (offsets, active, arrs, lanes, staged)
        self._inflight = 0
        self._chunk_steps = 0
        self._overflow_chunks = 0
        self._max_in_flight = 0
        self._max_active = 0
        self._retired = 0      # frames credited to recycled lanes
        self._flushed = False

    # -- state ----------------------------------------------------------

    def _check_stream(self, stream, exc=IndexError) -> int:
        """`stream` as a lane index, or `exc` naming the known ids."""
        if not (isinstance(stream, (int, np.integer))
                and 0 <= int(stream) < self.s):
            raise exc(
                f"unknown stream id {stream!r}: this fleet's known "
                f"ids are 0..{self.s - 1} ({self.s} streams)")
        return int(stream)

    def carry(self, stream: int) -> StreamCarry:
        """Stream `stream`'s live :class:`StreamCarry`."""
        stream = self._check_stream(stream)
        return StreamCarry(self._tails[stream], self._offsets[stream],
                           self._emitted[stream], self._watermarks[stream])

    @property
    def carries(self) -> List[StreamCarry]:
        return [self.carry(i) for i in range(self.s)]

    @property
    def stats(self) -> MultiStreamStats:
        return MultiStreamStats(
            self.s, self._chunk_steps, sum(self._emitted) + self._retired,
            self._overflow_chunks, self._max_in_flight, self._max_active,
            self._sanitized, sum(h.quarantines for h in self._health),
            sum(1 for h in self._health if h.quarantined),
            self._lane_blowups, self._degraded or self._scan_degraded)

    def quarantined(self, stream: int) -> bool:
        """True while `stream` rides with valid 0 (poisoned input or
        repeated decode blowups)."""
        return self._health[self._check_stream(stream)].quarantined

    def _lane_state(self, stream: int) -> dict:
        """A lane checkpoint's runtime state: its health and the
        fleet's degraded flags."""
        h = self._health[stream]
        return {"quarantined": h.quarantined, "clean": h.clean,
                "blowups": h.blowups, "quarantines": h.quarantines,
                "dirty": self._dirty[stream], "degraded": self._degraded,
                "scan_degraded": self._scan_degraded}

    def _lane_blob(self, stream: int) -> bytes:
        return resilience.checkpoint_carry(
            self.carry(stream), seen=self._seen[stream],
            geometry=_stream_geometry(self), state=self._lane_state(stream))

    def checkpoint(self, stream: int):
        """One lane's live state, after draining the chunk-step in
        flight (whose frames, of any stream, return alongside): ``(blob,
        (stream, frame) pairs)``. The blob restores into a lone
        ``StreamReceiver(checkpoint=...)`` or :meth:`restore_stream` at
        the same geometry."""
        if self._flushed:
            raise RuntimeError("checkpoint after flush")
        stream = self._check_stream(stream)
        out = self.drain_pending()
        return self._lane_blob(stream), out

    def checkpoint_fleet(self, lanes=None):
        """Every lane's state in one pass (the server's snapshot): the
        chunk-step in flight drains once, then ``({stream: blob},
        (stream, frame) pairs)`` for `lanes` (None: all S), each blob
        what :meth:`checkpoint` gives."""
        if self._flushed:
            raise RuntimeError("checkpoint after flush")
        out = self.drain_pending()
        which = range(self.s) if lanes is None \
            else [self._check_stream(i) for i in lanes]
        return {i: self._lane_blob(i) for i in which}, out

    # -- the push surface -----------------------------------------------

    def _ingest(self, stream: int, samples) -> None:
        """One stream's push seam: shape gate, the chaos seam (site
        ``rx.push.s<i>``), the non-finite gate, append."""
        name = f"stream {stream}"
        arr = _slab_array(samples, name)
        arr, _kinds = faults.corrupt_slab(f"rx.push.s{stream}", arr)
        arr, n_bad = _gate_finite(arr, name, self.sanitize,
                                  self._health[stream])
        if n_bad:
            self._sanitized += n_bad
            self._dirty[stream] = True
        if arr.size:
            self._tails[stream] = np.concatenate([self._tails[stream], arr])

    def push(self, stream: int, samples) -> List:
        """Append samples ((n, 2) float pairs) to one stream and fire
        every chunk-step that completes. Returns the emitted ``(stream,
        StreamFrame)`` pairs, of any stream. A malformed or non-finite
        slab raises naming the stream (under ``sanitize=True``
        non-finite samples are zeroed and quarantine it)."""
        if self._flushed:
            raise RuntimeError("push after flush")
        self._ingest(self._check_stream(stream), samples)
        return self._pump()

    def push_many(self, slabs) -> List:
        """Append one slab per stream, then fire: streams that filled a
        chunk together ride one chunk-step. ``slabs`` is a length-S
        sequence or a ``{stream: slab}`` dict (an unknown id raises a
        KeyError naming the known ones)."""
        if self._flushed:
            raise RuntimeError("push after flush")
        if isinstance(slabs, dict):
            items = [(self._check_stream(i, KeyError), a)
                     for i, a in slabs.items()]
        else:
            if len(slabs) != self.s:
                raise ValueError(f"{self.s} streams need {self.s} slabs, "
                                 f"got {len(slabs)}")
            items = list(enumerate(slabs))
        for i, a in items:
            self._ingest(i, a)
        return self._pump()

    def flush(self) -> List:
        """Close every stream: the carried tails (zero-padded, each
        owning every remaining start) as one last chunk-step, then the
        step in flight. Idempotent."""
        if self._flushed:
            return []
        out = self._pump()
        self._flushed = True
        active = [i for i in range(self.s) if self._tails[i].shape[0]]
        if active:
            out += self._step(active, flushing=True)
        return out + self.drain_pending()

    # -- per-lane lifecycle (the serving runtime's lane recycle) --------

    def drain_pending(self) -> List:
        """Drain the chunk-step in flight, if any; returns its
        ``(stream, frame)`` pairs."""
        if self._pending is None:
            return []
        pend, self._pending = self._pending, None
        return self._drain(pend)

    def flush_stream(self, stream: int) -> List:
        """Close one stream: its tail (zero-padded, owning every
        remaining start) as a chunk-step of its own, drained at once;
        the other lanes stay live. The lane is not reset
        (:meth:`reset_stream` recycles it)."""
        stream = self._check_stream(stream)
        if self._flushed:
            raise RuntimeError("flush_stream after flush")
        out = self.drain_pending()
        if self._tails[stream].shape[0]:
            out += self._step([stream], flushing=True)
            out += self.drain_pending()
        return out

    def reset_stream(self, stream: int) -> List:
        """Return one lane to a fresh stream (offset 0, empty tail and
        dedupe set, clean health) for a new session. Its frames stay
        counted in :attr:`stats`. Drains the step in flight only when
        the lane rides in it."""
        stream = self._check_stream(stream)
        rides = self._pending is not None and stream in self._pending[1]
        out = self.drain_pending() if rides else []
        h = self._health[stream]
        self._health[stream] = _LaneHealth(h.blowup_limit, h.rejoin_after)
        self._dirty[stream] = False
        self._retired += self._emitted[stream]
        self._tails[stream] = np.zeros((0, 2), np.float32)
        self._offsets[stream] = 0
        self._emitted[stream] = 0
        self._watermarks[stream] = 0
        self._seen[stream] = set()
        return out

    def restore_stream(self, stream: int, checkpoint: bytes) -> List:
        """Resume a checkpointed stream (a blob of :meth:`checkpoint` or
        of a lone receiver, either package) on lane `stream`, its
        quarantine state included; the blob's degraded flags describe
        the old fleet and do not carry over. Returns the pairs a reset
        drains."""
        stream = self._check_stream(stream)
        st = resilience.restore_carry(checkpoint)
        _validate_checkpoint(st, _stream_geometry(self))
        out = self.reset_stream(stream)
        self._tails[stream] = np.asarray(st.tail, np.float32)
        self._offsets[stream] = int(st.offset)
        self._emitted[stream] = int(st.emitted)
        # frames emitted before the checkpoint count where they were
        self._retired -= int(st.emitted)
        self._watermarks[stream] = int(st.watermark)
        self._seen[stream] = set(st.seen)
        rs, h = st.state, self._health[stream]
        h.quarantined = bool(rs.get("quarantined", False))
        h.clean = int(rs.get("clean", 0))
        h.blowups = int(rs.get("blowups", 0))
        h.quarantines = int(rs.get("quarantines", 0))
        self._dirty[stream] = bool(rs.get("dirty", False))
        return out

    # -- chunk-step lifecycle -------------------------------------------

    def _pump(self) -> List:
        out: List = []
        while True:
            active = [i for i in range(self.s)
                      if self._tails[i].shape[0] >= self.chunk_len]
            if not active:
                return out
            out += self._step(active, flushing=False)

    def _step(self, active, flushing: bool) -> List:
        """Pack one chunk-step over the `active` streams (the others
        ride zeros with valid 0), launch it, and advance the active
        streams' carries."""
        arrs = np.zeros((self.s, self.chunk_len, 2), np.float32)
        # rows: valid, own_lo, own_hi per stream
        lanes = np.zeros((3, self.s), np.int64)
        adv = {}
        for i in active:
            t = self._tails[i]
            if flushing:
                v = t.shape[0]
                arrs[i, :v] = t
                lanes[0, i] = lanes[2, i] = adv[i] = v
            else:
                arrs[i] = t[:self.chunk_len]
                lanes[0, i] = self.chunk_len
                lanes[2, i] = adv[i] = self.stride
            # a quarantined stream's chunk advances with valid 0
            if self._health[i].step(self._dirty[i]):
                lanes[0, i] = 0
            self._dirty[i] = False
            # a stream's first chunk owns head-truncated preambles
            lanes[1, i] = -192 if self._offsets[i] == 0 else 0
        res = self._launch(arrs, lanes, active, list(self._offsets))
        for i in active:
            self._tails[i] = self._tails[i][adv[i]:]
            self._offsets[i] += adv[i]
            dispatch.record_gauge(f"rx.stream_carry_depth[s{i}]",
                                  self._tails[i].shape[0])
        dispatch.record_gauge("rx.stream_carry_depth",
                              sum(t.shape[0] for t in self._tails))
        return res

    def _upload(self, arrs, lanes):
        """The chunk-step and its (3, S) lane table on the device, as
        the scan's arguments."""
        chunks = torch.from_numpy(arrs).to(self.device, non_blocking=True)
        lt = torch.from_numpy(lanes).to(self.device, non_blocking=True)
        return (chunks, *lt)

    def _scan(self, chunks, valid, own_lo, own_hi):
        with cplx.exact_fp32():
            return _rx.multi_stream_chunk_graph(
                chunks, valid, own_lo, own_hi, self.k, self.frame_len,
                self.n_sym_bucket, self._threshold, self._min_run,
                self._dead_zone)

    def _launch(self, arrs, lanes, active, offs) -> List:
        """Launch chunk-step t's upload and scan, then drain t-1.
        Returns t-1's emissions."""
        staged = self._scan_dispatch(self._upload(arrs, lanes))
        self._chunk_steps += 1
        self._inflight += 1
        self._max_in_flight = max(self._max_in_flight, self._inflight)
        self._max_active = max(self._max_active, len(active))
        dispatch.record_gauge("rx.stream_inflight", self._inflight)
        dispatch.record_gauge("rx.active_streams", len(active))
        dispatch.record_gauge(
            "rx.quarantined_streams",
            float(sum(1 for h in self._health if h.quarantined)))
        dispatch.record_gauge(
            "rx.degraded_mode",
            1.0 if (self._degraded or self._scan_degraded) else 0.0)
        pend, self._pending = self._pending, (offs, list(active), arrs,
                                              lanes, staged)
        return self._drain(pend) if pend is not None else []

    def _scan_dispatch(self, chunk_args):
        """The guarded fleet scan, degrading to its unguarded twin when
        it fails for good. Returns the staged outputs."""
        if self._scan_degraded:
            return self._eager_chunk(*chunk_args)
        try:
            outs = resilience.guarded("rx.stream_chunk_multi", self._scan,
                                      *chunk_args, policy=self._policy)
        except resilience.DispatchFailed as e:
            if not _contained(e, self._strict):
                raise
            self._mark_degraded(scan=True)
            return self._eager_chunk(*chunk_args)
        return _stage_chunk(outs)

    def _drain(self, pend) -> List:
        """Read a launched chunk-step's small outputs, run the host
        decision tree per active stream, and emit: one flattened decode
        when any stream has a decodable lane (an all-noise step skips
        it for the whole fleet)."""
        offs, active, arrs, lanes, staged = pend
        timeout = self._policy.timeout_s
        try:
            got = _pull_chunk(staged, timeout)
        except Exception as e:   # noqa: BLE001 - lost outputs, re-run
            if not _contained(e, self._strict):
                raise
            telemetry.count("resilience.async_rescans")
            got = _pull_chunk(self._scan_dispatch(self._upload(arrs, lanes)),
                              timeout)
        own, starts, overflow, found, fstart, rb, ln, pk, nv, segs = got
        self._inflight -= 1
        self._overflow_chunks += int(overflow[active].sum())

        cands = []           # (stream, abs_start, row j)
        for i in active:
            self._watermarks[i] = offs[i]
            self._seen[i], mine = _chunk_candidates(
                self._seen[i], offs[i], own[i], starts[i], self.k)
            cands += [(i, abs_start, j) for abs_start, j in mine]
        if self._degraded:
            return self._decode_oracle(cands, starts, arrs, lanes[0])

        emit = {}            # (stream, abs_start) -> RxResult
        slots = {}           # stream -> [(abs_start, rate, length)]
        # (S, K) rows, rate indices, bit counts and PSDU bit counts:
        # each stream's decodable lanes first, zeros after
        table = np.zeros((4, self.s, self.k), np.int64)
        for i, abs_start, j in cands:
            avail = int(nv[i, j]) - int(fstart[i, j])
            res, ok = _rx._classify_acquire(
                bool(found[i, j]), avail, int(rb[i, j]), int(ln[i, j]),
                bool(pk[i, j]))
            if ok is None:
                emit[(i, abs_start)] = res
                continue
            (m, n_sym), lb = ok, int(ln[i, j])
            sl = slots.setdefault(i, [])
            table[:, i, len(sl)] = (j, RATE_INDEX[m], n_sym * RATES[m].n_dbps,
                                    8 * lb)
            sl.append((abs_start, m, lb))
        if slots:
            got = _guarded_decode(self, "rx.stream_decode_multi",
                                  self._decode, segs, *table)
            if got is None:
                # the fleet decode failed for good: the per-capture
                # twin for this chunk-step and the rest of the run
                return self._decode_oracle(cands, starts, arrs, lanes[0])
            clear, crc = got
            for i, sl in slots.items():
                for pos, (abs_start, m, lb) in enumerate(sl):
                    psdu = clear[i, pos][N_SERVICE_BITS:
                                         N_SERVICE_BITS + 8 * lb]
                    emit[(i, abs_start)] = _rx.RxResult(
                        True, m, lb, psdu,
                        bool(crc[i, pos]) if self.check_fcs else None)
        out = []
        for i, abs_start in sorted(emit):
            out.append((i, StreamFrame(abs_start, emit[(i, abs_start)])))
            self._emitted[i] += 1
        if out:
            telemetry.count("rx.stream_frames", len(out),
                            total=sum(self._emitted))
        return out

    def _decode(self, segs, rows, ridx, nbits, npsdu):
        with cplx.exact_fp32():
            return _rx.stream_decode_multi_graph(
                segs, rows, ridx, nbits, npsdu, self.n_sym_bucket,
                self.viterbi_window, self.viterbi_metric,
                self.viterbi_radix, self.sco_track, self.fused_demap)

    def _decode_oracle(self, cands, starts, arrs, valid) -> List:
        """The fleet's per-capture twin (degraded mode): each owned
        window through ``rx.receive``. A window whose receive raises is
        counted, dropped and charged to its stream's health (off the
        card; on it, a failure :func:`_contained` refuses raises)."""
        out: List = []
        for i, abs_start, j in sorted(cands, key=lambda c: (c[0], c[1])):
            s = int(starts[i, j])
            win = arrs[i][s: min(s + self.frame_len, int(valid[i]))]
            try:
                res = _rx.receive(
                    win, check_fcs=self.check_fcs,
                    viterbi_window=self.viterbi_window,
                    viterbi_metric=self.viterbi_metric,
                    viterbi_radix=self.viterbi_radix,
                    sco_track=self.sco_track, device=self.device)
            except Exception as e:   # noqa: BLE001 - counted containment
                if not _contained(e, self._strict):
                    raise
                self._lane_blowups += 1
                self._health[i].blowup()
                telemetry.count("resilience.lane_blowups")
                continue
            out.append((i, StreamFrame(abs_start, res)))
            self._emitted[i] += 1
        if out:
            telemetry.count("rx.stream_frames", len(out),
                            total=sum(self._emitted))
        return out

    def _eager_chunk(self, chunks, valid, own_lo, own_hi):
        """The degraded scan: the same graph outside the guard,
        labelled ``rx.stream_chunk_multi.eager``."""
        with dispatch.timed("rx.stream_chunk_multi.eager"):
            return _stage_chunk(self._scan(chunks, valid, own_lo, own_hi))

    def _mark_degraded(self, scan: bool) -> None:
        if scan:
            self._scan_degraded = True
        else:
            self._degraded = True
        _record_degraded(True)

    def reset_degraded(self) -> None:
        """Leave degraded mode: the next chunk-step tries the guarded
        steps again."""
        self._degraded = False
        self._scan_degraded = False
        _record_degraded(False)


def receive_streams(streams, chunk_len: Optional[int] = None,
                    frame_len: Optional[int] = None,
                    max_frames_per_chunk: Optional[int] = None,
                    check_fcs: bool = False,
                    threshold: Optional[float] = None,
                    min_run: Optional[int] = None,
                    dead_zone: Optional[int] = None,
                    viterbi_window: Optional[int] = None,
                    viterbi_metric: Optional[str] = None,
                    viterbi_radix: Optional[int] = None,
                    multi: Optional[bool] = None, mesh=None,
                    sco_track: Optional[bool] = None,
                    fused_demap: Optional[bool] = None,
                    geometry: Optional[_geometry.Geometry] = None,
                    device="cuda"):
    """Decode S concurrent streams ((n, 2) float32 I/Q each) through
    one :class:`MultiStreamReceiver`: at most two steps a chunk-step,
    whatever S is. Returns ``(per-stream frames, MultiStreamStats)``,
    each stream's frames those of a lone :class:`StreamReceiver` on it.
    ``multi=False`` (or ZIRIA_MULTI_STREAM=0) runs S lone receivers
    instead. ``mesh`` raises NotImplementedError (not ported yet)."""
    _no_mesh(mesh)
    s = len(streams)
    if s == 0:
        return [], MultiStreamStats(0, 0, 0, 0, 0, 0)
    kw = dict(chunk_len=chunk_len, frame_len=frame_len,
              max_frames_per_chunk=max_frames_per_chunk,
              check_fcs=check_fcs, threshold=threshold, min_run=min_run,
              dead_zone=dead_zone, viterbi_window=viterbi_window,
              viterbi_metric=viterbi_metric, viterbi_radix=viterbi_radix,
              sco_track=sco_track, fused_demap=fused_demap,
              geometry=geometry, device=device)
    if not multi_stream_enabled(multi):
        per, chunks, frames, ovf, infl = [], 0, 0, 0, 0
        for st in streams:
            got, stats = receive_stream(np.asarray(st, np.float32), **kw)
            per.append(got)
            chunks += stats.chunks
            frames += stats.frames
            ovf += stats.overflow_chunks
            infl = max(infl, stats.max_in_flight)
        return per, MultiStreamStats(s, chunks, frames, ovf, infl,
                                     1 if chunks else 0)
    msr = MultiStreamReceiver(s, **kw)
    got = msr.push_many([np.asarray(st, np.float32) for st in streams])
    got += msr.flush()
    per = [[] for _ in range(s)]
    for i, fr in got:
        per[i].append(fr)
    return per, msr.stats


def transmit_many(psdus, rates_mbps, add_fcs: bool = False,
                  batched_tx: Optional[bool] = None,
                  device="cuda") -> List[np.ndarray]:
    """The batched TX surface beside ``receive_many`` (a re-export of
    ``phy/link.transmit_many``): N frames, returned at their true
    lengths; the per-frame loop under ``ZIRIA_BATCHED_TX=0``."""
    from ziria_tpu_torch.phy import link
    return link.transmit_many(psdus, rates_mbps, add_fcs=add_fcs,
                              batched_tx=batched_tx, device=device)


def loopback_many(psdus, rates_mbps, **kw) -> List[Any]:
    """The N-frame loopback (a re-export of ``phy/link.loopback_many``):
    fused by default, staged under ``fused=False`` or
    ``ZIRIA_FUSED_LINK=0``."""
    from ziria_tpu_torch.phy import link
    return link.loopback_many(psdus, rates_mbps, **kw)
