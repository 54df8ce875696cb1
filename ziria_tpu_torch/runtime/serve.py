"""Continuous-batching serving runtime: client sessions multiplexed onto
one fixed S-lane fleet (counterpart of ziria_tpu/runtime/serve.py:
``ServeConfig`` :90, ``AdmitResult``, ``SubmitResult``, ``ServeStats``,
``_Session``, ``ServeRuntime`` :244-1076, ``ClientSpec`` :1081,
``synth_load`` :1095, ``run_clients`` :1163 and ``main`` :1251, the
``serve`` subcommand).

- **Admission**: a session gets a free lane, waits in a bounded queue,
  or is rejected with a ``retry_after_s`` hint (scaled by the queue
  depth, jittered by a hash of (session, seed, attempt)).
- **Scheduling**: each :meth:`ServeRuntime.step` moves at most one
  chunk of each session's staged samples into its lane and fires one
  ``push_many``; the fleet dispatches a chunk-step for the lanes that
  filled, so sessions never enter the dispatch count (at most two a
  chunk-step).
- **Deadlines**: a session past its deadline is shed, counted and
  logged at a step boundary, from the injectable ``clock``.
- **Containment**: a NaN slab quarantines one lane; dispatch faults
  retry or degrade in the fleet (``runtime/resilience``).
- **Eviction**: :meth:`ServeRuntime.evict` returns the lane's
  checkpoint; ``connect(sid, checkpoint=blob)`` resumes it in any lane.
- **Durability**: with ``snapshot_dir`` every transition is journaled
  (``runtime/durability``) and the fleet snapshots every
  ``snapshot_every`` chunk-steps; :meth:`ServeRuntime.recover` rebuilds
  the server after a crash, onto fewer lanes if need be, and frames
  re-emitted before the journaled delivery marks are suppressed.

Every metric goes through the ``utils/telemetry`` registry, and
:meth:`ServeRuntime.scrape` is its Prometheus exposition. The receiver
is injectable; the default is a ``MultiStreamReceiver`` at the config's
geometry on `device` ("cuda" by default). ``ServeConfig.shard`` raises
NotImplementedError (not ported yet).
"""

from __future__ import annotations

import base64
import bisect
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ziria_tpu_torch.runtime import durability, resilience
from ziria_tpu_torch.utils import dispatch, faults, geometry as _geometry, \
    telemetry

_GEO = _geometry.DEFAULT


class ServeConfig(NamedTuple):
    """The server's fixed shape: the fleet geometry (the first five
    fields, defaults from ``utils.geometry.DEFAULT``) and the host
    protocol's bounds. :meth:`from_geometry` takes the fleet fields
    from a ``Geometry``."""
    n_lanes: int = _GEO.n_streams    # S: concurrent sessions on device
    chunk_len: int = _GEO.chunk_len
    frame_len: int = _GEO.frame_len
    max_frames_per_chunk: int = _GEO.max_frames_per_chunk
    check_fcs: bool = False
    queue_cap: int = 16              # admission queue bound
    max_slab_samples: int = 1 << 16  # oversized-slab reject bound
    max_backlog_samples: int = 1 << 18   # per-session staged bound
    default_slo_s: Optional[float] = None  # deadline = connect + slo
    retry_after_s: float = 0.05      # base backpressure hint
    sanitize: bool = True            # NaN slabs quarantine, not crash
    max_retries: Optional[int] = None    # guarded-dispatch budget
    watchdog_s: Optional[float] = None   # the guarded steps' watchdog
    blowup_limit: int = 2
    rejoin_after: int = 3
    snapshot_dir: Optional[str] = None   # journal + snapshots here
    snapshot_every: int = 0          # chunk-steps between snapshots
    snapshot_keep: int = 2
    journal_segment_records: int = 256
    jitter_seed: int = 0             # retry-after hint jitter seed
    shard: bool = False              # lanes over a device mesh

    @classmethod
    def from_geometry(cls, geo: "_geometry.Geometry",
                      **overrides: Any) -> "ServeConfig":
        """A config whose fleet fields come from ``geo``."""
        fields = dict(n_lanes=geo.n_streams, chunk_len=geo.chunk_len,
                      frame_len=geo.frame_len,
                      max_frames_per_chunk=geo.max_frames_per_chunk)
        fields.update(overrides)
        return cls(**fields)


class AdmitResult(NamedTuple):
    """:meth:`ServeRuntime.connect`'s answer: admitted, queued, or
    neither with a ``retry_after_s`` and a ``reason`` (``queue_full``,
    ``draining``, ``duplicate``)."""
    sid: Any
    admitted: bool
    queued: bool = False
    retry_after_s: float = 0.0
    reason: str = ""


class SubmitResult(NamedTuple):
    """:meth:`ServeRuntime.submit`'s answer: ``backlog_full`` with a
    retry hint is backpressure, ``oversized`` a protocol violation, and
    a terminal reason (``shed:<why>``, ``evicted``, ``closed``) a
    session that is gone."""
    sid: Any
    accepted: bool
    retry_after_s: float = 0.0
    reason: str = ""


class ServeStats(NamedTuple):
    """:meth:`ServeRuntime.stats`: the session accounting read from the
    registry's counters (``admitted == closed + shed of active sessions
    + evicted + active``; a queued session closed or evicted counts on
    ``serve.closed_queued`` / ``serve.evicted_queued``) and the fleet's
    chunk-steps."""
    admitted: int
    queued: int
    rejected_admissions: int
    rejected_slabs: int
    shed: int
    evicted: int
    restored: int
    closed: int
    frames: int
    chunk_steps: int
    active_sessions: int
    queue_depth: int
    quarantined_sessions: int
    shed_log: Tuple
    snapshots: int = 0
    restarts: int = 0
    deduped: int = 0
    journal_errors: int = 0


class _Session:
    __slots__ = ("sid", "lane", "staged", "staged_samples", "deadline",
                 "connected_t", "frames", "restore_blob", "slo_s",
                 "dedupe_until", "acked", "unacked")

    def __init__(self, sid, now: float, slo_s: Optional[float],
                 restore_blob: Optional[bytes]):
        self.sid = sid
        self.lane: Optional[int] = None
        self.staged: deque = deque()      # accepted, not yet scheduled
        self.staged_samples = 0
        self.connected_t = now
        self.slo_s = None if slo_s is None else float(slo_s)
        self.deadline = None if slo_s is None else now + float(slo_s)
        self.frames = 0                   # per-session emission index
        self.restore_blob = restore_blob
        # emissions with index <= dedupe_until were delivered before a
        # crash; acked is the stream coordinate durably consumed;
        # unacked holds (index, frame) emitted but not yet journaled
        self.dedupe_until = 0
        self.acked = 0
        self.unacked: List[Tuple[int, Any]] = []


def _slab(samples, sid) -> np.ndarray:
    """A submitted slab as (n, 2) float32 pairs, or a ValueError naming
    the session."""
    try:
        arr = np.asarray(samples, np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"session {sid!r}: submitted slab is not float-convertible "
            f"((n, 2) I/Q sample pairs expected): {e}") from None
    if arr.size == 0:
        return arr.reshape(0, 2)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(
            f"session {sid!r}: submitted slab has shape {arr.shape}, "
            f"want (n, 2) I/Q sample pairs")
    return arr


def _known(ids, cap: int = 16) -> str:
    ids = sorted(ids, key=repr)
    shown = ", ".join(repr(i) for i in ids[:cap])
    more = f", ... {len(ids) - cap} more" if len(ids) > cap else ""
    return f"[{shown}{more}]" if ids else "[] (none connected)"


class ServeRuntime:
    """The server. Single-threaded and deterministic: every admission,
    shed and eviction is a function of the call sequence and the
    ``clock``. Use as a context manager (it activates its registry for
    its lifetime and drains on exit)::

        with ServeRuntime(ServeConfig(check_fcs=True)) as srv:
            srv.connect("alice", slo_s=2.0)
            srv.submit("alice", slab)
            frames = srv.step()
        print(srv.scrape())

    ``receiver`` injects a fleet and is used as given; the default is a
    ``MultiStreamReceiver`` at the config's geometry on `device`."""

    def __init__(self, config: Optional[ServeConfig] = None,
                 receiver=None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 device="cuda"):
        self.cfg = config if config is not None else ServeConfig()
        if self.cfg.n_lanes < 1:
            raise ValueError(f"n_lanes {self.cfg.n_lanes} must be >= 1")
        self.clock = clock
        self.registry = registry if registry is not None \
            else telemetry.MetricsRegistry()
        self._rx = receiver if receiver is not None \
            else self._default_receiver(device)
        self._free = list(range(self.cfg.n_lanes))
        self._lane_sid: Dict[int, Any] = {}
        self._sessions: Dict[Any, _Session] = {}
        self._queue: deque = deque()
        self._gone: Dict[Any, str] = {}   # sid -> terminal reason
        self._spill: List = []            # (lane, frame) off-step
        self._shed_log: List[Tuple] = []
        self._steps_seen = 0
        self._draining = False
        self._drained = False
        self._cm = None
        self._rejects: Dict[Any, int] = {}   # sid -> reject attempts
        self._journal: Optional[durability.Journal] = None
        if self.cfg.snapshot_dir:
            self._journal = durability.Journal(
                os.path.join(self.cfg.snapshot_dir, "journal"),
                segment_records=self.cfg.journal_segment_records)
        self._marked: Dict[Any, int] = {}      # sid -> journaled mark
        self._pending_marks: Dict[Any, int] = {}
        # snapshot steps run on across restarts: recover() sets the base
        # to the recovered snapshot's step (the new fleet counts from 0)
        self._step_base = 0
        self._last_snap_step = 0
        self._last_snap_t: Optional[float] = None
        self.recovered: Dict[Any, dict] = {}   # recovery info per sid
        self.replayed: List[Tuple[Any, Any]] = []  # rider re-delivery

    def _default_receiver(self, device):
        from ziria_tpu_torch.backend import framebatch
        c = self.cfg
        if c.shard:
            raise NotImplementedError(
                "ServeConfig.shard (the lanes over a device mesh) is not "
                "ported yet (ROADMAP.md queue 1, item 5, 'parallel/ and "
                "the mesh')")
        return framebatch.MultiStreamReceiver(
            c.n_lanes, chunk_len=c.chunk_len, frame_len=c.frame_len,
            max_frames_per_chunk=c.max_frames_per_chunk,
            check_fcs=c.check_fcs, sanitize=c.sanitize,
            max_retries=c.max_retries, watchdog_s=c.watchdog_s,
            blowup_limit=c.blowup_limit, rejoin_after=c.rejoin_after,
            device=device)

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "ServeRuntime":
        self._cm = telemetry.collect(self.registry)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if not self._drained:
                self.drain()
        finally:
            cm, self._cm = self._cm, None
            cm.__exit__(*exc)

    # -- telemetry helpers ----------------------------------------------

    def _count(self, name: str, n: int = 1,
               labels: Optional[dict] = None) -> None:
        telemetry.count(name, n, labels=labels)

    def _counter_total(self, name: str) -> int:
        return sum(m.value for (n, _l), m in self.registry.metrics()
                   if n == name and isinstance(m, telemetry.CounterMetric))

    def _quarantined(self) -> int:
        return sum(1 for ln in self._lane_sid if self._rx.quarantined(ln))

    def _gauges(self) -> None:
        dispatch.record_gauge("serve.active_sessions", len(self._lane_sid))
        dispatch.record_gauge("serve.queue_depth", len(self._queue))
        dispatch.record_gauge("serve.quarantined_sessions",
                              self._quarantined())

    def _retry_after(self, sid=None) -> float:
        """The backpressure hint: base * (1 + queue depth) * (0.5 + 0.5
        u), u a hash of (sid, jitter seed, attempt), so synchronized
        rejects spread and a replay hints the same."""
        base = self.cfg.retry_after_s * (1 + len(self._queue))
        attempt = self._rejects.get(sid, 0)
        self._rejects[sid] = attempt + 1
        while len(self._rejects) > 4096:     # bounded under a flood
            self._rejects.pop(next(iter(self._rejects)))
        u = faults._unit(f"{sid!r}", self.cfg.jitter_seed, attempt)
        return base * (0.5 + 0.5 * u)

    # -- durability: the write-ahead journal ----------------------------

    def _j(self, ev: dict) -> None:
        """Append a journal record, best effort: a failed write is
        counted and serving goes on (the lost record only widens the
        recovery's dedupe window)."""
        if self._journal is None:
            return
        try:
            self._journal.append(ev)
        except OSError:
            self._count("serve.journal_errors")

    def _flush_marks(self) -> None:
        """Journal the delivery marks of what the previous public call
        returned. One call late on purpose: a mark written before the
        caller had the frames would, after a crash in between, dedupe
        away frames nobody got; late, the crash re-delivers them."""
        if not self._pending_marks:
            return
        marks, self._pending_marks = self._pending_marks, {}
        self._j({"ev": "mark", "d": {str(sid): n for sid, n in marks.items()}})
        for sid, n in marks.items():
            self._marked[sid] = n
            s = self._sessions.get(sid)
            if s is not None:
                while s.unacked and s.unacked[0][0] <= n:
                    s.unacked.pop(0)

    @staticmethod
    def _b64(blob: Optional[bytes]) -> Optional[str]:
        return None if blob is None else base64.b64encode(blob).decode()

    def scrape(self) -> str:
        """The registry's Prometheus exposition."""
        return self.registry.exposition()

    def stats(self) -> ServeStats:
        ct = self._counter_total
        return ServeStats(
            admitted=ct("serve.admitted"), queued=ct("serve.queued"),
            rejected_admissions=ct("serve.rejected_admissions"),
            rejected_slabs=ct("serve.rejected_slabs"),
            shed=ct("serve.shed"), evicted=ct("serve.evicted"),
            restored=ct("serve.restored"), closed=ct("serve.closed"),
            frames=ct("serve.frames"),
            chunk_steps=int(self._rx.stats.chunk_steps),
            active_sessions=len(self._lane_sid),
            queue_depth=len(self._queue),
            quarantined_sessions=self._quarantined(),
            shed_log=tuple(self._shed_log),
            snapshots=ct("serve.snapshots"), restarts=ct("serve.restarts"),
            deduped=ct("serve.deduped"),
            journal_errors=ct("serve.journal_errors"))

    # -- admission -------------------------------------------------------

    def connect(self, sid, slo_s: Optional[float] = None,
                checkpoint: Optional[bytes] = None) -> AdmitResult:
        """Admit a session: a free lane, the bounded queue, or a reject
        with a retry hint. ``slo_s`` sets its deadline (the config's
        default when None); ``checkpoint`` resumes an evicted session's
        blob in the lane it gets."""
        self._flush_marks()
        if self._draining or self._drained:
            self._count("serve.rejected_admissions",
                        labels={"reason": "draining"})
            return AdmitResult(sid, False, False, self._retry_after(sid),
                               "draining")
        if sid in self._sessions:
            return AdmitResult(sid, False, False, 0.0, "duplicate")
        now = self.clock()
        slo = slo_s if slo_s is not None else self.cfg.default_slo_s
        s = _Session(sid, now, slo, checkpoint)
        if not self._free and len(self._queue) >= self.cfg.queue_cap:
            # a rejected reconnect keeps its terminal record
            self._count("serve.rejected_admissions",
                        labels={"reason": "queue_full"})
            return AdmitResult(sid, False, False, self._retry_after(sid),
                               "queue_full")
        self._gone.pop(sid, None)      # a reconnect after shed or evict
        self._sessions[sid] = s
        if self._free:
            self._admit(s)
        else:
            self._queue.append(sid)
            self._count("serve.queued")
        self._j({"ev": "admit", "sid": sid, "slo": slo,
                 "ckpt": self._b64(checkpoint)})
        self._rejects.pop(sid, None)
        self._gauges()
        if s.lane is not None:
            return AdmitResult(sid, True)
        return AdmitResult(sid, False, True, 0.0, "queued")

    def _admit(self, s: _Session) -> None:
        lane = self._free.pop(0)
        s.lane = lane
        self._lane_sid[lane] = s.sid
        if s.restore_blob is not None:
            blob = s.restore_blob
            self._spill += self._rx.restore_stream(lane, blob)
            s.restore_blob = None
            try:
                st = resilience.restore_carry(blob)
                # the emission index resumes at the lane's; the client
                # resubmits from the coordinate the blob consumed
                s.frames = int(st.emitted)
                s.acked = int(st.offset) + int(st.tail.shape[0])
            except resilience.CarryCheckpointError:
                pass    # an injected receiver's own blob format
            self._count("serve.restored")
        self._marked.setdefault(s.sid, s.frames)
        self._count("serve.admitted")

    def _admit_waiting(self) -> None:
        while self._free and self._queue:
            self._admit(self._sessions[self._queue.popleft()])

    # -- ingress ---------------------------------------------------------

    def is_active(self, sid) -> bool:
        """True while ``sid`` holds a lane."""
        s = self._sessions.get(sid)
        return s is not None and s.lane is not None

    def _get_session(self, sid) -> _Session:
        s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"unknown session {sid!r}: known sessions are "
                           f"{_known(self._sessions)}")
        return s

    def submit(self, sid, samples) -> SubmitResult:
        """Stage one slab for ``sid``: an oversized slab
        (``max_slab_samples``) is refused, one past the session's
        staging bound (``max_backlog_samples``) refused with a retry
        hint; a gone session answers with its terminal reason, an
        unknown one raises a KeyError naming the known ones."""
        self._flush_marks()
        s = self._sessions.get(sid)
        if s is None:
            reason = self._gone.get(sid)
            if reason is not None:
                return SubmitResult(sid, False, 0.0, reason)
            self._get_session(sid)
        arr = _slab(samples, sid)
        n = int(arr.shape[0])
        if n > self.cfg.max_slab_samples:
            self._count("serve.rejected_slabs",
                        labels={"reason": "oversized"})
            return SubmitResult(sid, False, 0.0, "oversized")
        if s.staged_samples + n > self.cfg.max_backlog_samples:
            self._count("serve.rejected_slabs",
                        labels={"reason": "backlog_full"})
            return SubmitResult(sid, False, self._retry_after(sid),
                                "backlog_full")
        if n:
            s.staged.append(arr)
            s.staged_samples += n
        return SubmitResult(sid, True)

    # -- the scheduler tick ---------------------------------------------

    def _take_staged(self, s: _Session,
                     budget: int) -> Optional[np.ndarray]:
        """Up to `budget` samples of the session's staging, a slab that
        crosses it split (the receiver does not see slab boundaries)."""
        if not s.staged:
            return None
        take, got = [], 0
        while s.staged and got < budget:
            a = s.staged.popleft()
            need = budget - got
            if a.shape[0] > need:
                s.staged.appendleft(a[need:])
                a = a[:need]
            take.append(a)
            got += a.shape[0]
        s.staged_samples -= got
        return take[0] if len(take) == 1 else np.concatenate(take)

    def _emit(self, pairs) -> List[Tuple[Any, Any]]:
        """Map the fleet's (lane, frame) emissions to sessions,
        suppressing (and counting) those a crash already delivered."""
        out = []
        for lane, fr in pairs:
            sid = self._lane_sid.get(lane)
            if sid is None:        # lanes are drained before they free
                continue
            s = self._sessions[sid]
            s.frames += 1
            if s.frames <= s.dedupe_until:
                self._count("serve.deduped")
                continue
            s.unacked.append((s.frames, fr))
            self._pending_marks[sid] = s.frames
            out.append((sid, fr))
        if out:
            self._count("serve.frames", len(out))
        return out

    def _take_spill(self) -> List[Tuple[Any, Any]]:
        spill, self._spill = self._spill, []
        return self._emit(spill) if spill else []

    def _note_steps(self, dt: float) -> None:
        d = int(self._rx.stats.chunk_steps) - self._steps_seen
        if d <= 0:
            return
        self._steps_seen += d
        for _ in range(d):
            telemetry.observe("serve.chunk_seconds", dt / d)

    def _push(self, push: Dict[int, np.ndarray]) -> List:
        t0 = time.perf_counter()
        got = self._rx.push_many(push)
        self._note_steps(time.perf_counter() - t0)
        return self._emit(got)

    def step(self) -> List[Tuple[Any, Any]]:
        """One scheduler tick: shed the expired sessions, admit from the
        queue, move up to one chunk of each session's staging into its
        lane, and fire the fleet once. Returns the ``(sid,
        StreamFrame)`` pairs that became decodable."""
        if self._drained:
            raise RuntimeError("step after drain")
        self._flush_marks()
        out = self._take_spill()
        out += self._shed_expired()
        self._admit_waiting()
        push = {}
        for lane, sid in self._lane_sid.items():
            take = self._take_staged(self._sessions[sid], self.cfg.chunk_len)
            if take is not None:
                push[lane] = take
        if push:
            out += self._push(push)
        out += self._maybe_snapshot()
        self._gauges()
        return out

    # -- durability: snapshots + recovery -------------------------------

    def _maybe_snapshot(self) -> List[Tuple[Any, Any]]:
        """A snapshot every ``snapshot_every`` chunk-steps; between them
        the age gauges."""
        if self._journal is None or self.cfg.snapshot_every <= 0:
            return []
        steps = self._step_base + int(self._rx.stats.chunk_steps)
        if steps - self._last_snap_step < self.cfg.snapshot_every:
            if self._last_snap_t is not None:
                dispatch.record_gauge("serve.snapshot_age_s",
                                      self.clock() - self._last_snap_t)
                dispatch.record_gauge("serve.snapshot_age_steps",
                                      steps - self._last_snap_step)
            return []
        return self.snapshot()

    def snapshot(self) -> List[Tuple[Any, Any]]:
        """Write one atomic fleet snapshot: drain the chunk-step in
        flight (its emissions are returned), then persist every
        occupied lane's blob, the session table, the terminal reasons,
        the frames not yet marked delivered (the rider) and the journal
        watermark. A failed write is counted and the previous snapshot
        stays."""
        if self._journal is None:
            raise RuntimeError("snapshot without a snapshot_dir (set "
                               "ServeConfig.snapshot_dir)")
        lanes, got = self._rx.checkpoint_fleet(sorted(self._lane_sid))
        out = self._emit(got)
        now = self.clock()
        step = self._step_base + int(self._rx.stats.chunk_steps)
        sessions = []
        for sid in ([self._lane_sid[ln] for ln in sorted(self._lane_sid)]
                    + list(self._queue)):
            s = self._sessions[sid]
            sessions.append({
                "sid": sid, "lane": s.lane, "slo": s.slo_s,
                "slo_rem": None if s.deadline is None
                else max(0.0, s.deadline - now),
                "delivered": self._marked.get(sid, 0),
                "ckpt": self._b64(s.restore_blob)})
        rider, skipped = [], 0
        for sid, s in self._sessions.items():
            for idx, fr in s.unacked:
                try:
                    rider.append({"sid": sid, "idx": idx,
                                  "frame": durability.encode_frame(fr)})
                except Exception:    # noqa: BLE001 - an injected fleet's
                    skipped += 1     # frames need not be StreamFrames
        if skipped:
            self._count("serve.rider_skipped", skipped)
        body = {"config": dict(self.cfg._asdict()),
                "jseq": int(self._journal.seq), "sessions": sessions,
                "gone": [[sid, r] for sid, r in self._gone.items()],
                "rider": rider}
        try:
            durability.write_snapshot(self.cfg.snapshot_dir, step, lanes,
                                      body, keep=self.cfg.snapshot_keep)
        except OSError:
            self._count("serve.snapshot_errors")
            return out
        self._journal.prune(body["jseq"])
        self._last_snap_step = step
        self._last_snap_t = now
        self._count("serve.snapshots")
        dispatch.record_gauge("serve.snapshot_age_s", 0.0)
        dispatch.record_gauge("serve.snapshot_age_steps", 0)
        return out

    def acked(self, sid) -> int:
        """The stream coordinate durably consumed for ``sid``: after
        :meth:`recover` the client resubmits its stream from here."""
        return self._get_session(sid).acked

    @classmethod
    def recover(cls, snapshot_dir: str,
                config: Optional[ServeConfig] = None, receiver=None,
                clock: Callable[[], float] = time.monotonic,
                registry: Optional[telemetry.MetricsRegistry] = None,
                device="cuda") -> "ServeRuntime":
        """Rebuild a crashed server from its directory (written by
        either package): the newest valid snapshot, then the journal
        past its watermark, give the session table (later admissions
        fresh, shed, evicted and closed sessions gone with their
        reasons, delivery marks at the last durable one); every lane
        blob is restored into the new fleet and the snapshot's rider is
        re-delivered (``.replayed``). ``config`` overrides the
        snapshot's: with fewer ``n_lanes`` the sessions beyond them
        wait in the queue and restore as lanes free. ``.recovered``
        maps each live session to its ``acked`` coordinate and dedupe
        mark."""
        snap = durability.load_snapshot(snapshot_dir)
        base_seq = int(snap.body.get("jseq", 0)) if snap else 0
        events, rstats = durability.replay(
            os.path.join(snapshot_dir, "journal"), after_seq=base_seq)
        if config is None:
            if snap is None:
                raise ValueError(
                    f"{snapshot_dir}: no usable snapshot — journal-only "
                    f"recovery needs an explicit config")
            config = ServeConfig(**snap.body["config"])
        config = config._replace(snapshot_dir=snapshot_dir)

        # snapshot + journal -> the final session table
        live: Dict[Any, dict] = {}
        delivered: Dict[Any, int] = {}
        order: List[Any] = []
        by_str: Dict[str, Any] = {}
        gone: Dict[Any, str] = {}

        def note(sid):
            by_str[str(sid)] = sid
            if sid not in order:
                order.append(sid)

        if snap is not None:
            for ent in snap.body.get("sessions", []):
                sid = ent["sid"]
                blob = None
                if ent.get("lane") is not None:
                    blob = snap.lanes.get(int(ent["lane"]))
                elif ent.get("ckpt"):
                    blob = base64.b64decode(ent["ckpt"])
                live[sid] = {"slo": ent.get("slo"),
                             "slo_rem": ent.get("slo_rem"), "blob": blob}
                delivered[sid] = int(ent.get("delivered", 0))
                note(sid)
            gone.update({sid: r for sid, r in snap.body.get("gone", [])})
        for ev in events:
            k = ev.get("ev")
            if k == "admit":
                sid = ev["sid"]
                blob = base64.b64decode(ev["ckpt"]) if ev.get("ckpt") \
                    else None
                live[sid] = {"slo": ev.get("slo"), "slo_rem": None,
                             "blob": blob}
                delivered[sid] = max(delivered.get(sid, 0),
                                     int(ev.get("delivered", 0)))
                gone.pop(sid, None)
                note(sid)
            elif k == "mark":
                for key, n in ev.get("d", {}).items():
                    sid = by_str.get(key, key)
                    delivered[sid] = max(delivered.get(sid, 0), int(n))
            elif k in ("shed", "close", "evict"):
                sid = ev["sid"]
                live.pop(sid, None)
                gone[sid] = ev.get("reason", "closed" if k == "close"
                                   else "evicted")

        srv = cls(config, receiver=receiver, clock=clock,
                  registry=registry, device=device)
        if snap is not None:
            # the step and sequence lines go on past the recovered
            # snapshot, or a second crash would roll back to it
            srv._step_base = int(snap.step)
            srv._last_snap_step = int(snap.step)
            srv._journal.bump_seq(base_seq)
        now = srv.clock()
        with telemetry.collect(srv.registry):
            srv._count("serve.restarts")
            if rstats.dropped:
                srv._count("serve.journal_torn_drops", rstats.dropped)
            srv._gone.update(gone)
            marks: Dict[str, int] = {}
            for sid in order:
                ent = live.get(sid)
                if ent is None:
                    continue
                slo = ent["slo_rem"] if ent["slo_rem"] is not None \
                    else ent["slo"]
                s = _Session(sid, now, slo, ent["blob"])
                s.dedupe_until = delivered.get(sid, 0)
                if ent["blob"] is not None:
                    try:
                        st = resilience.restore_carry(ent["blob"])
                        s.acked = int(st.offset) + int(st.tail.shape[0])
                    except resilience.CarryCheckpointError:
                        pass
                srv._sessions[sid] = s
                srv._marked[sid] = delivered.get(sid, 0)
                if srv._free:
                    srv._admit(s)
                else:
                    # more live sessions than lanes: the rest wait
                    srv._queue.append(sid)
                    srv._count("serve.queued")
                srv._j({"ev": "admit", "sid": sid, "slo": slo,
                        "ckpt": srv._b64(ent["blob"]),
                        "delivered": delivered.get(sid, 0)})
                marks[str(sid)] = delivered.get(sid, 0)
                srv.recovered[sid] = {"acked": s.acked,
                                      "dedupe_until": s.dedupe_until,
                                      "active": s.lane is not None}
            if marks:
                srv._j({"ev": "mark", "d": marks})
            # frames emitted before the crash but never marked
            # delivered: re-delivered, at least once
            for entry in (snap.body.get("rider", []) if snap else []):
                sid = entry["sid"]
                if sid not in srv._sessions:
                    continue
                idx = int(entry["idx"])
                if idx <= delivered.get(sid, 0):
                    continue
                srv.replayed.append(
                    (sid, durability.decode_frame(entry["frame"])))
                srv._pending_marks[sid] = max(
                    srv._pending_marks.get(sid, 0), idx)
            if srv.replayed:
                srv._count("serve.replayed", len(srv.replayed))
            srv._gauges()
        return srv

    # -- deadlines / shedding -------------------------------------------

    def _shed_expired(self) -> List[Tuple[Any, Any]]:
        """Shed every session past its deadline, queued or active,
        counted under its reason and logged ``(sid, reason, t)``."""
        now = self.clock()
        out: List[Tuple[Any, Any]] = []
        for sid in [q for q in self._queue if self._expired(q, now)]:
            self._queue.remove(sid)
            del self._sessions[sid]
            self._shed(sid, "deadline_queued", now)
        for lane in [ln for ln, sid in self._lane_sid.items()
                     if self._expired(sid, now)]:
            out += self._release(self._lane_sid[lane],
                                 shed_reason="deadline", t=now)
        return out

    def _expired(self, sid, now: float) -> bool:
        d = self._sessions[sid].deadline
        return d is not None and now > d

    def _shed(self, sid, reason: str, t: float) -> None:
        self._gone[sid] = f"shed:{reason}"
        self._shed_log.append((sid, reason, t))
        self._j({"ev": "shed", "sid": sid, "reason": f"shed:{reason}"})
        self._count("serve.shed", labels={"reason": reason})

    def _release(self, sid, shed_reason: Optional[str] = None,
                 t: Optional[float] = None,
                 counted: Optional[str] = None) -> List:
        """Free a session's lane: drain what it rides in the step in
        flight, reset the lane, unmap it."""
        lane = self._sessions[sid].lane
        out = self._emit(self._rx.reset_stream(lane))
        del self._lane_sid[lane]
        bisect.insort(self._free, lane)
        del self._sessions[sid]
        if shed_reason is not None:
            self._shed(sid, shed_reason, t)
        elif counted is not None:
            self._gone[sid] = counted
            self._j({"ev": "close" if counted == "closed" else "evict",
                     "sid": sid, "reason": counted})
            self._count(f"serve.{counted}")
        return out

    def _drop_queued(self, sid, reason: str) -> None:
        """Close or evict a session that never left the queue, on its
        own counter (it was never admitted)."""
        self._queue.remove(sid)
        del self._sessions[sid]
        self._gone[sid] = reason
        self._j({"ev": "close" if reason == "closed" else "evict",
                 "sid": sid, "reason": reason})
        self._count(f"serve.{reason}_queued")

    # -- close / evict / drain ------------------------------------------

    def close(self, sid) -> List[Tuple[Any, Any]]:
        """End a session: push all it has staged, flush its lane, free
        the lane and admit the next queued session. Returns the
        emissions (of any session: the step in flight drains)."""
        self._flush_marks()
        s = self._get_session(sid)
        if s.lane is None:
            self._drop_queued(sid, "closed")
            return []
        out = []
        while True:
            take = self._take_staged(s, self.cfg.chunk_len)
            if take is None:
                break
            out += self._push({s.lane: take})
        t0 = time.perf_counter()
        got = self._rx.flush_stream(s.lane)
        self._note_steps(time.perf_counter() - t0)
        out += self._emit(got)
        out += self._release(sid, counted="closed")
        self._admit_waiting()
        self._gauges()
        return out

    def evict(self, sid) -> Tuple[Optional[bytes], List, List]:
        """Evict a session, keeping it: checkpoint its lane, free it,
        and return ``(blob, emissions, staged slabs)``; the client
        resubmits the slabs after ``connect(sid, checkpoint=blob)``. A
        queued session returns ``(None, [], staged)``."""
        self._flush_marks()
        s = self._get_session(sid)
        staged = list(s.staged)
        s.staged.clear()
        s.staged_samples = 0
        if s.lane is None:
            self._drop_queued(sid, "evicted")
            return None, [], staged
        blob, got = self._rx.checkpoint(s.lane)
        out = self._emit(got)
        out += self._release(sid, counted="evicted")
        self._admit_waiting()
        self._gauges()
        return blob, out, staged

    def drain(self) -> List[Tuple[Any, Any]]:
        """Shut down: stop admitting (queued sessions are shed with
        reason ``draining``), close every active session, flush the
        fleet and seal the journal. Idempotent; :meth:`stats` and
        :meth:`scrape` stay readable."""
        if self._drained:
            return []
        self._flush_marks()
        self._draining = True
        out = self._take_spill()
        now = self.clock()
        while self._queue:
            sid = self._queue.popleft()
            del self._sessions[sid]
            self._shed(sid, "draining", now)
        for sid in [self._lane_sid[ln] for ln in sorted(self._lane_sid)]:
            out += self.close(sid)
        out += self._emit(self._rx.flush())
        self._drained = True
        if self._journal is not None:
            self._flush_marks()
            self._journal.close()
        self._gauges()
        return out


# ---------------------------------------------------------- load driver


class ClientSpec(NamedTuple):
    """One client: an id, an arrival schedule ``[(tick, slab), ...]``,
    the stream it was cut from, an optional SLO, and a mode (``"ok"``,
    ``"nan"``, ``"flood"``, ``"stall"``: it sends half its schedule and
    goes silent, ``"oversize"``)."""
    sid: Any
    schedule: List
    stream: np.ndarray
    slo_s: Optional[float] = None
    mode: str = "ok"


def synth_load(n_sessions: int, frames_per_session: int = 3,
               n_bytes: int = 12, snr_db: float = 30.0, seed: int = 0,
               add_fcs: bool = True, tail: int = 1024, arrival=None,
               misbehave: Optional[Dict[int, str]] = None,
               slo_s: Optional[float] = None, channel_profile=None,
               device="cuda") -> List[ClientSpec]:
    """The many-client load generator: `n_sessions` mixed-rate streams
    (session i starts at the i-th rate) from ``link.stream_many_multi``
    (CFO 1e-4, 60 idle samples first, `snr_db`, the channel profile),
    cut into its seeded arrival schedules. ``misbehave`` maps session
    indices to a bad-client mode: ``"nan"`` (every 7th sample of the
    middle slab NaN), ``"flood"`` (the whole stream at tick 0 in
    16,384-sample slabs), ``"stall"`` (the first half of the schedule,
    then silence) or ``"oversize"`` (one 2^20-sample slab first).
    Deterministic per seed; the streams are made on `device`."""
    from ziria_tpu_torch.phy import link
    from ziria_tpu_torch.phy.wifi.params import RATES

    if arrival is None:
        arrival = link.ArrivalSpec()
    misbehave = dict(misbehave or {})
    rng = np.random.default_rng(seed)
    rates_all = sorted(RATES)
    psdus_per, rates_per = [], []
    for i in range(n_sessions):
        rates = [rates_all[(i + j) % len(rates_all)]
                 for j in range(frames_per_session)]
        rates_per.append(rates)
        psdus_per.append([rng.integers(0, 256, n_bytes).astype(np.uint8)
                          for _ in rates])
    streams, _starts, schedules = link.stream_many_multi(
        psdus_per, rates_per, snr_db=snr_db, cfo=1e-4, delay=60, seed=seed,
        add_fcs=add_fcs, tail=tail, arrival=arrival,
        channel_profile=channel_profile, device=device)
    out = []
    for i in range(n_sessions):
        mode = misbehave.get(i, "ok")
        sched = schedules[i]
        if mode == "flood":
            whole = streams[i]
            sched = [(0, whole[a: a + (1 << 14)])
                     for a in range(0, whole.shape[0], 1 << 14)]
        elif mode == "stall":
            sched = sched[: max(1, len(sched) // 2)]
        elif mode == "nan":
            j = len(sched) // 2
            t, bad = sched[j]
            bad = np.array(bad, copy=True)
            bad[:: 7] = np.nan
            sched = sched[:j] + [(t, bad)] + sched[j + 1:]
        elif mode == "oversize":
            t0 = sched[0][0] if sched else 0
            sched = [(t0, np.zeros((1 << 20, 2), np.float32))] + sched
        elif mode != "ok":
            raise ValueError(f"unknown misbehave mode {mode!r}")
        out.append(ClientSpec(f"s{i}", sched, streams[i], slo_s, mode))
    return out


def run_clients(srv: ServeRuntime, clients: List[ClientSpec],
                max_ticks: int = 10000) -> Dict[Any, List]:
    """Drive clients against a server tick by tick: connect everyone
    (a rejected client retries each tick), submit each schedule's due
    slabs (resubmitting on backpressure), step, close the clients whose
    schedule is done (a stalled client never closes), then drain. A
    session the server recovered resumes its schedule from
    ``srv.acked``. Returns ``{sid: [StreamFrame, ...]}``."""
    frames: Dict[Any, List] = {c.sid: [] for c in clients}

    def collect(pairs):
        for sid, fr in pairs:
            frames[sid].append(fr)

    # a recovered server re-delivers its snapshot's rider first
    collect((sid, fr) for sid, fr in srv.replayed if sid in frames)

    todo = {c.sid: deque(c.schedule) for c in clients}
    pending = {c.sid: c for c in clients}       # not yet connected
    unclosed = {c.sid: c for c in clients}

    def fast_forward(sid):
        skip = srv.acked(sid)
        q = todo[sid]
        while q and skip > 0:
            t, slab = q[0]
            n = slab.shape[0]
            if n <= skip:
                q.popleft()
                skip -= n
            else:
                q[0] = (t, slab[skip:])
                skip = 0

    tick = 0
    while tick <= max_ticks:
        for sid in list(pending):
            r = srv.connect(sid, slo_s=pending[sid].slo_s)
            if r.admitted or r.queued:
                del pending[sid]
            elif r.reason == "duplicate":
                fast_forward(sid)          # a recovered session
                del pending[sid]
        for c in clients:
            if c.sid in pending:
                continue
            q = todo[c.sid]
            while q and q[0][0] <= tick:
                r = srv.submit(c.sid, q[0][1])
                if r.accepted or not r.retry_after_s:
                    q.popleft()     # accepted, or refused for good
                else:
                    break           # backpressure: again next tick
        collect(srv.step())
        for done in [s for s, c in unclosed.items()
                     if c.mode != "stall" and not todo[s]
                     and s not in pending]:
            if srv.is_active(done):
                collect(srv.close(done))
                del unclosed[done]
            elif done in srv._gone:
                del unclosed[done]   # shed or evicted
        tick += 1
        if not unclosed and not any(todo.values()):
            break
        if all(c.mode == "stall" for c in unclosed.values()) \
                and not any(todo[s] for s in unclosed) and not pending:
            break
    collect(srv.drain())
    return frames


def main(argv=None) -> int:
    """``python -m ziria_tpu_torch serve``: a synthetic many-client load
    (``synth_load``) through the real fleet, on the card unless
    ``--platform=cpu``. A ^C drains the server and still prints the
    report: one JSON line (sessions, lanes, frames, ``stats()`` and the
    chunk-step latency summary), and with ``--metrics-dump`` the
    exposition on stderr."""
    import argparse
    import contextlib
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="ziria_tpu_torch serve",
        description="continuous-batching serving demo on the port's "
                    "MultiStreamReceiver")
    p.add_argument("--lanes", type=int, default=4,
                   help="device lanes S (the fleet width)")
    p.add_argument("--sessions", type=int, default=6,
                   help="client sessions to serve")
    p.add_argument("--frames", type=int, default=2,
                   help="frames per session")
    p.add_argument("--chunk-len", type=int, default=4096)
    p.add_argument("--frame-len", type=int, default=1024)
    p.add_argument("--slo", type=float, default=None,
                   help="per-session deadline seconds (default none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nan-client", action="store_true",
                   help="make session 0 push a NaN-poisoned slab "
                        "(quarantine demo)")
    p.add_argument("--chaos", metavar="SPEC", default=None,
                   help="fault-injection spec (utils/faults grammar)")
    p.add_argument("--channel-profile", metavar="NAME[,NAME...]",
                   default=None,
                   help="channel profile(s) of the client load "
                        "(phy/profiles; a comma list cycles per session)")
    p.add_argument("--metrics-dump", action="store_true",
                   help="print the Prometheus exposition to stderr at "
                        "exit")
    p.add_argument("--snapshot-dir", metavar="DIR", default=None,
                   help="durability directory: write-ahead journal and "
                        "fleet snapshots (--recover resumes from it)")
    p.add_argument("--snapshot-every", type=int, default=8, metavar="N",
                   help="chunk-steps between snapshots (with "
                        "--snapshot-dir; default 8)")
    p.add_argument("--recover", action="store_true",
                   help="recover the fleet from --snapshot-dir instead "
                        "of starting fresh")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the fleet runs: the card (default) or the "
                        "CPU; with no card it raises unless "
                        "--platform=cpu is given")
    args = p.parse_args(argv)

    if args.recover and not args.snapshot_dir:
        raise SystemExit("--recover needs --snapshot-dir")
    from ziria_tpu_torch.phy.wifi.rx import check_device
    device = check_device(args.platform, "serve --platform")
    cfg = ServeConfig(n_lanes=args.lanes, chunk_len=args.chunk_len,
                      frame_len=args.frame_len, check_fcs=True,
                      default_slo_s=args.slo,
                      snapshot_dir=args.snapshot_dir,
                      snapshot_every=args.snapshot_every)
    misbehave = {0: "nan"} if args.nan_client else {}
    if args.channel_profile is not None:
        from ziria_tpu_torch.phy.profiles import parse_profile_spec
        try:
            parse_profile_spec(args.channel_profile)
        except ValueError as e:
            raise SystemExit(f"--channel-profile: {e}")
    clients = synth_load(args.sessions, args.frames, seed=args.seed,
                         misbehave=misbehave, tail=args.frame_len,
                         channel_profile=args.channel_profile,
                         device=device)
    chaos = None
    if args.chaos is not None:
        try:
            chaos = faults.parse_chaos_spec(args.chaos)
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")

    srv = ServeRuntime.recover(args.snapshot_dir, config=cfg,
                               device=device) \
        if args.recover else ServeRuntime(cfg, device=device)
    frames: Dict[Any, List] = {}
    try:
        with contextlib.ExitStack() as stack:
            if chaos is not None:
                specs, seed = chaos
                stack.enter_context(faults.inject(*specs, seed=seed))
            stack.enter_context(srv)
            try:
                frames = run_clients(srv, clients)
            except KeyboardInterrupt:
                # drain: stop admitting, flush what is in flight, fall
                # through to the report
                srv.drain()
                frames = {}
    finally:
        st = srv.stats()
        lat = srv.registry.find("serve.chunk_seconds")
        report = {
            "sessions": args.sessions, "lanes": args.lanes,
            "frames": sum(len(v) for v in frames.values()),
            "stats": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in st._asdict().items()},
            "chunk_latency_ms": lat.summary(scale=1e3)
            if lat is not None else {"count": 0},
        }
        print(json.dumps(report))
        if args.metrics_dump:
            print("metrics exposition (utils/telemetry):",
                  file=sys.stderr)
            print(srv.scrape(), file=sys.stderr, end="")
    return 0
