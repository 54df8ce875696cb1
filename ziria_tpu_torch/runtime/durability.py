"""Crash durability of the serving runtime (counterpart of
ziria_tpu/runtime/durability.py, whole): a write-ahead journal of state
transitions and atomic fleet snapshots, on disk byte for byte in the
reference's format, so either package reads the other's journal and
snapshots.

- :class:`Journal` appends CRC-framed records (``ZWAL`` magic, uint32
  LE length, uint32 LE CRC32, a sorted-key JSON payload carrying its
  sequence number as ``"q"``) to segment files. The active segment
  (``wal-<firstseq>.open``) is append and fsync; rotation seals it
  (fsync, close, rename to ``.log``). A new journal over a crashed
  writer's directory truncates the torn tail of its open segment and
  seals the valid prefix. :func:`replay` drops a record that fails its
  length, CRC or JSON gate and resyncs on the next magic, so one torn
  write never corrupts the records around it.
- :func:`write_snapshot` persists a fleet at a chunk-step boundary:
  each lane's ``ziria-stream-carry-v1`` blob and a CRC'd ``meta.json``
  written into a temp directory, fsync'd, then renamed to
  ``snap-<step>``. :func:`load_snapshot` walks newest first, past any
  snapshot that fails validation, to the asides of an interrupted
  same-step overwrite last.
- :func:`encode_frame` and :func:`decode_frame` carry frames emitted
  but not yet marked delivered in a snapshot (the rider).

Every byte written passes ``faults.io_fault`` (``io_torn``,
``io_enospc``).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ziria_tpu_torch.utils import faults

#: journal record frame: MAGIC + uint32 LE payload length +
#: uint32 LE CRC32(payload) + payload (JSON, carries its seq as "q")
MAGIC = b"ZWAL"
_HDR = struct.Struct("<II")

#: refuse absurd record lengths during resync — a garbage length
#: field must not make the scanner skip a segment's worth of records
MAX_RECORD = 1 << 24

#: snapshot manifest format tag (bump on incompatible layout change)
SNAP_FORMAT = "ziria-serve-snap-v1"


class JournalError(RuntimeError):
    """The journal directory is unusable (not: a torn record — torn
    records are dropped cleanly and counted, never raised)."""


class ReplayStats(NamedTuple):
    """What :func:`replay` saw: valid records returned, distinct
    garbage regions dropped (torn tails, injected torn writes), and
    segments read."""
    records: int
    dropped: int
    segments: int


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _frame(payload: bytes) -> bytes:
    return MAGIC + _HDR.pack(len(payload),
                             zlib.crc32(payload) & 0xFFFFFFFF) \
        + payload


def _segments(dirpath: str) -> List[Tuple[int, str]]:
    """(firstseq, path) for every journal segment, sealed and open,
    sorted by first sequence number."""
    out = []
    try:
        names = os.listdir(dirpath)
    except FileNotFoundError:
        return []
    for n in names:
        if n.startswith("wal-") and (n.endswith(".log")
                                     or n.endswith(".open")):
            try:
                first = int(n[4:].split(".")[0])
            except ValueError:
                continue
            out.append((first, os.path.join(dirpath, n)))
    out.sort()
    return out


def _scan_segment(path: str):
    """Parse one segment with RESYNC: yield (record, end_offset);
    return (records, dropped_regions, clean_end). A record failing
    its magic/length/CRC/JSON gate is skipped and scanning resumes at
    the next magic — a torn last record is simply never yielded."""
    with open(path, "rb") as f:
        data = f.read()
    recs: List[dict] = []
    dropped = 0
    in_garbage = False
    pos = 0
    clean_end = 0
    n = len(data)
    while pos < n:
        m = data.find(MAGIC, pos)
        if m < 0:
            if not in_garbage:
                dropped += 1
            break
        if m > pos and not in_garbage:
            dropped += 1
            in_garbage = True
        hdr_end = m + len(MAGIC) + _HDR.size
        if hdr_end > n:
            if not in_garbage:
                dropped += 1
            break
        ln, crc = _HDR.unpack(data[m + len(MAGIC): hdr_end])
        end = hdr_end + ln
        if ln > MAX_RECORD or end > n:
            if not in_garbage:
                dropped += 1
                in_garbage = True
            pos = m + 1
            continue
        payload = data[hdr_end:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if not in_garbage:
                dropped += 1
                in_garbage = True
            pos = m + 1
            continue
        try:
            ev = json.loads(payload.decode())
        except Exception:
            if not in_garbage:
                dropped += 1
                in_garbage = True
            pos = m + 1
            continue
        recs.append(ev)
        in_garbage = False
        pos = end
        clean_end = end
    return recs, dropped, clean_end


class Journal:
    """Append-only CRC-framed write-ahead journal over segment files.

    One writer per directory (the serving process). Construction
    SEALS any leftover ``.open`` segment from a crashed predecessor —
    its torn tail (if any) is truncated away, the valid prefix
    renamed to a sealed ``.log`` — and the sequence counter resumes
    past every record on disk, so a recovered runtime keeps
    journaling into the same directory without ever rewriting
    history. ``append`` raises ``OSError`` on a genuinely failed
    write (ENOSPC — injected or real); the serving runtime contains
    that (counted, journaling continues best-effort) rather than
    crashing the fleet over a full disk."""

    def __init__(self, dirpath: str, segment_records: int = 256,
                 fsync: bool = True):
        if segment_records < 1:
            raise ValueError(
                f"segment_records {segment_records} must be >= 1")
        self.dir = dirpath
        self.segment_records = int(segment_records)
        self.fsync = bool(fsync)
        os.makedirs(dirpath, exist_ok=True)
        last = 0
        for first, path in _segments(dirpath):
            recs, _d, clean_end = _scan_segment(path)
            if recs:
                last = max(last, max(int(r.get("q", 0))
                                     for r in recs))
            if path.endswith(".open"):
                # a crashed writer's active segment: truncate the
                # torn tail, seal the valid prefix atomically
                sealed = path[: -len(".open")] + ".log"
                if clean_end == 0:
                    os.unlink(path)
                    continue
                with open(path, "rb+") as f:
                    f.truncate(clean_end)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(path, sealed)
        _fsync_dir(dirpath)
        self._seq = last
        self._f = None
        self._records_in_segment = 0

    @property
    def seq(self) -> int:
        """Sequence number of the last appended (or on-disk) record."""
        return self._seq

    def bump_seq(self, floor: int) -> None:
        """Raise the sequence counter to at least ``floor`` — the
        recovery path calls this with the recovered snapshot's
        journal watermark. Without it, a journal whose segments were
        all pruned by that snapshot would restart numbering BELOW
        the watermark, and the NEXT recovery's ``replay(after_seq=
        watermark)`` would silently drop every post-recovery record
        (resurrected sessions, lost delivery marks)."""
        self._seq = max(self._seq, int(floor))

    def _open_segment(self) -> None:
        # called from append() AFTER the record's seq was assigned:
        # the segment is named by its first record's sequence number
        first = self._seq
        path = os.path.join(self.dir, f"wal-{first:012d}.open")
        self._f = open(path, "wb")
        self._path = path
        self._records_in_segment = 0

    def _seal(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        sealed = self._path[: -len(".open")] + ".log"
        os.replace(self._path, sealed)
        _fsync_dir(self.dir)

    def append(self, event: dict) -> int:
        """Durably append one record; returns its sequence number.
        The frame passes the chaos IO seam (site ``journal.append``)
        — an injected ``io_torn`` lands a torn record that replay
        drops and resyncs past; ``io_enospc`` raises to the caller."""
        self._seq += 1
        ev = dict(event)
        ev["q"] = self._seq
        payload = json.dumps(ev, sort_keys=True).encode()
        frame = faults.io_fault("journal.append", _frame(payload))
        if self._f is None:
            self._open_segment()
        try:
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError:
            # the active segment may now hold a partial frame; replay
            # resyncs past it, and the NEXT append starts clean after
            # whatever landed — never rewrite history in place
            raise
        self._records_in_segment += 1
        if self._records_in_segment >= self.segment_records:
            self._seal()
        return self._seq

    def prune(self, upto_seq: int) -> int:
        """Delete SEALED segments every record of which is covered by
        ``upto_seq`` (a snapshot's journal watermark) — replay after
        the snapshot never needs them. Returns segments deleted."""
        segs = _segments(self.dir)
        deleted = 0
        for i, (first, path) in enumerate(segs):
            if path.endswith(".open"):
                continue
            nxt = segs[i + 1][0] if i + 1 < len(segs) \
                else self._seq + 1
            if nxt - 1 <= upto_seq:
                os.unlink(path)
                deleted += 1
        if deleted:
            _fsync_dir(self.dir)
        return deleted

    def close(self) -> None:
        """Seal the active segment (idempotent)."""
        self._seal()


def replay(dirpath: str,
           after_seq: int = 0) -> Tuple[List[dict], ReplayStats]:
    """Read every valid journal record with sequence > ``after_seq``,
    in order. Torn records — a truncated tail from a crash or an
    injected ``io_torn`` — are dropped cleanly and counted; records
    around them survive (the resync scan). An absent directory is an
    empty journal."""
    recs: List[dict] = []
    dropped = 0
    segs = _segments(dirpath)
    for _first, path in segs:
        r, d, _end = _scan_segment(path)
        recs.extend(r)
        dropped += d
    recs = [r for r in recs if int(r.get("q", 0)) > after_seq]
    recs.sort(key=lambda r: int(r.get("q", 0)))
    return recs, ReplayStats(len(recs), dropped, len(segs))


# ----------------------------------------------------------- snapshots


def _write_file(path: str, data: bytes, site: str,
                do_fsync: bool = True) -> None:
    data = faults.io_fault(site, data)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if do_fsync:
            os.fsync(f.fileno())


class Snapshot(NamedTuple):
    """One loaded fleet snapshot: the chunk-step it was taken at, the
    per-lane checkpoint blobs, and the manifest body the serving
    runtime wrote (session table, journal watermark, rider)."""
    step: int
    lanes: Dict[int, bytes]
    body: dict
    path: str


def snapshot_name(step: int) -> str:
    return f"snap-{step:010d}"


def write_snapshot(root: str, step: int, lanes: Dict[int, bytes],
                   body: dict, keep: int = 2) -> str:
    """Persist one fleet snapshot ATOMICALLY: lane blobs + a CRC'd
    ``meta.json`` manifest land in a temp directory (each file
    fsync'd, each write through the chaos IO seam), the directory is
    fsync'd, then ``rename``\\ d into place — a reader (and a crash)
    sees the whole snapshot or none of it. Older snapshots beyond
    ``keep`` are pruned; stale temp directories from crashed writers
    are garbage-collected. Returns the final snapshot path."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, snapshot_name(step))
    tmp = os.path.join(root, f".tmp-{snapshot_name(step)}.{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        lane_names = {}
        for i, blob in sorted(lanes.items()):
            name = f"lane-{int(i):04d}.ckpt"
            lane_names[str(int(i))] = name
            _write_file(os.path.join(tmp, name), bytes(blob),
                        "snapshot.lane")
        full = {"fmt": SNAP_FORMAT, "step": int(step),
                "lanes": lane_names, "body": body}
        payload = json.dumps(full, sort_keys=True).encode()
        manifest = json.dumps(
            {"crc": zlib.crc32(payload) & 0xFFFFFFFF,
             "payload": payload.decode()}).encode()
        _write_file(os.path.join(tmp, "meta.json"), manifest,
                    "snapshot.meta")
        _fsync_dir(tmp)
        if os.path.isdir(final):
            # same-step overwrite: move the old snapshot ASIDE (to a
            # loader-invisible name) before renaming the new one in —
            # never rmtree-then-rename, which a crash in between
            # would turn into "neither version survives"
            aside = os.path.join(
                root, f".old-{snapshot_name(step)}.{os.getpid()}")
            if os.path.isdir(aside):
                shutil.rmtree(aside)
            os.replace(final, aside)
            os.replace(tmp, final)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.replace(tmp, final)
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune_snapshots(root, keep)
    return final


def _snapshot_dirs(root: str, prefix: str = "snap-"
                   ) -> List[Tuple[int, str]]:
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for n in names:
        if n.startswith(prefix):
            try:
                step = int(n[len(prefix):].split(".")[0])
            except ValueError:
                continue
            p = os.path.join(root, n)
            if os.path.isdir(p):
                out.append((step, p))
    out.sort()
    return out


def _prune_snapshots(root: str, keep: int) -> None:
    snaps = _snapshot_dirs(root)
    for _step, p in snaps[: max(0, len(snaps) - keep)]:
        shutil.rmtree(p, ignore_errors=True)
    for n in os.listdir(root):
        if n.startswith(".tmp-snap-") or n.startswith(".old-snap-"):
            # a crashed writer's temp (never renamed in) or aside
            # (already superseded): garbage whatever it contains
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)


def _load_one(step: int, path: str) -> Snapshot:
    with open(os.path.join(path, "meta.json"), "rb") as f:
        manifest = json.loads(f.read().decode())
    payload = manifest["payload"].encode()
    if zlib.crc32(payload) & 0xFFFFFFFF != int(manifest["crc"]):
        raise JournalError(f"{path}: manifest CRC mismatch")
    full = json.loads(payload.decode())
    if full.get("fmt") != SNAP_FORMAT:
        raise JournalError(
            f"{path}: snapshot format {full.get('fmt')!r} != "
            f"{SNAP_FORMAT!r}")
    lanes = {}
    for i, name in full["lanes"].items():
        with open(os.path.join(path, name), "rb") as f:
            lanes[int(i)] = f.read()
    return Snapshot(int(full["step"]), lanes, full["body"], path)


def load_snapshot(root: str) -> Optional[Snapshot]:
    """The newest snapshot that VALIDATES (manifest present, CRC
    good, every listed lane file readable) — walking past any that
    does not, because a snapshot that cannot be trusted whole must
    not be restored in part. Falls back to ``.old-snap-*`` asides as
    a last resort: a crash INSIDE a same-step overwrite (old moved
    aside, new not yet renamed in) leaves the previous complete
    snapshot there, and it must stay loadable — the all-or-nothing
    guarantee has no window. None when no usable snapshot exists
    (recovery then starts from the journal alone)."""
    for step, path in reversed(_snapshot_dirs(root)):
        try:
            return _load_one(step, path)
        except Exception:
            continue
    for step, path in reversed(_snapshot_dirs(root, ".old-snap-")):
        try:
            return _load_one(step, path)
        except Exception:
            continue
    return None


# ------------------------------------------- frame rider serialization
#
# A snapshot's drain (and the delivery-mark lag of the serving runtime)
# leaves frames that are EMITTED by the receiver — so its restored
# carry will never re-emit them — but not yet durably marked
# delivered. Those ride the snapshot verbatim ("the rider") and are
# re-delivered on recovery: at-least-once, deduped by the journaled
# delivery watermark, never silently lost.


def encode_frame(frame) -> dict:
    """StreamFrame -> JSON-safe dict (psdu bits as base64)."""
    r = frame.result
    psdu = None
    if getattr(r, "psdu_bits", None) is not None:
        a = np.asarray(r.psdu_bits, np.uint8)
        psdu = base64.b64encode(a.tobytes()).decode()
    return {"start": int(frame.start), "ok": bool(r.ok),
            "rate": int(r.rate_mbps), "len": int(r.length_bytes),
            "psdu": psdu,
            "crc": None if r.crc_ok is None else bool(r.crc_ok)}


def decode_frame(d: dict):
    """The inverse of :func:`encode_frame` (the PHY types are imported
    here, so the journal and snapshots stay usable without them)."""
    from ziria_tpu_torch.backend.framebatch import StreamFrame
    from ziria_tpu_torch.phy.wifi.rx import RxResult

    psdu = None
    if d.get("psdu") is not None:
        psdu = np.frombuffer(base64.b64decode(d["psdu"]), np.uint8)
    return StreamFrame(int(d["start"]), RxResult(
        bool(d["ok"]), int(d["rate"]), int(d["len"]), psdu,
        None if d.get("crc") is None else bool(d["crc"])))
