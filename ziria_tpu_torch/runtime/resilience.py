"""Guarded dispatch, its watchdog, and stream-carry checkpoints
(counterpart of ziria_tpu/runtime/resilience.py: ``FaultPolicy``,
``env_max_retries``, ``default_policy`` :123, ``classify_error``,
``backoff_delay``, the watchdog of ``_call_with_watchdog`` :183,
``guarded`` :215 without its ``fallback``, ``checkpoint_carry`` :306,
``restore_carry`` :340, ``save_checkpoint`` :383 and
``load_checkpoint`` :407).

:func:`guarded` runs a call site behind the chaos seam
(``faults.maybe_fail``) inside ``dispatch.timed``; transient failures
retry with exponential backoff and jitter hashed from (label, seed,
attempt); a fatal failure, or exhausted retries, raises
:class:`DispatchFailed`. A real CUDA fault is sticky (it poisons the
context), so on the card a retry cannot heal it: there the receivers
degrade only for an injected fault and re-raise any other (see
``framebatch._contained``).

The watchdog (``FaultPolicy.timeout_s``) runs on the caller's thread:
no second thread ever issues work, so none can go on launching on the
shared CUDA context after its call was given up. An injected delay or
hang longer than the timeout is cut at the timeout before the launch
and raises :class:`InjectedTimeout`, a transient fault that retries as
the reference's abandoned watchdog thread does. A real device that
stops answering is caught where the host waits for it: the receivers
poll the event of each host read against the timeout
(``framebatch._await_device``) and raise :class:`DispatchTimeout`.

:func:`checkpoint_carry` and :func:`restore_carry` keep the
``ziria-stream-carry-v1`` npz layout and its CRC32 integrity field, so
a blob written by either package restores in the other.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import time
import zlib
from collections import Counter
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

from ziria_tpu_torch.utils import dispatch, faults, telemetry

#: status markers of a failure that may heal on retry
TRANSIENT_MARKERS = ("UNAVAILABLE", "RESOURCE_EXHAUSTED",
                     "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
                     "connection reset", "socket closed")


class DispatchTimeout(TimeoutError):
    """A guarded dispatch, or the host read of its results, exceeded
    the watchdog timeout (transient)."""


class InjectedTimeout(DispatchTimeout, faults.InjectedFault):
    """The watchdog cut an injected delay or hang before the launch."""


class DispatchFailed(RuntimeError):
    """A guarded dispatch failed fatally or past its retry budget."""

    def __init__(self, label: str, attempts: int, kind: str,
                 last: BaseException):
        super().__init__(
            f"guarded dispatch '{label}' failed ({kind}) after "
            f"{attempts} attempt(s): {type(last).__name__}: {last}")
        self.label = label
        self.attempts = attempts
        self.kind = kind
        self.last = last


class FaultPolicy(NamedTuple):
    """Retry, backoff and watchdog policy of a guarded site: attempt
    ``a`` backs off ``min(base * 2**a, max) * (0.5 + 0.5 * u)``, u
    hashed from (label, seed, a); ``timeout_s`` (None: no watchdog)
    bounds an injected stall of each attempt and each host read."""
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    timeout_s: Optional[float] = None
    seed: int = 0


def env_max_retries() -> Optional[int]:
    """ZIRIA_MAX_RETRIES: the transient retry budget of every guarded
    site, or None when unset."""
    v = os.environ.get("ZIRIA_MAX_RETRIES")
    if v is None or v == "":
        return None
    return int(v)


def default_policy(max_retries: Optional[int] = None,
                   timeout_s: Optional[float] = None,
                   seed: int = 0) -> FaultPolicy:
    """The site policy: an explicit ``max_retries`` wins, else
    ZIRIA_MAX_RETRIES, else 2."""
    if max_retries is None:
        max_retries = env_max_retries()
    if max_retries is None:
        max_retries = FaultPolicy._field_defaults["max_retries"]
    if max_retries < 0:
        raise ValueError(f"max_retries {max_retries} must be >= 0")
    return FaultPolicy(max_retries=int(max_retries), timeout_s=timeout_s,
                       seed=seed)


def classify_error(e: BaseException) -> str:
    """"transient" (a retry may heal it) or "fatal"."""
    if isinstance(e, faults.InjectedFatalError):
        return "fatal"
    if isinstance(e, (faults.InjectedTransientError, TimeoutError)):
        return "transient"
    msg = str(e)
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


def backoff_delay(label: str, attempt: int,
                  policy: FaultPolicy) -> float:
    """Attempt ``attempt``'s backoff, with hashed jitter."""
    base = min(policy.backoff_base_s * (2 ** attempt),
               policy.backoff_max_s)
    h = hashlib.sha256(
        f"{label}\x00{policy.seed}\x00{attempt}".encode()).digest()
    u = int.from_bytes(h[:8], "big") / float(1 << 64)
    return base * (0.5 + 0.5 * u)


_COUNTS: Counter = Counter()
_CLOCK = threading.Lock()


def _count(name: str, n: int = 1) -> None:
    """A resilience counter: the registry's increment and, in an active
    trace, a counter track of its running total."""
    if not telemetry.active():
        return
    with _CLOCK:
        _COUNTS[name] += n
        tot = _COUNTS[name]
    telemetry.count(name, n, total=tot)


def guarded(label: str, fn: Callable, *args,
            policy: Optional[FaultPolicy] = None) -> Any:
    """``fn(*args)`` as a guarded dispatch at site ``label`` (see the
    module docstring)."""
    policy = policy if policy is not None else default_policy()
    last: Optional[BaseException] = None
    kind = "fatal"
    attempt = 0
    for attempt in range(policy.max_retries + 1):
        try:
            with dispatch.timed(label):
                if faults.maybe_fail(label, policy.timeout_s):
                    raise InjectedTimeout(
                        f"DEADLINE_EXCEEDED: dispatch '{label}' exceeded "
                        f"its {policy.timeout_s}s watchdog")
                out = fn(*args)
            if attempt:
                _count("resilience.recovered")
            return out
        except Exception as e:    # noqa: BLE001 - classified below
            last = e
            kind = classify_error(e)
            if kind == "transient" and attempt < policy.max_retries:
                d = backoff_delay(label, attempt, policy)
                _count("resilience.retries")
                telemetry.observe("resilience.backoff_seconds", d)
                time.sleep(d)
                continue
            break
    _count("resilience.fatal")
    raise DispatchFailed(label, attempt + 1, kind, last) from last


# ------------------------------------------------ carry checkpoint/restore

#: checkpoint container format tag
CARRY_FORMAT = "ziria-stream-carry-v1"


class CarryCheckpointError(ValueError):
    """A checkpoint blob failed validation (format tag, a missing
    field, the integrity CRC, a geometry mismatch)."""


class CarryState(NamedTuple):
    """A deserialized stream checkpoint."""
    tail: np.ndarray          # (n, 2) float32 not-yet-owned samples
    offset: int               # stream coordinate of tail[0]
    emitted: int              # frames emitted so far
    watermark: int            # dedupe prune bound
    seen: frozenset           # live dedupe starts (>= watermark)
    geometry: dict            # receiver geometry fingerprint
    state: dict               # health/degraded runtime state


def _carry_crc(tail: np.ndarray, scalars: np.ndarray,
               seen: np.ndarray, geo: bytes, state: bytes) -> int:
    """CRC32 over the checkpoint's payload bytes."""
    c = zlib.crc32(tail.tobytes())
    c = zlib.crc32(scalars.tobytes(), c)
    c = zlib.crc32(seen.tobytes(), c)
    c = zlib.crc32(geo, c)
    return zlib.crc32(state, c) & 0xFFFFFFFF


def checkpoint_carry(carry, seen=(), geometry: Optional[dict] = None,
                     state: Optional[dict] = None) -> bytes:
    """Serialize a stream carry (``tail``, ``offset``, ``emitted``,
    ``watermark``), the dedupe set, a geometry fingerprint and the
    receiver's runtime ``state`` into an npz blob with a CRC32
    integrity field."""
    tail = np.asarray(carry.tail, np.float32).reshape(-1, 2)
    scalars = np.asarray([int(carry.offset), int(carry.emitted),
                          int(carry.watermark)], np.int64)
    seen_a = np.asarray(sorted(int(s) for s in seen), np.int64)
    geo = json.dumps(geometry or {}, sort_keys=True).encode()
    state_b = json.dumps(state or {}, sort_keys=True).encode()
    buf = io.BytesIO()
    np.savez(
        buf,
        fmt=np.frombuffer(CARRY_FORMAT.encode(), np.uint8),
        tail=tail,
        scalars=scalars,
        seen=seen_a,
        geometry=np.frombuffer(geo, np.uint8),
        state=np.frombuffer(state_b, np.uint8),
        crc=np.asarray(
            [_carry_crc(tail, scalars, seen_a, geo, state_b)],
            np.uint32))
    return buf.getvalue()


def restore_carry(data: bytes) -> CarryState:
    """Deserialize a :func:`checkpoint_carry` blob; raises
    :class:`CarryCheckpointError` on a malformed, torn or wrong-format
    blob."""
    try:
        z = np.load(io.BytesIO(bytes(data)), allow_pickle=False)
        fmt = bytes(z["fmt"]).decode()
        if fmt != CARRY_FORMAT:
            raise CarryCheckpointError(
                f"checkpoint format {fmt!r} != {CARRY_FORMAT!r}")
        tail = np.asarray(z["tail"], np.float32).reshape(-1, 2)
        scalars = np.asarray(z["scalars"], np.int64)
        off, emitted, watermark = (int(v) for v in scalars)
        seen_a = np.asarray(z["seen"], np.int64)
        seen = frozenset(int(s) for s in seen_a)
        geo_b = bytes(z["geometry"])
        geometry = json.loads(geo_b.decode() or "{}")
        state_b = bytes(z["state"]) if "state" in z.files else b"{}"
        state = json.loads(state_b.decode() or "{}")
        if "crc" in z.files:
            want = int(np.asarray(z["crc"], np.uint32)[0])
            got = _carry_crc(tail, scalars, seen_a, geo_b, state_b)
            if got != want:
                raise CarryCheckpointError(
                    f"checkpoint integrity failure: payload CRC32 "
                    f"{got:#010x} != recorded {want:#010x} (torn or "
                    f"corrupted blob)")
        else:
            # a blob from before the integrity field: it loads, counted
            telemetry.count("resilience.checkpoint_legacy")
    except CarryCheckpointError:
        raise
    except Exception as e:
        raise CarryCheckpointError(
            f"unreadable stream checkpoint: {type(e).__name__}: {e}"
        ) from e
    return CarryState(tail, off, emitted, watermark, seen, geometry,
                      state)


def save_checkpoint(path: str, blob: bytes,
                    io_site: str = "checkpoint.write") -> None:
    """Write a checkpoint blob to ``path`` atomically: a temporary file,
    fsync, rename, then fsync of the directory, so a reader sees the
    old content or the new and nothing between. The payload passes the
    durability fault seam (``faults.io_fault``): an injected torn write
    still lands atomically and fails at restore on its CRC."""
    from ziria_tpu_torch.runtime.durability import _fsync_dir

    data = faults.io_fault(io_site, bytes(blob))
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def load_checkpoint(path: str) -> CarryState:
    """Read and validate a checkpoint file written by
    :func:`save_checkpoint` (or any ``checkpoint_carry`` blob on disk);
    a torn or corrupt file raises :class:`CarryCheckpointError`."""
    with open(path, "rb") as f:
        return restore_carry(f.read())
