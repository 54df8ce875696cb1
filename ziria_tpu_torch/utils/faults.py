"""Seeded, scoped fault injection at the receivers' and the server's
seams (counterpart of ziria_tpu/utils/faults.py: ``FaultSpec``,
``FaultPlan``, ``inject``, ``active``, ``maybe_fail``, ``corrupt_slab``
with the ``nan_slab``, ``truncate`` and ``channel`` kinds, ``io_fault``
:336, the injected error classes, ``FaultPlan.total_fired`` :202 and
``fired_sites`` :206, and the ``--chaos`` / ``ZIRIA_CHAOS`` grammar:
``parse_chaos_spec`` :367 and ``env_chaos`` :418).

:func:`inject` activates a :class:`FaultPlan` for a block. Every
decision is deterministic by (site, seed, call index), computed as the
reference computes it, so one plan hits the same calls in both
packages. Three seams consume it: :func:`maybe_fail` just before a
guarded dispatch fires (``transient``, ``fatal``, ``delay``, ``hang``),
:func:`corrupt_slab` on a pushed sample slab (``nan_slab``,
``truncate``, ``channel``: the slab through a named channel profile of
``phy/profiles``) and :func:`io_fault` on every payload the durability
layer writes (``io_torn``, ``io_enospc``). When no plan is active each
seam costs one truthiness check.
"""

from __future__ import annotations

import errno
import fnmatch
import hashlib
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

_LOCK = threading.Lock()            # guards (de)activation only
_PLANS: Tuple["FaultPlan", ...] = ()

DATA_KINDS = ("nan_slab", "truncate", "channel")
DISPATCH_KINDS = ("transient", "fatal", "delay", "hang")
IO_KINDS = ("io_torn", "io_enospc")
#: every kind, in the reference's order (its error messages list them)
KINDS = ("nan_slab", "truncate", "transient", "fatal", "delay", "hang",
         "io_torn", "io_enospc", "channel")


class InjectedFault(Exception):
    """Base of the injected error classes (never raised itself)."""


class InjectedTransientError(InjectedFault):
    """An injected retryable dispatch failure (``UNAVAILABLE: ...``)."""


class InjectedFatalError(InjectedFault):
    """An injected non-retryable dispatch failure
    (``INVALID_ARGUMENT: ...``)."""


class FaultSpec(NamedTuple):
    """One injectable fault: fire ``kind`` at sites matching the
    fnmatch pattern ``site`` on the calls picked by exactly one of
    ``calls`` (0-based per-site call indices), ``every`` (every Nth
    call) or ``p`` (a probability decided by a hash of (site, seed,
    call index)). ``count`` bounds the firings (0: unbounded);
    ``delay_s`` is the sleep of delay and hang; ``fraction`` the slab
    share nan_slab and truncate touch; ``profile`` the channel profile
    of the channel kind (validated when the plan is built)."""
    site: str
    kind: str
    calls: Tuple[int, ...] = ()
    every: int = 0
    p: float = 0.0
    count: int = 0
    delay_s: float = 0.01
    fraction: float = 0.25
    profile: str = "hostile"


def _unit(site: str, seed: int, idx: int) -> float:
    """Deterministic uniform in [0, 1) from (site, seed, call index)."""
    h = hashlib.sha256(f"{site}\x00{seed}\x00{idx}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultPlan:
    """The decision state of one :func:`inject` block: per-site call
    counters, per-spec firing counts and the log of fired faults
    (``fired``: (site, kind, call index))."""

    def __init__(self, specs, seed: int = 0):
        specs = tuple(specs)
        for sp in specs:
            if sp.kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {sp.kind!r} (known: {KINDS})")
            if sum((len(sp.calls) > 0, sp.every > 0, sp.p > 0)) != 1:
                raise ValueError(
                    f"spec {sp.site}:{sp.kind} needs exactly one of "
                    f"calls=/every=/p= to select its firing calls")
            if sp.kind == "channel":
                from ziria_tpu_torch.phy.profiles import get_profile
                get_profile(sp.profile)
        self.specs = specs
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._idx: Dict[str, int] = {}
        self._spec_fired = [0] * len(specs)
        self.fired: List[Tuple[str, str, int]] = []

    def decide(self, site: str, kinds) -> Optional[Tuple[FaultSpec, int]]:
        """Advance ``site``'s call counter; return the first matching
        spec of ``kinds`` that fires at this call, with the call index,
        or None."""
        with self._lock:
            idx = self._idx.get(site, 0)
            self._idx[site] = idx + 1
            for j, sp in enumerate(self.specs):
                if sp.kind not in kinds:
                    continue
                if sp.count and self._spec_fired[j] >= sp.count:
                    continue
                if not fnmatch.fnmatchcase(site, sp.site):
                    continue
                if sp.calls:
                    hit = idx in sp.calls
                elif sp.every:
                    hit = (idx + 1) % sp.every == 0
                else:
                    hit = _unit(f"{site}#{j}", self.seed, idx) < sp.p
                if hit:
                    self._spec_fired[j] += 1
                    self.fired.append((site, sp.kind, idx))
                    return sp, idx
        return None

    @property
    def total_fired(self) -> int:
        with self._lock:
            return len(self.fired)

    def fired_sites(self) -> Dict[str, int]:
        """site -> how many faults fired there."""
        out: Dict[str, int] = {}
        with self._lock:
            for s, _k, _i in self.fired:
                out[s] = out.get(s, 0) + 1
        return out


def active() -> bool:
    """True when any fault plan is injecting."""
    return bool(_PLANS)


@contextmanager
def inject(*specs: FaultSpec, seed: int = 0,
           plan: Optional[FaultPlan] = None):
    """Activate a :class:`FaultPlan` (from ``specs`` and ``seed``, or
    the one passed in) for the block; yields it."""
    global _PLANS
    p = plan if plan is not None else FaultPlan(specs, seed=seed)
    with _LOCK:
        _PLANS = _PLANS + (p,)
    try:
        yield p
    finally:
        with _LOCK:
            lst = list(_PLANS)
            del lst[len(lst) - 1 - lst[::-1].index(p)]
            _PLANS = tuple(lst)


def maybe_fail(site: str, budget_s: Optional[float] = None) -> bool:
    """The dispatch seam: a matching delay or hang sleeps ``delay_s``,
    a transient or fatal spec raises its injected error. With a
    watchdog ``budget_s``, a sleep longer than it is cut at the budget
    and the call returns True (the caller raises its timeout before
    launching anything); else False."""
    if not _PLANS:
        return False
    for plan in _PLANS:
        got = plan.decide(site, DISPATCH_KINDS)
        if got is None:
            continue
        sp, idx = got
        if sp.kind in ("delay", "hang"):
            if budget_s is not None and sp.delay_s > budget_s:
                time.sleep(budget_s)
                return True
            time.sleep(sp.delay_s)
        elif sp.kind == "transient":
            raise InjectedTransientError(
                f"UNAVAILABLE: injected transient fault at {site} "
                f"(call {idx})")
        else:
            raise InjectedFatalError(
                f"INVALID_ARGUMENT: injected fatal fault at {site} "
                f"(call {idx})")
    return False


def _channel_slab(arr: np.ndarray, profile: str, seed: int,
                  idx: int) -> np.ndarray:
    """The ``channel`` kind: the slab through a named channel profile in
    numpy (multipath FIR, SCO resample, a drift ramp from the slab's own
    origin, and bursts drawn from a generator seeded by the plan's
    (profile, seed, call index) hash), as the reference does."""
    from ziria_tpu_torch.phy.profiles import get_profile, np_apply_drift, \
        np_apply_sco, np_apply_taps, np_burst_amp, np_burst_mask

    prof = get_profile(profile)
    x = np_apply_taps(np.asarray(arr, np.float32), prof)
    x = np_apply_sco(x, prof.sco)
    x = np_apply_drift(x, prof.drift)
    n = x.shape[0]
    if prof.burst_every and n:
        rs = np.random.default_rng(int(_unit(f"chan:{profile}", seed,
                                             idx) * (1 << 53)))
        off = int(rs.integers(0, prof.burst_every))
        in_burst = np_burst_mask(n, prof, off)
        p_sig = float(np.mean(np.square(x.astype(np.float64)))) * 2.0
        amp = np_burst_amp(p_sig, prof)
        x = (x + rs.normal(size=x.shape)
             * (amp * in_burst.astype(np.float64))[:, None]) \
            .astype(np.float32)
    return x


def corrupt_slab(site: str, arr: np.ndarray):
    """The data seam, on an incoming (n, 2) sample slab: ``nan_slab``
    NaN-poisons a deterministic ``fraction`` of the rows (rows drawn
    from a generator seeded by (site, seed, call index)), ``truncate``
    drops the tail ``fraction``, ``channel`` passes the slab through its
    profile (:func:`_channel_slab`). Returns (slab, kinds fired)."""
    if not _PLANS:
        return arr, ()
    kinds: List[str] = []
    for plan in _PLANS:
        got = plan.decide(site, DATA_KINDS)
        if got is None:
            continue
        sp, idx = got
        n = int(arr.shape[0]) if arr.ndim else 0
        if sp.kind == "nan_slab" and n:
            arr = np.array(arr, copy=True)
            k = max(1, int(n * sp.fraction))
            rs = np.random.default_rng(
                int(_unit(site, plan.seed, idx) * (1 << 53)))
            rows = rs.choice(n, size=min(k, n), replace=False)
            arr[rows] = np.nan
        elif sp.kind == "truncate" and n > 1:
            keep = max(1, n - max(1, int(n * sp.fraction)))
            arr = arr[:keep]
        elif sp.kind == "channel" and n:
            arr = _channel_slab(arr, sp.profile, plan.seed, idx)
        kinds.append(sp.kind)
    return arr, tuple(kinds)


def io_fault(site: str, data: bytes) -> bytes:
    """The durability write seam, on a payload about to be written:
    ``io_torn`` returns a truncated prefix (at least one byte short),
    ``io_enospc`` raises ``OSError(ENOSPC)`` as a full disk would."""
    if not _PLANS:
        return data
    for plan in _PLANS:
        got = plan.decide(site, IO_KINDS)
        if got is None:
            continue
        sp, idx = got
        if sp.kind == "io_enospc":
            raise OSError(
                errno.ENOSPC,
                f"No space left on device (injected at {site}, "
                f"call {idx})")
        keep = min(len(data) - 1, int(len(data) * (1.0 - sp.fraction)))
        data = data[: max(0, keep)]
    return data


def parse_chaos_spec(text: str) -> Tuple[Tuple[FaultSpec, ...], int]:
    """The ``--chaos`` / ``ZIRIA_CHAOS`` grammar, semicolon-separated
    ``[seed=N;]site:kind[:key=val,...]`` items (keys ``every``,
    ``calls`` as ``i+j``, ``p``, ``count``, ``delay``, ``frac``,
    ``profile``; a bare item fires every call), as ``(specs, seed)``.
    A malformed spec raises ValueError, validated as a plan would be."""
    specs: List[FaultSpec] = []
    seed = 0
    for item in (s.strip() for s in text.split(";")):
        if not item:
            continue
        if item.startswith("seed="):
            seed = int(item[5:])
            continue
        parts = item.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"chaos spec {item!r}: want site:kind[:key=val,...]")
        site, kind = parts[0], parts[1]
        kw: Dict[str, object] = {}
        for opt in ":".join(parts[2:]).split(","):
            opt = opt.strip()
            if not opt:
                continue
            if "=" not in opt:
                raise ValueError(f"chaos option {opt!r}: want key=val")
            k, v = opt.split("=", 1)
            if k == "every":
                kw["every"] = int(v)
            elif k == "calls":
                kw["calls"] = tuple(int(c) for c in v.split("+"))
            elif k == "p":
                kw["p"] = float(v)
            elif k == "count":
                kw["count"] = int(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            elif k == "frac":
                kw["fraction"] = float(v)
            elif k == "profile":
                kw["profile"] = v
            else:
                raise ValueError(f"unknown chaos option {k!r}")
        if not (kw.get("calls") or kw.get("every") or kw.get("p")):
            kw["every"] = 1
        specs.append(FaultSpec(site=site, kind=kind, **kw))
    FaultPlan(specs, seed=seed)
    return tuple(specs), seed


def env_chaos() -> Optional[Tuple[Tuple[FaultSpec, ...], int]]:
    """ZIRIA_CHAOS (the CLI's ``--chaos`` writes it for one
    invocation): ``(specs, seed)`` of the described fault plan, or None
    when unset or empty."""
    import os

    text = os.environ.get("ZIRIA_CHAOS")
    if not text:
        return None
    return parse_chaos_spec(text)
