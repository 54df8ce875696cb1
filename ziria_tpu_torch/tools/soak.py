"""Chaos-soak campaign of the durable serving runtime (counterpart of
the repo's ``tools/soak.py``, with the same names).

A seeded random fault campaign over the crash-tolerant server: the
dispatch faults (``transient``, ``fatal``, ``delay``, ``hang`` at the
fleet's scan and decode), the data faults (``nan_slab``, ``truncate``
at the push seams) and the disk faults (``io_torn``, ``io_enospc`` at
the journal and snapshot writes), each round ending in a crash and a
``ServeRuntime.recover``; one round runs every stream through a channel
profile (``urban``); and real process death: a serving child process
(``python -m ziria_tpu_torch.tools.soak --child``) is SIGKILLed mid
chunk-step and this process recovers from the directory it left.

Gates (any failure raises :class:`SoakGateFailed`):

- **zero crashes**: no round raises out of the serving loop or the
  recovery;
- **bit identity**: every delivered frame equals the uninterrupted
  oracle's at the same (session, start); delivery is at least once
  (duplicates counted, deduplicated by (sid, start)); a session no data
  fault touched delivers the whole oracle set, a NaN-poisoned one a
  subset, a truncated one is held to no crash only;
- **recovery SLO**: the p99 of ``recover()``'s wall time, 30 s;
- **after recovery**: at most 2 dispatches a chunk-step on the
  recovered fleet, no ``nvcc`` run and no library load
  (``cuda_build.COUNTS``), and on the card one ACS and one traceback
  launch a decode dispatch and no other launch
  (``viterbi_cuda.LAUNCHES``; eager torch compiles no program, so the
  reference's ``no_recompile`` has no counterpart). On the CPU the
  wrappers run their plain versions and count nothing.

The child prints one JSON line first: its device, its CUDA init
seconds, its nvcc builds and library loads (it loads the kernel library
the parent built before it serves) and a digest of the streams it
rebuilt from the seed, which must equal the parent's. Every entry point
takes ``device`` ("cuda" by default).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_BYTES = 12
# ziria: lint-ignore[R6] the reference harness's fixed serve-test geometry (the repo's tools/soak.py GEO), which the campaign's oracle and gates are defined at
GEO = dict(chunk_len=4096, frame_len=1024, max_frames_per_chunk=8,
           check_fcs=True)

#: the full kind menu a campaign round draws from (site, kind, kwargs)
DISPATCH_MENU = [
    ("rx.stream_chunk_multi", "transient", {"every": 4}),
    ("rx.stream_decode_multi", "transient", {"every": 3}),
    ("rx.stream_decode_multi", "fatal", {"calls": (2,), "count": 1}),
    ("rx.stream_chunk_multi", "delay", {"every": 5, "delay_s": 0.02}),
    ("rx.stream_chunk_multi", "hang",
     {"calls": (3,), "count": 1, "delay_s": 8.0}),
]
DATA_MENU = [
    ("rx.push.s*", "nan_slab", {"every": 7, "fraction": 0.2}),
    ("rx.push.s*", "truncate", {"every": 9, "fraction": 0.2}),
]
IO_MENU = [
    ("journal.append", "io_torn", {"every": 6, "fraction": 0.5}),
    ("journal.append", "io_enospc", {"every": 11}),
    ("snapshot.lane", "io_enospc", {"calls": (1,), "count": 1}),
    ("snapshot.meta", "io_torn", {"calls": (0,), "count": 1,
                                  "fraction": 0.3}),
]

#: the repo root: the child runs ``python -m`` from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SoakGateFailed(AssertionError):
    """A gate of the campaign failed."""


def _gate(cond: bool, what: str) -> None:
    if not cond:
        raise SoakGateFailed(what)


def _same(a, b) -> bool:
    return (a.start == b.start and a.result.ok == b.result.ok
            and a.result.rate_mbps == b.result.rate_mbps
            and a.result.length_bytes == b.result.length_bytes
            and np.array_equal(np.asarray(a.result.psdu_bits),
                               np.asarray(b.result.psdu_bits))
            and a.result.crc_ok == b.result.crc_ok)


def _clients(n_sessions: int, frames_per_session: int, seed: int,
             channel_profile=None, device="cuda"):
    from ziria_tpu_torch.runtime import serve
    return serve.synth_load(n_sessions, frames_per_session,
                            n_bytes=N_BYTES, snr_db=30.0, seed=seed,
                            tail=GEO["frame_len"],
                            channel_profile=channel_profile, device=device)


def _digest(clients) -> str:
    """sha256 of every client's id and stream bytes: parent and child
    must have made the same streams."""
    h = hashlib.sha256()
    for c in clients:
        h.update(str(c.sid).encode())
        h.update(np.ascontiguousarray(c.stream, np.float32).tobytes())
    return h.hexdigest()


def _oracle(clients, device="cuda"):
    from ziria_tpu_torch.backend import framebatch
    return {c.sid: framebatch.receive_stream(c.stream, **GEO,
                                             device=device)[0]
            for c in clients}


def _config(n_lanes: int, snapshot_dir: str, snapshot_every: int = 1,
            watchdog_s=None):
    from ziria_tpu_torch.runtime import serve
    return serve.ServeConfig(n_lanes=n_lanes, queue_cap=16, sanitize=True,
                             watchdog_s=watchdog_s,
                             snapshot_dir=snapshot_dir,
                             snapshot_every=snapshot_every, **GEO)


def _serve_until_crash(cfg, clients, crash_after: int, got, device="cuda"):
    """Run a fresh server, pushing each client's stream in ragged
    slabs, until ``crash_after`` frames were delivered (or the input
    is exhausted); then abandon the runtime mid-flight: no drain, no
    close, what a SIGKILL leaves behind, minus the process. Returns
    the abandoned runtime (for accounting reads only)."""
    from ziria_tpu_torch.runtime import serve

    srv = serve.ServeRuntime(cfg, device=device)
    delivered = 0
    with srv:
        for c in clients:
            srv.connect(c.sid)
        pos = {c.sid: 0 for c in clients}
        idle = 0
        while idle < 3:
            moved = False
            for c in clients:
                lo = pos[c.sid]
                hi = min(lo + 1700, c.stream.shape[0])
                if lo < hi:
                    if srv.submit(c.sid, c.stream[lo:hi]).accepted:
                        pos[c.sid] = hi
                    moved = True
            frames = srv.step()
            for sid, f in frames:
                got[sid].append(f)
                delivered += 1
            if delivered >= crash_after:
                break
            idle = 0 if (moved or frames) else idle + 1
        srv._drained = True          # the crash: nothing cleans up
    return srv


def _finish_recovered(srv2, clients, got):
    """The client recovery protocol: take the replayed rider frames,
    resubmit every live session's stream from its ``acked`` coordinate
    (a session the journal lost entirely, its admit record eaten by
    ENOSPC, reconnects fresh and resubmits from zero; the dedupe key
    (sid, start) absorbs any re-delivery), drive to quiescence,
    drain."""
    with srv2:
        for sid, f in srv2.replayed:
            got[sid].append(f)
        for c in clients:
            if c.sid not in srv2._sessions:
                if c.sid in srv2._gone:
                    continue             # terminally accounted
                srv2.connect(c.sid)      # journal-lost: fresh session
            if c.sid not in srv2._sessions:
                continue                 # queue full: give up politely
            acked = srv2.acked(c.sid)
            for lo in range(acked, c.stream.shape[0], 1 << 14):
                srv2.submit(c.sid, c.stream[lo: lo + (1 << 14)])
        idle = 0
        while idle < 3:
            frames = srv2.step()
            for sid, f in frames:
                got[sid].append(f)
            idle = 0 if frames else idle + 1
        for sid, f in srv2.drain():
            got[sid].append(f)


def _finish_pinned(srv2, clients, got, device) -> dict:
    """:func:`_finish_recovered` with the post-recovery budget pinned:
    at most 2 dispatches a chunk-step, no nvcc run, no library load,
    and (on the card) one ACS and one traceback launch a decode
    dispatch and nothing else. Returns what was counted."""
    import torch

    from ziria_tpu_torch import cuda_build
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.utils import dispatch

    built0 = dict(cuda_build.COUNTS)
    launched0 = {**vc.LAUNCHES, **vf.LAUNCHES}
    with dispatch.count_dispatches() as dc:
        _finish_recovered(srv2, clients, got)
    launched = {k: v - launched0[k]
                for k, v in {**vc.LAUNCHES, **vf.LAUNCHES}.items()}
    built = {k: v - built0[k] for k, v in cuda_build.COUNTS.items()}
    steps = int(srv2.stats().chunk_steps)
    decodes = int(dc.counts.get("rx.stream_decode_multi", 0))
    dpcs = round(dc.total / steps, 2) if steps else None
    _gate(dpcs is None or dpcs <= 2.0 + 1e-9,
          f"dispatch budget broken after recovery: {dc.total} dispatches "
          f"/ {steps} chunk-steps")
    _gate(built == {"builds": 0, "loads": 0},
          f"the recovered fleet ran nvcc or loaded a library: {built}")
    per = decodes if torch.device(device).type == "cuda" else 0
    want = {k: (per if k in ("acs", "traceback") else 0) for k in launched}
    _gate(launched == want,
          f"the recovered fleet's launches {launched} for {decodes} "
          f"decode dispatches")
    return {"dispatches": int(dc.total), "chunk_steps": steps,
            "decode_dispatches": decodes, "dpcs": dpcs,
            "launches": {"acs": launched["acs"],
                         "traceback": launched["traceback"]},
            "nvcc_builds": built["builds"], "library_loads": built["loads"]}


def _verify(clients, oracle, got, nan_sids, trunc_sids):
    """The identity gate. Returns (duplicates, frames_checked)."""
    dups = 0
    checked = 0
    for c in clients:
        if c.sid in trunc_sids:
            continue          # stream genuinely differs: no-crash only
        by_start = {}
        for f in got[c.sid]:
            if f.start in by_start:
                _gate(_same(f, by_start[f.start]),
                      f"{c.sid}: duplicate at {f.start} differs")
                dups += 1
                continue
            by_start[f.start] = f
        want = {f.start: f for f in oracle[c.sid]}
        for start, f in by_start.items():
            _gate(start in want, f"{c.sid}: unexpected frame at {start}")
            _gate(_same(f, want[start]),
                  f"{c.sid}: frame at {start} differs from oracle")
            checked += 1
        if c.sid not in nan_sids:
            missing = sorted(set(want) - set(by_start))
            _gate(not missing,
                  f"{c.sid}: frames missing after recovery: {missing}")
    return dups, checked


def _affected_sids(plan, lane_sid):
    """Map fired data-seam sites (rx.push.s<lane>) back to sessions."""
    nan_s, trunc_s = set(), set()
    for site, kind, _idx in plan.fired:
        if not site.startswith("rx.push.s"):
            continue
        lane = int(site[len("rx.push.s"):])
        sid = lane_sid.get(lane)
        if sid is None:
            continue
        (nan_s if kind == "nan_slab" else trunc_s).add(sid)
    return nan_s, trunc_s


def _round_specs(rng, dirty: bool):
    """Draw a seeded spec set for one round: always >= 1 dispatch
    kind and >= 1 io kind; data-poisoning kinds only on dirty
    rounds (their sessions cannot gate completeness)."""
    from ziria_tpu_torch.utils import faults
    picks = [DISPATCH_MENU[i] for i in
             rng.choice(len(DISPATCH_MENU),
                        size=1 + int(rng.integers(0, 3)),
                        replace=False)]
    picks += [IO_MENU[i] for i in
              rng.choice(len(IO_MENU), size=1 + int(rng.integers(0, 2)),
                         replace=False)]
    if dirty:
        picks += [DATA_MENU[int(rng.integers(0, len(DATA_MENU)))]]
    return [faults.FaultSpec(site, kind, **kw)
            for site, kind, kw in picks]


def run_round(clients, oracle, cfg, seed: int, dirty: bool,
              budget: bool = False, device="cuda", specs=None,
              crash_after=None) -> dict:
    """One in-process campaign round: serve under a seeded fault plan
    (dispatch and io kinds, push kinds on dirty rounds), crash, recover
    with the plan gone (the chaos died with the process), verify, time
    the recovery. ``budget=True`` also pins the post-recovery budget
    (:func:`_finish_pinned`; the pre-crash phase is excluded, as
    injected transients retry as extra dispatches). `specs` and
    `crash_after` replace the seeded draws (:func:`kind_rounds`)."""
    from ziria_tpu_torch.runtime import serve
    from ziria_tpu_torch.utils import faults

    rng = np.random.default_rng(seed)
    drawn_specs = _round_specs(rng, dirty)
    drawn_crash = 1 + int(rng.integers(0, 3))
    specs = drawn_specs if specs is None else specs
    crash_after = drawn_crash if crash_after is None else crash_after
    got = {c.sid: [] for c in clients}
    with faults.inject(*specs, seed=seed) as plan:
        srv = _serve_until_crash(cfg, clients, crash_after, got, device)
        lane_sid = dict(srv._lane_sid)
    nan_s, trunc_s = _affected_sids(plan, lane_sid)
    st = srv.stats()

    t0 = time.perf_counter()
    srv2 = serve.ServeRuntime.recover(cfg.snapshot_dir, config=cfg,
                                      device=device)
    recovery_s = time.perf_counter() - t0
    post = None
    if budget:
        post = _finish_pinned(srv2, clients, got, device)
    else:
        _finish_recovered(srv2, clients, got)
    dups, checked = _verify(clients, oracle, got, nan_s, trunc_s)
    st2 = srv2.stats()
    return {"recovery_s": recovery_s, "faults": len(plan.fired),
            "by_kind": _by_kind(plan), "duplicates": dups,
            "frames_checked": checked, "deduped": st2.deduped,
            "snapshots": st.snapshots + st2.snapshots,
            "journal_errors": st.journal_errors + st2.journal_errors,
            "dpcs": None if post is None else post["dpcs"],
            "post_recovery": post,
            "nan_sessions": sorted(map(str, nan_s)),
            "trunc_sessions": sorted(map(str, trunc_s))}


def _by_kind(plan) -> dict:
    out: dict = {}
    for _site, kind, _idx in plan.fired:
        out[kind] = out.get(kind, 0) + 1
    return out


# ----------------------------------------------------- SIGKILL rounds


def _child_main(args) -> int:
    """``--child``: the serving loop the SIGKILL rounds shoot. Reports
    itself on its first line, rebuilds the parent's seeded clients on
    its own device, serves with journaling and a snapshot every step,
    prints one flushed JSON line per delivered frame (the parent's
    record of what the dead process delivered), and sleeps a little
    each tick so the parent can land the kill mid-run."""
    import torch

    from ziria_tpu_torch import cuda_build
    from ziria_tpu_torch.runtime import durability, serve

    if args.threads:
        torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    cuda_init_s = None
    if dev.type == "cuda":
        from ziria_tpu_torch.ops import viterbi_cuda as vc
        t0 = time.perf_counter()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        cuda_init_s = time.perf_counter() - t0
        vc._lib()            # the parent's library: loaded, never built
    clients = _clients(args.sessions, args.frames, args.seed, device=dev)
    print(json.dumps({"child": {
        "device": str(dev), "pid": os.getpid(), "cuda_init_s": cuda_init_s,
        "nvcc_builds": cuda_build.COUNTS["builds"],
        "library_loads": cuda_build.COUNTS["loads"],
        "streams": _digest(clients)}}), flush=True)
    cfg = serve.ServeConfig(n_lanes=args.lanes, queue_cap=16,
                            sanitize=True,
                            snapshot_dir=args.dir, snapshot_every=1,
                            **GEO)
    got_n = 0
    srv = serve.ServeRuntime(cfg, device=dev)
    with srv:
        for c in clients:
            srv.connect(c.sid)
        pos = {c.sid: 0 for c in clients}
        idle = 0
        while idle < 3:
            moved = False
            for c in clients:
                lo = pos[c.sid]
                hi = min(lo + 1500, c.stream.shape[0])
                if lo < hi:
                    if srv.submit(c.sid, c.stream[lo:hi]).accepted:
                        pos[c.sid] = hi
                    moved = True
            frames = srv.step()
            for sid, f in frames:
                print(json.dumps({"sid": sid,
                                  "f": durability.encode_frame(f)}),
                      flush=True)
                got_n += 1
            idle = 0 if (moved or frames) else idle + 1
            time.sleep(args.tick_sleep)
        for sid, f in srv.drain():
            print(json.dumps({"sid": sid,
                              "f": durability.encode_frame(f)}),
                  flush=True)
            got_n += 1
    print(json.dumps({"done": got_n}), flush=True)
    return 0


def run_sigkill_round(clients, oracle, workdir: str, seed: int,
                      n_lanes: int, frames_per_session: int,
                      tick_sleep: float = 0.05, device="cuda") -> dict:
    """One real process-death round: spawn the ``--child`` serving
    process on `device`, SIGKILL it once frames are flowing (mid
    chunk-step: the child sleeps between ticks, so the kill lands
    inside live journal and snapshot traffic), then recover the fleet
    in this process from the directory the corpse left behind, with
    the post-recovery budget pinned, and finish the streams. The
    child's flushed stdout lines are the delivered-frame record a real
    client would hold; a torn last line is dropped like a torn journal
    tail. A child that exits non-zero, or whose first line does not
    show this process's device, no nvcc run and this process's
    streams, fails the round."""
    import torch

    from ziria_tpu_torch.runtime import durability, serve

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    err = tempfile.TemporaryFile()
    child = subprocess.Popen(
        [sys.executable, "-m", "ziria_tpu_torch.tools.soak", "--child",
         "--dir", workdir, "--seed", str(seed),
         "--sessions", str(len(clients)), "--lanes", str(n_lanes),
         "--frames", str(frames_per_session),
         "--tick-sleep", str(tick_sleep), "--device", str(dev),
         "--threads", str(torch.get_num_threads())],
        stdout=subprocess.PIPE, stderr=err, cwd=_ROOT)
    lines: list = []
    kill_after = 1 + int(rng.integers(0, 2))
    killed = False

    def reader():
        for raw in child.stdout:
            lines.append(raw)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t_spawn = time.perf_counter()
    deadline = time.time() + 600
    try:
        while child.poll() is None and time.time() < deadline:
            n_frames = sum(1 for ln in lines if b'"sid"' in ln)
            if n_frames >= kill_after:
                time.sleep(float(rng.uniform(0.0, 2 * tick_sleep)))
                try:
                    os.kill(child.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                killed = True
                break
            time.sleep(0.01)
    finally:
        if child.poll() is None and not killed:
            child.kill()                 # past the deadline: no orphan
        child.wait(timeout=60)
        t.join(timeout=10)
    spawn_to_kill_s = time.perf_counter() - t_spawn
    err.seek(0)
    tail = err.read()[-4000:].decode(errors="replace")
    err.close()
    _gate(killed or child.returncode == 0,
          f"the soak child exited {child.returncode} before the kill:\n"
          f"{tail}")

    got = {c.sid: [] for c in clients}
    done = False
    head = None
    for raw in lines:
        try:
            d = json.loads(raw.decode())
        except Exception:  # noqa: BLE001 - a torn final line
            continue        # dropped like a torn tail
        if "child" in d:
            head = d["child"]
            continue
        if "done" in d:
            done = True
            continue
        got[d["sid"]].append(durability.decode_frame(d["f"]))
    _gate(head is not None, f"the soak child printed no first line:\n{tail}")
    _gate(head["device"] == str(dev),
          f"the soak child ran on {head['device']}, not {dev}")
    _gate(head["nvcc_builds"] == 0,
          f"the soak child ran nvcc {head['nvcc_builds']} time(s)")
    _gate(head["streams"] == _digest(clients),
          "the soak child's streams differ from this process's")

    recovery_s = 0.0
    post = None
    if not done:
        cfg = _config(n_lanes, workdir)
        t0 = time.perf_counter()
        srv2 = serve.ServeRuntime.recover(workdir, config=cfg, device=dev)
        recovery_s = time.perf_counter() - t0
        post = _finish_pinned(srv2, clients, got, dev)
    dups, checked = _verify(clients, oracle, got, set(), set())
    return {"recovery_s": recovery_s, "killed": killed,
            "kill_missed": done, "duplicates": dups,
            "frames_checked": checked,
            "pre_kill_frames": sum(1 for ln in lines if b'"sid"' in ln),
            "child": head, "spawn_to_kill_s": spawn_to_kill_s,
            "post_recovery": post}


# ------------------------------------------------------- kind rounds


def kind_rounds(n_sessions: int, n_lanes: int, frames_per_session: int,
                seed: int, root: str, device="cuda") -> list:
    """One in-process round for each entry of the three menus, that
    fault alone, on streams of `frames_per_session` frames (seed + 2)
    crashed only once their input is exhausted: long enough that every
    kind fires before the crash, which the campaign's rounds (crashed
    after 1-3 frames, one chunk-step in) do not reach for the dispatch
    and data kinds. Each round is gated as the campaign's are, with the
    post-recovery budget pinned, and its kind must fire. Returns each
    round's record."""
    from ziria_tpu_torch.utils import faults

    clients = _clients(n_sessions, frames_per_session, seed + 2,
                       device=device)
    oracle = _oracle(clients, device)
    out = []
    for i, (site, kind, kw) in enumerate(DISPATCH_MENU + DATA_MENU
                                         + IO_MENU):
        name = f"kind-{i}"
        cfg = _config(n_lanes, os.path.join(root, name), watchdog_s=2.0)
        ev = run_round(clients, oracle, cfg, seed + 31 * i, dirty=True,
                       budget=True, device=device,
                       specs=[faults.FaultSpec(site, kind, **kw)],
                       crash_after=1 << 30)
        _gate(ev["by_kind"].get(kind, 0) >= 1,
              f"{kind} at {site} never fired before the crash")
        out.append(dict(ev, round=name, site=site, kind=kind))
    return out


# --------------------------------------------------------- the harness


def soak_stats(n_sessions: int = 3, n_lanes: int = 4,
               frames_per_session: int = 4, rounds: int = 3,
               sigkill_rounds: int = 1, seed: int = 20260804,
               recovery_slo_s: float = 30.0,
               tick_sleep: float = 0.05,
               channel_profile: str = "urban", device="cuda",
               warm_tap=None, kind_frames: int = 0) -> dict:
    """The campaign: a fault-free warm pass to the drain, `rounds`
    in-process fault rounds (alternating clean-data and dirty-data
    draws; the last pins the post-recovery budget), one dirty round
    with every client's stream through `channel_profile` (an
    equalizable tap set, so its oracle is complete) against its own
    oracle, with `kind_frames` > 0 the :func:`kind_rounds` on streams of
    that many frames, and `sigkill_rounds` real process-death rounds
    (each recovered fleet pinned), all gated; the recovery times of
    the campaign's rounds aggregated to ``recovery_p99_s`` (the kind
    rounds' are gated by the same SLO and reported apart). `warm_tap`,
    a context manager, is entered around the warm pass
    (``chip_smoke.py`` records the fleet's first decode inputs
    there)."""
    import contextlib

    import torch

    from ziria_tpu_torch.runtime import serve

    dev = torch.device(device)
    clients = _clients(n_sessions, frames_per_session, seed, device=dev)
    oracle = _oracle(clients, dev)
    n_oracle = sum(len(v) for v in oracle.values())
    chan_clients = _clients(n_sessions, frames_per_session, seed + 1,
                            channel_profile=channel_profile, device=dev)
    chan_oracle = _oracle(chan_clients, dev)

    times: list = []
    named: dict = {}
    by_kind: dict = {}
    totals = {"faults": 0, "duplicates": 0, "deduped": 0,
              "snapshots": 0, "journal_errors": 0}
    posts: list = []
    children: list = []

    def tally(name, ev):
        times.append(ev["recovery_s"])
        named[name] = ev["recovery_s"]
        for k, v in ev["by_kind"].items():
            by_kind[k] = by_kind.get(k, 0) + v
        for k in totals:
            totals[k] += ev[k]
        if ev["post_recovery"] is not None:
            posts.append(dict(ev["post_recovery"], round=name))

    with tempfile.TemporaryDirectory(prefix="ziria-soak-") as root:
        # the warm pass, fault-free and served to its drain (at these
        # sizes a stream's frames decode only when its session closes):
        # the fleet's first scan and decode happen here, so no round's
        # watchdog meets a cold start and the budget rounds can pin no
        # build and no load; its frames are the oracle's
        warm = serve.ServeRuntime(
            _config(n_lanes, os.path.join(root, "warm"), 4), device=dev)
        got = {c.sid: [] for c in clients}
        with (warm_tap or contextlib.nullcontext()):
            _finish_recovered(warm, clients, got)
        _verify(clients, oracle, got, set(), set())

        for r in range(rounds):
            cfg = _config(n_lanes, os.path.join(root, f"round-{r}"),
                          watchdog_s=2.0)
            tally(f"round-{r}",
                  run_round(clients, oracle, cfg, seed + 17 * r,
                            dirty=bool(r % 2), budget=(r == rounds - 1),
                            device=dev))

        # the channel round: profiled streams (same geometry, own
        # oracle) under a dirty draw: physical and software chaos in
        # one campaign
        cfg = _config(n_lanes, os.path.join(root, "round-channel"),
                      watchdog_s=2.0)
        chan_ev = run_round(chan_clients, chan_oracle, cfg, seed + 991,
                            dirty=True, device=dev)
        tally("round-channel", chan_ev)

        kinds = []
        if kind_frames:
            kinds = kind_rounds(n_sessions, n_lanes, kind_frames, seed,
                                root, dev)
            posts += [dict(ev["post_recovery"], round=ev["round"])
                      for ev in kinds]

        kills = {"killed": 0, "kill_missed": 0}
        for r in range(sigkill_rounds):
            ev = run_sigkill_round(clients, oracle,
                                   os.path.join(root, f"kill-{r}"), seed,
                                   n_lanes, frames_per_session,
                                   tick_sleep=tick_sleep, device=dev)
            if ev["recovery_s"]:
                times.append(ev["recovery_s"])
                named[f"kill-{r}"] = ev["recovery_s"]
            if ev["post_recovery"] is not None:
                posts.append(dict(ev["post_recovery"], round=f"kill-{r}"))
            children.append(dict(ev["child"], killed=ev["killed"],
                                 pre_kill_frames=ev["pre_kill_frames"],
                                 spawn_to_kill_s=ev["spawn_to_kill_s"]))
            totals["duplicates"] += ev["duplicates"]
            kills["killed"] += int(ev["killed"])
            kills["kill_missed"] += int(ev["kill_missed"])

    p50 = float(np.percentile(times, 50)) if times else 0.0
    p99 = float(np.percentile(times, 99)) if times else 0.0
    _gate(p99 <= recovery_slo_s,
          f"recovery p99 {p99:.2f}s exceeds the {recovery_slo_s}s SLO")
    kind_s = {ev["round"]: ev["recovery_s"] for ev in kinds}
    _gate(max(kind_s.values(), default=0.0) <= recovery_slo_s,
          f"a kind round's recovery exceeds the {recovery_slo_s}s SLO: "
          f"{kind_s}")
    dpcs = [p["dpcs"] for p in posts if p["dpcs"] is not None]
    return {"sessions": n_sessions, "lanes": n_lanes,
            "rounds": rounds, "sigkill_rounds": sigkill_rounds,
            "device": str(dev), "oracle_frames": n_oracle,
            "faults_injected": totals["faults"],
            "faults_by_kind": by_kind,
            "recovery_p50_s": p50, "recovery_p99_s": p99,
            "recovery_s": named,
            "recovery_rounds_timed": len(times),
            "duplicates": totals["duplicates"],
            "deduped": totals["deduped"],
            "snapshots": totals["snapshots"],
            "journal_errors": totals["journal_errors"],
            "dispatches_per_chunk_step_post_recovery":
                max(dpcs) if dpcs else None,
            "budget_checked": bool(posts), "post_recovery": posts,
            "kills": kills, "children": children,
            "identity": "bit_identical",
            "channel_profile": channel_profile,
            "channel_round_frames": chan_ev["frames_checked"],
            "channel_round_faults": chan_ev["faults"],
            "kind_rounds": [{k: ev[k] for k in (
                "round", "site", "kind", "by_kind", "recovery_s",
                "frames_checked", "duplicates", "nan_sessions",
                "trunc_sessions")} for ev in kinds],
            "zero_crashes": True}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m ziria_tpu_torch.tools.soak",
        description="chaos-soak the durable serving runtime")
    p.add_argument("--child", action="store_true",
                   help="internal: the SIGKILL target serving loop")
    p.add_argument("--dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=0,
                   help="torch threads (0: torch's default)")
    p.add_argument("--seed", type=int, default=20260804)
    p.add_argument("--sessions", type=int, default=3)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--sigkill-rounds", type=int, default=1)
    p.add_argument("--kind-frames", type=int, default=0,
                   help="frames a session of the kind rounds (0: none)")
    p.add_argument("--tick-sleep", type=float, default=0.05)
    p.add_argument("--recovery-slo", type=float, default=30.0)
    args = p.parse_args(argv)
    if args.child:
        if not args.dir:
            raise SystemExit("--child needs --dir")
        return _child_main(args)
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    ev = soak_stats(args.sessions, args.lanes, args.frames,
                    args.rounds, args.sigkill_rounds, args.seed,
                    recovery_slo_s=args.recovery_slo,
                    tick_sleep=args.tick_sleep, device=args.device,
                    kind_frames=args.kind_frames)
    print(json.dumps(ev, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
