"""Geometry autotuner: a cost-pruned, measured search over the
receivers' tunables (counterpart of ziria_tpu/utils/autotune.py:
``default_candidates`` :67, ``stream_chunk_cost`` :97, ``prune`` :123,
the emission fingerprints :152-168, ``Measurer`` :184, ``run`` :250
and ``main`` :354, the ``autotune`` subcommand).

1. **Enumerate** candidates around the default
   (:func:`default_candidates`): the chunk-length ladder, the radix-4
   ACS, ``fused_demap`` and chunk x2 with ``fused_demap``.
2. **Prune** on cost (:func:`stream_chunk_cost`): the chunk scan's
   bytes (inputs read once, outputs written once) and FLOPs
   (``FlopCounterMode``) per owned stream sample, from one call of
   ``rx.stream_chunk_graph`` on a zero chunk at the candidate's
   geometry through ``programs.cost_of``. A candidate that costs more
   per sample than the default, past ``PRUNE_SLACK``, is never
   measured.
3. **Measure** the survivors (:class:`Measurer`): the port's
   ``StreamReceiver`` over a synthesized multi-frame stream (samples/s,
   chunk p50/p99 off the telemetry histograms) and the fused link
   (frames/s), on the host clock and, on the card, CUDA events; then
   the identity gate: a candidate whose emissions differ field for
   field from the default's is rejected, however fast.

The winner (best stream samples/s among the identity-clean; the
default competes) is appended as a ``stage="autotune"`` record keyed by
``device_kind`` to the port's own record file
(``geometry.env_trajectory_path``: ``TORCH_TUNED.jsonl`` at the repo
root or ``ZIRIA_TORCH_TUNED``), which ``Geometry.tuned`` reads back.
``cost_fn`` and ``measure_fn`` are injectable.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ziria_tpu_torch.utils.geometry import (Geometry, detect_device_kind,
                                            env_trajectory_path)

#: a candidate may cost this much more per owned sample than the
#: default before the prune rejects it
PRUNE_SLACK = 0.02

Candidate = Tuple[str, Geometry]


def default_candidates(base: Geometry) -> List[Candidate]:
    """The neighbourhood of a resolved ``base``: chunk length halved,
    doubled and quadrupled (where it stays above ``frame_len``), the
    radix-4 ACS, ``fused_demap``, and chunk x2 with ``fused_demap``.
    ``frame_len`` and the detector stay fixed: they are part of what
    the identity gate compares."""
    out: List[Candidate] = []
    for cl in (base.chunk_len // 2, base.chunk_len * 2,
               base.chunk_len * 4):
        if cl > base.frame_len:
            out.append((f"chunk{cl}", base.replace(chunk_len=cl)))
    if base.viterbi_radix != 4:
        out.append(("radix4", base.replace(viterbi_radix=4)))
    if not base.fused_demap:
        out.append(("fused_demap", base.replace(fused_demap=True)))
        cl2 = base.chunk_len * 2
        if cl2 > base.frame_len:
            out.append((f"chunk{cl2}_fused",
                        base.replace(chunk_len=cl2, fused_demap=True)))
    return out


def stream_chunk_cost(geo: Geometry, device="cuda") -> Dict[str, float]:
    """Bytes and FLOPs of the candidate's chunk scan per owned sample
    (a chunk re-reads ``frame_len`` samples of overlap, so the owned
    part is ``chunk_len - frame_len``): one ``rx.stream_chunk_graph``
    call on a zero chunk on ``device`` under ``programs.cost_of``.
    Its shapes, and so its bytes and counted FLOPs, depend on the
    geometry only."""
    import torch

    from ziria_tpu_torch.ops import cplx
    from ziria_tpu_torch.phy.wifi import rx as _rx
    from ziria_tpu_torch.utils import programs

    n_sym_bucket = geo.sym_bucket(
        max(1, (geo.frame_len - _rx.FRAME_DATA_START) // 80))
    chunk = torch.zeros((1, geo.chunk_len, 2), dtype=torch.float32,
                        device=device)
    lanes = torch.tensor([[geo.chunk_len], [-192],
                          [geo.chunk_len - geo.frame_len]], device=device)

    def scan(c, valid, own_lo, own_hi):
        with cplx.exact_fp32():
            return _rx.stream_chunk_graph(
                c, valid, own_lo, own_hi, geo.max_frames_per_chunk,
                geo.frame_len, n_sym_bucket, float(geo.threshold),
                int(geo.min_run), int(geo.dead_zone))

    c = programs.cost_of(scan, chunk, *lanes)
    owned = geo.chunk_len - geo.frame_len
    return {"bytes_per_sample": c["bytes_accessed"] / owned,
            "flops_per_sample": c["flops"] / owned}


def prune(candidates: Sequence[Candidate], base_cost: Dict[str, float],
          cost_fn: Callable[[Geometry], Dict[str, float]],
          slack: float = PRUNE_SLACK):
    """(survivors, rejected): a candidate whose bytes or FLOPs per
    sample exceed the default's by more than ``slack`` is rejected."""
    survivors: List[Tuple[str, Geometry, Dict[str, float]]] = []
    rejected: List[Dict[str, Any]] = []
    for label, geo in candidates:
        c = cost_fn(geo)
        worse_bytes = c["bytes_per_sample"] > \
            base_cost["bytes_per_sample"] * (1.0 + slack)
        worse_flops = c["flops_per_sample"] > \
            base_cost["flops_per_sample"] * (1.0 + slack)
        if worse_bytes or worse_flops:
            rejected.append({
                "label": label, "reason": "cost",
                "bytes_per_sample": round(c["bytes_per_sample"], 3),
                "flops_per_sample": round(c["flops_per_sample"], 3),
            })
        else:
            survivors.append((label, geo, c))
    return survivors, rejected


def _stream_fingerprint(frames) -> Tuple:
    """A stream run's emissions field for field, failures included."""
    return tuple(
        (int(f.start), bool(f.result.ok), bool(f.result.crc_ok),
         int(f.result.rate_mbps), int(f.result.length_bytes),
         np.asarray(f.result.psdu_bits).tobytes())
        for f in frames)


def _link_fingerprint(results) -> Tuple:
    return tuple(
        (bool(r.ok), bool(r.crc_ok), int(r.rate_mbps),
         int(r.length_bytes), np.asarray(r.psdu_bits).tobytes())
        for r in results)


def _chunk_latency_ms(reg) -> Dict[str, float]:
    """p50 and p99 of the chunk-scan site off the registry's histogram
    (upper bounds of power-of-two buckets)."""
    from ziria_tpu_torch.utils import telemetry

    for (name, labels), m in reg.metrics():
        if name == telemetry.DISPATCH_HISTOGRAM and \
                dict(labels).get("site") == "rx.stream_chunk":
            s = m.summary(scale=1e3, ndigits=4)
            return {"p50_ms": s.get("p50"), "p99_ms": s.get("p99")}
    return {}


class Measurer:
    """The hardware measurer: one shared stimulus, then per candidate a
    warm-up and ``reps`` timed passes of the stream receiver and of the
    fused link, with the chunk latency and both fingerprints. On the
    card the timed passes are also timed under CUDA events
    (``cuda_ms``)."""

    def __init__(self, n_frames: int = 8, n_bytes: int = 24,
                 seed: int = 8, reps: int = 2, device="cuda"):
        self.n_frames = int(n_frames)
        self.n_bytes = int(n_bytes)
        self.seed = int(seed)
        self.reps = max(1, int(reps))
        self.device = device
        self._stim = None

    def _stimulus(self):
        if self._stim is None:
            from ziria_tpu_torch.phy import link
            from ziria_tpu_torch.phy.wifi.params import RATES

            rng = np.random.default_rng(self.seed)
            rates = (sorted(RATES)
                     * (-(-self.n_frames // len(RATES))))[:self.n_frames]
            psdus = [rng.integers(0, 256, self.n_bytes).astype(np.uint8)
                     for _ in range(self.n_frames)]
            stream, starts = link.stream_many(
                psdus, rates, snr_db=30.0, cfo=1e-4, delay=60,
                seed=self.seed, add_fcs=True, tail=2048,
                device=self.device)
            self._stim = (stream, starts, psdus, rates)
        return self._stim

    def _timed(self, fn):
        """(last result, host seconds, CUDA-event ms or None) of
        ``reps`` calls of ``fn``."""
        import torch

        card = torch.device(self.device).type == "cuda"
        if card:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        for _ in range(self.reps):
            out = fn()
        dt = time.perf_counter() - t0
        ms = None
        if card:
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
        return out, dt, ms

    def __call__(self, geo: Geometry) -> Dict[str, Any]:
        from ziria_tpu_torch.backend import framebatch
        from ziria_tpu_torch.phy import link
        from ziria_tpu_torch.utils import telemetry

        stream, _starts, psdus, rates = self._stimulus()
        kw = dict(geometry=geo, check_fcs=True, streaming=True,
                  device=self.device)
        framebatch.receive_stream(stream, **kw)               # warm-up
        with telemetry.collect() as reg:
            (frames, _st), dt, ms = self._timed(
                lambda: framebatch.receive_stream(stream, **kw))
        n = stream.shape[0] * self.reps
        lkw = dict(add_fcs=True, check_fcs=True, geometry=geo,
                   device=self.device)
        link.loopback_many(psdus, rates, **lkw)               # warm-up
        res, ldt, lms = self._timed(
            lambda: link.loopback_many(psdus, rates, **lkw))
        m = len(psdus) * self.reps
        out: Dict[str, Any] = {
            "sps": n / dt if dt > 0 else 0.0,
            "fps": m / ldt if ldt > 0 else 0.0,
            "fingerprint": (_stream_fingerprint(frames),
                            _link_fingerprint(res)),
        }
        if ms is not None:
            out.update(cuda_sps=n / ms * 1e3 if ms > 0 else 0.0,
                       cuda_fps=m / lms * 1e3 if lms > 0 else 0.0)
        out.update(_chunk_latency_ms(reg))
        return out


def run(base: Optional[Geometry] = None,
        candidates: Optional[Sequence[Candidate]] = None,
        cost_fn: Optional[Callable] = None,
        measure_fn: Optional[Callable] = None,
        n_frames: int = 8, n_bytes: int = 24, seed: int = 8,
        reps: int = 2, slack: float = PRUNE_SLACK,
        record: bool = True, path: Optional[str] = None,
        device_kind: Optional[str] = None,
        platform: Optional[str] = None, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Enumerate, cost-prune, measure, identity-gate, pick the winner
    and (with ``record``) append its record to the record file.
    Deterministic given ``cost_fn`` and ``measure_fn``; returns the
    search's evidence."""
    import torch

    base = (base if base is not None else Geometry()).resolve()
    cands = list(candidates if candidates is not None
                 else default_candidates(base))
    cost_fn = cost_fn or (lambda g: stream_chunk_cost(g, device))
    measure_fn = measure_fn or Measurer(n_frames=n_frames,
                                        n_bytes=n_bytes, seed=seed,
                                        reps=reps, device=device)

    base_cost = cost_fn(base)
    survivors, pruned = prune(cands, base_cost, cost_fn, slack)
    log(f"autotune: {len(cands)} candidate(s), cost-pruned "
        f"{len(pruned)} ({', '.join(r['label'] for r in pruned) or '-'})"
        f", measuring {len(survivors)} + default")

    base_m = measure_fn(base)
    base_fp = base_m.get("fingerprint")

    def row(label, m):
        return {"label": label, "sps": m["sps"], "fps": m.get("fps"),
                "cuda_sps": m.get("cuda_sps"), "cuda_fps": m.get("cuda_fps"),
                "p50_ms": m.get("p50_ms"), "p99_ms": m.get("p99_ms")}

    measured = [row("default", base_m)]
    best_label, best_geo, best_sps = "default", base, base_m["sps"]
    identity_rejected: List[str] = []
    for label, geo, _cost in survivors:
        m = measure_fn(geo)
        if base_fp is not None and m.get("fingerprint") != base_fp:
            identity_rejected.append(label)
            log(f"autotune: {label} REJECTED: emissions differ from the "
                f"default geometry's (identity gate)")
            continue
        measured.append(row(label, m))
        log(f"autotune: {label}: {m['sps']:.0f} sps "
            f"({m['sps'] / base_m['sps']:.2f}x default)")
        if m["sps"] > best_sps:
            best_label, best_geo, best_sps = label, geo, m["sps"]

    speedup = best_sps / base_m["sps"] if base_m["sps"] else 1.0
    if device_kind is None:
        device_kind = detect_device_kind()
    if platform is None:
        platform = torch.device(device).type
    rec = {
        "run_id": f"autotune-{int(time.time())}",
        "unix": round(time.time(), 1),
        "stage": "autotune", "metric": "sps_tuned",
        "value": best_sps, "platform": platform, "partial": False,
        "direction": "higher", "source": "autotune",
        "device_kind": device_kind,
        "geometry": best_geo.as_dict(),
        "winner": best_label,
        "baseline_sps": base_m["sps"],
        "speedup": round(speedup, 4),
    }
    out = {
        "winner": best_label, "geometry": best_geo.as_dict(),
        "sps_tuned": best_sps, "baseline_sps": base_m["sps"],
        "speedup": round(speedup, 4), "device_kind": device_kind,
        "platform": platform, "candidates": len(cands),
        "pruned": pruned, "identity_rejected": identity_rejected,
        "measured": measured, "record": rec,
    }
    if record:
        p = path or env_trajectory_path()
        try:
            with open(p, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(rec) + "\n")
            out["recorded_to"] = p
            log(f"autotune: winner '{best_label}' ({speedup:.2f}x "
                f"default) recorded for device_kind={device_kind!r} -> {p}")
        except OSError as e:       # an unwritable file never fails a run
            out["record_error"] = repr(e)
            log(f"autotune: record file unwritable ({e!r}); winner not "
                f"recorded")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m ziria_tpu_torch autotune``: the measured search, sized
    for a smoke by default (pass --frames and --reps up for a real
    run), on the card unless ``--platform=cpu``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="ziria_tpu_torch autotune",
        description="cost-pruned measured geometry search; the winner "
                    "is recorded per card for Geometry.tuned()")
    ap.add_argument("--frames", type=int, default=8,
                    help="stimulus frames per measurement (default 8)")
    ap.add_argument("--bytes", type=int, default=24, dest="n_bytes",
                    help="PSDU bytes per stimulus frame (default 24)")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed repetitions per candidate (default 2)")
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--ledger", default=None,
                    help="record file (default: ZIRIA_TORCH_TUNED or "
                         "TORCH_TUNED.jsonl at the repo root)")
    ap.add_argument("--dry-run", action="store_true",
                    help="search and report but do not record")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU; with no card it "
                         "raises unless --platform=cpu is given")
    args = ap.parse_args(argv)

    from ziria_tpu_torch.phy.wifi.rx import check_device
    dev = check_device(args.platform, "autotune --platform")
    out = run(n_frames=args.frames, n_bytes=args.n_bytes,
              reps=args.reps, seed=args.seed, record=not args.dry_run,
              path=args.ledger, device=dev)
    tuned = Geometry.tuned(out["device_kind"],
                           path=None if args.dry_run else args.ledger)
    print(json.dumps({k: out[k] for k in
                      ("winner", "sps_tuned", "baseline_sps", "speedup",
                       "device_kind", "platform", "identity_rejected")},
                     default=str))
    MAIN_RESULT.clear()
    MAIN_RESULT.update(out)
    if not args.dry_run and out.get("recorded_to"):
        ok = tuned.as_dict() == out["geometry"]
        print(f"Geometry.tuned({out['device_kind']!r}) "
              f"{'reproduces the winner' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


#: the last main() call's search result (for in-process callers such as
#: chip_smoke.py)
MAIN_RESULT: Dict[str, Any] = {}
