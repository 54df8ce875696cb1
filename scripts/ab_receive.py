#!/usr/bin/env python3
"""Time ``receive_many`` on the card for two checkouts of the repo, in
turns, each run in a process of its own.

    python3 scripts/ab_receive.py A_DIR B_DIR [--rounds 3] [--reps 5]

Each round runs A, B, B, A. A run imports the port and ``chip_smoke``
from its own checkout, builds (or reuses) that checkout's kernels, makes
``chip_smoke.B`` captures from one seed with that checkout's
``chip_smoke.make_captures``, decodes each mode twice to warm up, then
times ``reps`` batches of each mode, the modes in turns, on the host
clock with the card synchronized before and after (``chip_smoke.host_ms``).
It also times the checkout's ``cplx.fft_pair`` of a 16,384 x 64 batch
under CUDA events (mean of 50 calls after 5) and one entry and exit of
its ``cplx.exact_fp32`` (best of 3 x 10,000). Each run prints one JSON
line; the last line gives each side's median ms per mode over all its
batches, each run's DFT ms and guard ns, and the card's name and power
limit. Needs a CUDA card: without one every run fails
and so does the script.
"""

import argparse
import json
import os
import subprocess
import sys
import time

MODES = {"default": {}, "fused": {"fused_demap": True}}


def worker(root: str, reps: int, seed: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from ziria_tpu_torch import cuda_build
    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import cplx

    chip_smoke.check(torch.cuda.is_available(), "no CUDA card")
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    caps, _sent, _rates = chip_smoke.make_captures(
        np.random.default_rng(seed), dev)

    def batch(knobs):
        return lambda: framebatch.receive_many(caps, check_fcs=True,
                                               device=dev, **knobs)
    for knobs in MODES.values():
        for _ in range(2):
            batch(knobs)()
    ms = {m: [] for m in MODES}
    for _ in range(reps):
        for m, knobs in MODES.items():
            ms[m].append(chip_smoke.host_ms(batch(knobs))[1])
    p = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (16384, 64, 2), dtype=np.float32)).to(dev)
    chip_smoke.cuda_ms(lambda: cplx.fft_pair(p), reps=5)
    fft_ms = chip_smoke.cuda_ms(lambda: cplx.fft_pair(p), reps=50)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10000):
            with cplx.exact_fp32():
                pass
        best = min(best, (time.perf_counter() - t0) / 10000)
    return {"root": root, "torch": torch.__version__, "ms": ms,
            "fft_ms": fft_ms, "guard_ns": best * 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps, args.seed)),
              flush=True)
        return 0
    if not (args.a and args.b):
        ap.error("give two checkouts, A_DIR and B_DIR")
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 getattr(args, side), "--reps", str(args.reps),
                 "--seed", str(args.seed)],
                capture_output=True, text=True, timeout=900, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(line, side=side)), flush=True)
            runs[side].append(line)
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        "nvidia_smi": smi, "rounds": args.rounds, "reps": args.reps,
        "median_ms": {side: {m: float(np.median(
            [v for r in rs for v in r["ms"][m]])) for m in MODES}
            for side, rs in runs.items()},
        "fft_ms": {side: [r["fft_ms"] for r in rs]
                   for side, rs in runs.items()},
        "guard_ns": {side: [r["guard_ns"] for r in rs]
                     for side, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
