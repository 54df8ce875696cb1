"""The control of the comparison that decides ``correct``: the plain
reference receiver put in the port's place and computed one precision
below the configuration's float32, in bfloat16, on the cell's own
traffic at its own size. Its answers go through the same comparison as
the port's; the comparison has to refuse them. The benchmark's runs do
not run it.

    python3 benchmark/control.py --workload <name> --seeds a,b,c \
        [--dtype bfloat16] [--device cuda]

Prints one JSON line a seed: each number the comparison reads for the
reference at ``--dtype`` in the port's place (``wrong_frames`` against
the generator's truth, ``reference_mismatch`` against the float32
reference on the cell's seeded sample), and the seconds it took.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Answer(NamedTuple):
    """A reference answer in the shape of the port's ``RxResult``."""
    ok: bool
    rate_mbps: int
    length_bytes: int
    psdu_bits: np.ndarray
    crc_ok: object


def _answer(d) -> Answer:
    return Answer(d["ok"], d["rate_mbps"], d["length_bytes"],
                  d["psdu_bits"], d["crc_ok"])


def readings(workload: str, seed: int, dtype, device, overrides=None):
    """The comparison's numbers with the reference at `dtype` in the
    port's place, on the cell's traffic from `seed`."""
    from benchmark import check, generator
    from benchmark.run import ROOT as _root, cell, load_json

    _wl, _cfg, mix = cell(load_json(_root, "BENCHMARK.json"), workload)
    if overrides:
        mix = {**mix, **overrides}
    rng = np.random.default_rng([seed % (1 << 64), 1])
    if mix["kind"] == "captures":
        pool, truth = generator.make_captures(mix, seed, device)
        caps = [c for b in pool for c in b]
        frames = [f for t in truth for f in t]
        starts = [0] * len(caps)
    else:
        loops, truth = generator.make_streams(mix, seed, device)
        caps, frames, starts = [], [], []
        for i, fs in enumerate(truth):
            ext = np.concatenate([loops[i], loops[i]])
            for fr in fs:
                lo = fr.start - 400 + loops[i].shape[0]
                caps.append(ext[lo:lo + 400 + fr.n_samples + 80])
                frames.append(fr)
                starts.append(fr.start - 400)
    t0 = time.perf_counter()
    got = check.reference_frames(caps, dtype, device, block=512)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    wrong = sum(not (check.same_result(_answer(g), fr)
                     and g["start"] + lo == fr.start)
                for g, fr, lo in zip(got, frames, starts))
    picks = rng.choice(len(caps), min(64, len(caps)), replace=False)
    ref = check.reference_frames([caps[int(k)] for k in picks])
    mismatch = sum(
        not check.same_as_reference(_answer(got[int(k)]), r, frames[int(k)],
                                    starts[int(k)],
                                    got[int(k)]["start"] + starts[int(k)])
        for k, r in zip(picks, ref))
    return {"workload": workload, "seed": seed, "dtype": str(dtype),
            "frames": len(caps), "wrong_frames": wrong,
            "reference_mismatch": mismatch, "reference_sample": len(picks),
            "seconds": seconds}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s),
                                  getattr(torch, args.dtype), dev)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT    # the checkout, not benchmark/: no module shadowing
    sys.exit(main())
