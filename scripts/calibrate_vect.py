"""Fit the vectorizer's utility-model constants on this machine's device.

``ziria_tpu_torch/core/vectorize.py`` scores a scale factor W with two
constants: ``vpu_parallel`` (how many parallel firings of a stateless
stage cost as much as one sequential firing of a stateful one) and
``step_overhead`` (a step's fixed cost, in sequential-firing units).
This script times the port's jit backend (``backend.lower``) on three
pipelines, one stateless, one stateful and one mixed, at a fixed ladder
of widths, by the marginal method: K1 and K2 chained steps, (t(K2) -
t(K1)) / (K2 - K1) per step, the best of 3 (CUDA events on the card,
the host clock on the CPU). It fits the constants as the reference's
``tools/calibrate_vect.py`` does (per-regime least squares: the
stateless slope gives the parallel cost per item, the stateful slope
the sequential one, the stateless intercept the step cost), reports
the fitted model's pick for each pipeline, and with ``--write`` stores
the row in ``ziria_tpu_torch/core/vect_calib.json`` under the platform, with the device's name and (on a
card) its power limit as pedigree.

    python3 scripts/calibrate_vect.py --device cpu --write
    python3 scripts/calibrate_vect.py --write          # on the card
    python3 scripts/calibrate_vect.py --write --calib OUT.json

Prints one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: widths probed (steady-state iterations per step) per platform and
#: regime: the stateless slope shows only at wide steps, while a
#: stateful stage's firings run one after another
LADDER = {"cuda": {"stateless": (1 << 20, 1 << 23, 1 << 26),
                   "stateful": (1 << 4, 1 << 6, 1 << 8)},
          "cpu": {"stateless": (1 << 14, 1 << 17, 1 << 20),
                  "stateful": (1 << 4, 1 << 6, 1 << 8)}}
K1, K2 = 2, 10


def _pipelines():
    """(name, comp): the three regimes the model trades off."""
    import torch

    import ziria_tpu_torch as z

    def fir_step(s, x):
        s = torch.cat([torch.as_tensor(x, dtype=s.dtype).reshape(1),
                       s[:-1]])
        w = torch.arange(1.0, 6.0, dtype=s.dtype, device=s.device)
        return s, (s * w).sum()

    stateless = z.pipe(z.zmap(lambda x: x * 2.0 + 1.0, name="axpy"),
                       z.zmap(lambda x: x * x, name="sq"))
    stateful = z.pipe(z.map_accum(fir_step, np.zeros(5, np.float32),
                                  name="fir5"))
    mixed = z.pipe(z.zmap(lambda x: x * 0.5, name="pre"),
                   z.map_accum(lambda s, x: (s + x, s + x),
                               np.float32(0.0), name="cumsum"),
                   z.zmap(lambda x: x + 3.0, name="post"))
    return [("stateless", stateless), ("stateful", stateful),
            ("mixed", mixed)]


def _time_width(comp, W: int, dev):
    """Marginal seconds per fused step at width W, and items a step."""
    import torch

    from ziria_tpu_torch.backend.lower import lower

    low = lower(comp, width=W, device=dev)
    xs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(low.take,)).astype(np.float32)).to(dev)
    on_card = dev.type == "cuda"

    def chain(k):
        carry = low.init_carry
        for _ in range(k):
            carry, _y = low.step(carry, xs)
        return carry

    def timed(k):
        best = float("inf")
        chain(k)                                   # warm-up
        for _ in range(3):
            if on_card:
                torch.cuda.synchronize(dev)
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                chain(k)
                ev[1].record()
                torch.cuda.synchronize(dev)
                dt = ev[0].elapsed_time(ev[1]) / 1e3
            else:
                t0 = time.perf_counter()
                chain(k)
                dt = time.perf_counter() - t0
            best = min(best, dt)
        return best

    with torch.no_grad():
        t1, t2 = timed(K1), timed(K2)
    return max((t2 - t1) / (K2 - K1), 1e-9), low.take


def _fit(tables: dict) -> dict:
    """The two constants from the stateless and stateful tables (the
    reference's per-regime least squares)."""
    def slope_intercept(name):
        tab = tables[name]
        W = np.array([r["W"] for r in tab], float)
        t = np.array([r["s_per_step"] for r in tab], float)
        b, a = np.polyfit(W, t, 1)
        return b, max(a, 0.0)

    b_sl, a_sl = slope_intercept("stateless")   # slope = 2 * b_par
    b_sf, _ = slope_intercept("stateful")       # slope = b_seq
    b_par = max(b_sl / 2.0, 1e-15)
    b_seq = max(b_sf, 1e-15)
    return {"a_s": float(a_sl), "b_par_s": float(b_par),
            "b_seq_s": float(b_seq),
            "vpu_parallel": float(b_seq / b_par),
            "step_overhead": float(a_sl / b_seq)}


def _card(dev) -> str:
    if dev.type != "cuda":
        import platform
        return f"CPU ({platform.processor() or platform.machine()})"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch
        return torch.cuda.get_device_name(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--write", action="store_true",
                    help="store the fitted row in core/vect_calib.json")
    ap.add_argument("--calib", metavar="PATH",
                    help="write the updated calibration file here instead "
                         "(a run on another machine, to copy back)")
    args = ap.parse_args()

    import torch

    from ziria_tpu_torch.core import vectorize as V

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    plat = V.active_platform(dev)
    tables = {}
    for name, comp in _pipelines():
        tab = []
        for W in LADDER[plat]["stateless" if name == "stateless"
                              else "stateful"]:
            t, take = _time_width(comp, W, dev)
            tab.append({"W": W, "s_per_step": t, "items_per_s": take / t})
        tables[name] = tab
    fit = _fit(tables)
    card = _card(dev)
    consts = {"vpu_parallel": fit["vpu_parallel"],
              "step_overhead": fit["step_overhead"],
              "pedigree": f"measured by scripts/calibrate_vect.py on "
                          f"{card}, torch {torch.__version__}"}
    picks = {}
    for name, comp in _pipelines():
        plan = V.vectorize(comp, constants=consts)
        picks[name] = plan.segments[0].width
    report = {"platform": plat, "card": card, "torch": torch.__version__,
              "ladder": LADDER[plat], "tables": tables, "fit": fit,
              "model_picks": picks}
    if args.write:
        with open(V.CALIB_FILE) as f:
            doc = json.load(f)
        doc["platforms"][plat] = dict(consts, card=card, fit=fit,
                                      tables=tables)
        path = args.calib or V.CALIB_FILE
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        report["written"] = path
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
