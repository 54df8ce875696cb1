"""Cost of running every DFT matmul of the port at one shape.

``ziria_tpu_torch.ops.cplx.dft_pair`` runs its float32 matmuls in fixed
row blocks (``cplx.DFT_BLOCK_ROWS``) so that a lane's values do not
depend on the batch it rides in. This script times, on a CUDA card,
``dft_pair`` and the two decode fronts (``rx.mixed_front``,
``rx._front_symbols``) at the fleets' and the batch's shapes, for the
product at each call's own row count ("one", batch-dependent) and for
several block sizes, in turns (the order reversed every round), host
clock around each call ended by a synchronize. Prints one JSON object:
the median ms of each (case, variant) and the card.

    python3 scripts/dft_blocks.py [--rounds 10]
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

BLOCKS = (2048, 4096, 8192, 16384)


def one_product(cplx, torch):
    """The DFT as one product at the call's own row count."""
    def dft_pair(p, inverse=False):
        n = p.shape[-2]
        ct, st = cplx._dft_mats_t(n, inverse, p.device)
        xr, xi = p[..., 0], p[..., 1]
        return torch.stack([xr @ ct - xi @ st, xr @ st + xi @ ct], dim=-1)
    return dft_pair


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dft_blocks: no CUDA card", file=sys.stderr)
        return 1
    from ziria_tpu_torch.ops import cplx
    from ziria_tpu_torch.phy.wifi import rx

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    blocked = cplx.dft_pair
    variants = {"one": one_product(cplx, torch)}
    variants.update({f"block_{b}": b for b in BLOCKS})

    def use(v):
        if isinstance(variants[v], int):
            cplx.DFT_BLOCK_ROWS["cuda"] = variants[v]
            cplx.dft_pair = blocked
        else:
            cplx.dft_pair = variants[v]

    def frames(b, nsb):
        x = rng.normal(size=(b, rx.FRAME_DATA_START + 80 * nsb, 2))
        ridx = rng.integers(0, 8, b)
        nbits = rng.integers(24, nsb * 216, b)
        return (torch.from_numpy(x.astype(np.float32)).to(dev), ridx,
                torch.from_numpy(nbits).to(dev), nsb)

    cases = {}
    for rows in (64, 4096, 32768, 65536):
        x = torch.from_numpy(rng.normal(size=(rows, 64, 2)).astype(
            np.float32)).to(dev)
        cases[f"dft_{rows}_rows"] = (lambda x=x: cplx.fft_pair(x))
    for name, (b, nsb) in {"fleet_default_64x32": (64, 32),
                           "fleet_wide_64x512": (64, 512),
                           "batch_128x512": (128, 512)}.items():
        f, ridx, nbits, nsb = frames(b, nsb)
        cases[f"mixed_front_{name}"] = (
            lambda f=f, r=ridx, nb=nbits, s=nsb: rx.mixed_front(f, r, nb, s))
        cases[f"front_symbols_{name}"] = (
            lambda f=f, s=nsb: rx._front_symbols(f, s))

    times = {c: {v: [] for v in variants} for c in cases}
    order = list(variants)
    with cplx.exact_fp32():
        for v in order:                       # warm-up: every shape once
            use(v)
            for fn in cases.values():
                fn()
        torch.cuda.synchronize()
        for r in range(args.rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                use(v)
                for c, fn in cases.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[c][v].append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "card": card.strip(), "rounds": args.rounds,
        "median_ms": {c: {v: float(np.median(t)) for v, t in tv.items()}
                      for c, tv in times.items()},
        "quartiles_ms": {c: {v: [float(np.percentile(t, 25)),
                                 float(np.percentile(t, 75))]
                             for v, t in tv.items()}
                         for c, tv in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
