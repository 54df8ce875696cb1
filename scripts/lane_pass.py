"""Frame time of ``examples/wifi_rx.zir`` with and without the nested
lane pass.

The staged evaluator runs a statement loop whose iterations each hold
an inner reduction over their own locals (the LTS correlation of
``wifi_rx.zir``) as one lane-vector pass
(``frontend/eval.NESTED_LANE_PASS``); switched off, the loop runs as the
plain device loop. This script runs one ``channel.impaired_capture``
per rate (1000 bytes + FCS by default, the captures of
``chip_smoke.py``'s compiler phase) through the port's CLI on the
hybrid backend, chunk machines on, in the order on, off, off, on after
one warm-up run, and reports each run's host ms, device-loop
iterations, host syncs and chunk-machine steps, with the payload held
to its PSDU. Prints one JSON object.

    python3 scripts/lane_pass.py                       # on the card
    python3 scripts/lane_pass.py --platform cpu --bytes 20
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RATES = (54, 6)
SEED = 20261017


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bytes", type=int, default=1000)
    args = ap.parse_args()
    import numpy as np
    import torch

    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.phy import channel
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
        write_stream

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(here, "examples", "wifi_rx.zir")
    card = "cpu"
    if args.platform == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    report = {"platform": args.platform, "card": card,
              "torch": torch.__version__, "psdu_bytes": args.bytes,
              "rates": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for k, rate in enumerate(RATES):
            psdu, xi = channel.impaired_capture(
                rate, args.bytes, SEED + k, floor=0.02, add_fcs=True,
                device=args.platform)
            want = np.unpackbits(np.asarray(psdu), bitorder="little")
            cap = os.path.join(tmp, f"cap{rate}.bin")
            outf = os.path.join(tmp, f"cap{rate}.out")
            write_stream(StreamSpec(ty="complex16", path=cap, mode="bin"),
                         np.asarray(xi))
            argv = [f"--src={src}", f"--input-file-name={cap}",
                    "--input-file-mode=bin", f"--output-file-name={outf}",
                    "--output-file-mode=bin", "--backend=hybrid",
                    f"--platform={args.platform}"]
            runs = []
            for on in (True, True, False, False, True):
                E.NESTED_LANE_PASS = on
                try:
                    t0 = time.perf_counter()
                    rc = cli.main(argv)
                    ms = (time.perf_counter() - t0) * 1e3
                finally:
                    E.NESTED_LANE_PASS = True
                if rc != 0:
                    raise SystemExit(f"rate {rate}: rc {rc}")
                got = read_stream(StreamSpec(ty="bit", path=outf,
                                             mode="bin"))
                if not np.array_equal(got[: want.shape[0]], want):
                    raise SystemExit(f"rate {rate}, lane pass {on}: the "
                                     f"payload is wrong")
                r = cli.LAST_RUN
                runs.append({"lane_pass": on, "ms": ms,
                             "device_loop_iters": r["device_loop_iters"],
                             "syncs": r["syncs"],
                             "chunk_steps": r["chunk"]["device_calls"]})
            runs = runs[1:]            # the first warms the device
            mean = {on: float(np.mean([x["ms"] for x in runs
                                       if x["lane_pass"] == on]))
                    for on in (True, False)}
            report["rates"][str(rate)] = {
                "runs": runs, "on_ms_mean": mean[True],
                "off_ms_mean": mean[False],
                "off_over_on": mean[False] / mean[True]}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
