"""Host share of stream parsing and formatting in CLI runs.

Runs the port's CLI (``python -m ziria_tpu_torch``'s ``main``) with
``--trace`` on two golden cases, one ``dbg`` (text) and one ``bin``
(bit-packed), and on one 1000-byte ``examples/wifi_rx.zir`` capture,
each twice (the first warms the device and the caches), with the CLI's
``read_stream`` and ``write_stream`` (``runtime/buffers``: dbg text
parse and format, bit pack and unpack) wrapped in telemetry spans of
those names for the run, and reads their host ms from each trace
against the whole call. Prints one JSON object; ``share`` is (read +
write) / whole.

    python3 scripts/io_share.py --platform cpu
    python3 scripts/io_share.py                  # on the card
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

CASES = (("scrambler", "dbg", "jit"), ("wifi_rx", "bin", "hybrid"))
WIFI_RATE, WIFI_BYTES, WIFI_SEED = 54, 1000, 20261017


def _spans(path):
    with open(path) as f:
        obj = json.load(f)
    ev = obj["traceEvents"] if isinstance(obj, dict) else obj
    out = {}
    for e in ev:
        if e.get("ph") == "X" and e.get("name", "").startswith("cli."):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def _spanned(name, fn):
    from ziria_tpu_torch.utils import telemetry

    def call(*a, **k):
        with telemetry.span(name):
            return fn(*a, **k)
    return call


def _one(argv, trace):
    from ziria_tpu_torch.runtime import cli
    real = cli.read_stream, cli.write_stream
    cli.read_stream = _spanned("cli.read_stream", real[0])
    cli.write_stream = _spanned("cli.write_stream", real[1])
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv + [f"--trace={trace}"])
    finally:
        cli.read_stream, cli.write_stream = real
    whole = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        raise SystemExit(f"{argv}: rc {rc}")
    sp = _spans(trace)
    io = sp.get("cli.read_stream", 0.0) + sp.get("cli.write_stream", 0.0)
    return {"read_ms": sp.get("cli.read_stream"),
            "write_ms": sp.get("cli.write_stream"), "whole_ms": whole,
            "share": io / whole}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import numpy as np
    import torch

    from ziria_tpu_torch.phy import channel
    from ziria_tpu_torch.runtime.buffers import StreamSpec, write_stream

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ex = os.path.join(here, "examples")
    card = "cpu"
    if args.platform == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    report = {"platform": args.platform, "card": card,
              "torch": torch.__version__, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for name, mode, backend in CASES:
            runs.append((f"{name}_{mode}", [
                f"--src={os.path.join(ex, name + '.zir')}",
                f"--input-file-name="
                f"{os.path.join(ex, 'golden', name + '.infile')}",
                f"--input-file-mode={mode}",
                f"--output-file-name={os.path.join(tmp, name + '.out')}",
                f"--output-file-mode={mode}", f"--backend={backend}",
                f"--platform={args.platform}"]))
        _psdu, xi = channel.impaired_capture(
            WIFI_RATE, WIFI_BYTES, WIFI_SEED, floor=0.02, add_fcs=True,
            device=args.platform)
        cap = os.path.join(tmp, "cap.bin")
        write_stream(StreamSpec(ty="complex16", path=cap, mode="bin"),
                     np.asarray(xi))
        runs.append((f"wifi_rx_{WIFI_RATE}mbps_{WIFI_BYTES}B", [
            f"--src={os.path.join(ex, 'wifi_rx.zir')}",
            f"--input-file-name={cap}", "--input-file-mode=bin",
            f"--output-file-name={os.path.join(tmp, 'cap.out')}",
            "--output-file-mode=bin", "--backend=hybrid",
            f"--platform={args.platform}"]))
        for name, argv in runs:
            _one(argv, os.path.join(tmp, "warm.json"))
            report["runs"][name] = _one(argv, os.path.join(tmp, "t.json"))
    report["max_share"] = max(r["share"] for r in report["runs"].values())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
