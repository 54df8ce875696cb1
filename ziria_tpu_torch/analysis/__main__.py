"""CLI of the static analysis: ``python -m ziria_tpu_torch.analysis``
(counterpart of ziria_tpu/analysis/__main__.py).

Pure AST, with no torch import, so it runs on a machine without a card
or a CUDA build. Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def _default_target() -> str:
    """The port's own package directory: with no arguments the lint
    covers the checkout it runs from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    from ziria_tpu_torch.analysis.engine import lint_paths
    from ziria_tpu_torch.analysis.rules import ALL_RULES, NOT_RUN, \
        RULES_BY_ID

    p = argparse.ArgumentParser(
        prog="ziria_tpu_torch lint",
        description="AST static analysis of the port: host syncs in "
                    "timed regions, untimed launches, env, cache and "
                    "geometry hygiene")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "ziria_tpu_torch package directory)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (findings, per-rule "
                        "counts, suppressed count)")
    p.add_argument("--rules", metavar="R1,R2,...",
                   help="run only these rule ids")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)

    if args.list_rules:
        for rid, why in NOT_RUN.items():
            print(f"{rid}  {why}")
        for r in ALL_RULES:
            print(f"{r.id}  {r.name}: {r.why}")
        return 0

    rules = None
    if args.rules:
        ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in ids if r not in RULES_BY_ID]
        off = [r for r in unknown if r in NOT_RUN]
        if off:
            print(f"rule(s) {', '.join(off)} have no counterpart in the "
                  f"port and are not run (--list-rules)", file=sys.stderr)
            return 2
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)} "
                  f"(known: {', '.join(RULES_BY_ID)})", file=sys.stderr)
            return 2
        rules = [RULES_BY_ID[r] for r in ids]

    paths = args.paths or [_default_target()]
    missing = [q for q in paths if not os.path.exists(q)]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    res = lint_paths(paths, rules=rules)
    if args.json:
        print(res.to_json())
    else:
        for f in res.findings:
            print(f.render())
        counts = " ".join(f"{k}={v}" for k, v in
                          sorted(res.counts.items()))
        print(f"lint: {len(res.findings)} finding(s) "
              f"[{counts or 'clean'}] across {res.files} file(s), "
              f"{res.suppressed} suppressed", file=sys.stderr)
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(main())
