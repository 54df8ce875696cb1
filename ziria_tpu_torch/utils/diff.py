"""Tolerance comparator — the BlinkDiff equivalent (port copy of
ziria_tpu/utils/diff.py, which imports no JAX).

The reference's golden-file tests compare program output against ground
truth with `tools/BlinkDiff`, which tolerates bounded numeric deviation
(SURVEY.md §4) because vectorization/LUT rewrites may legally perturb low
bits. Same policy here: exact equality for integer/bit streams, bounded
absolute+relative error for floats/complex, with a precise first-mismatch
report for debugging.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DiffReport:
    ok: bool
    message: str
    n_mismatch: int = 0
    first_index: Optional[int] = None
    max_abs_err: float = 0.0

    def __bool__(self) -> bool:
        return self.ok


def stream_diff(got, want, atol: float = 0.0, rtol: float = 0.0,
                name: str = "stream") -> DiffReport:
    """Compare two streams (arrays). Integer dtypes require exactness
    regardless of atol/rtol; floats/complex use atol + rtol*|want|."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return DiffReport(False,
                          f"{name}: shape mismatch got {got.shape} "
                          f"want {want.shape}")
    if got.size == 0:
        return DiffReport(True, f"{name}: empty, equal")

    def _exact_dtype(dt):
        return np.issubdtype(dt, np.integer) or dt == np.bool_

    exact = _exact_dtype(got.dtype) and _exact_dtype(want.dtype)
    if exact:
        neq = got != want
        if neq.any():
            flat = np.flatnonzero(neq.reshape(-1))
            i = int(flat[0])
            return DiffReport(
                False,
                f"{name}: {flat.size}/{got.size} integer mismatches; first "
                f"at flat index {i}: got {got.reshape(-1)[i]} want "
                f"{want.reshape(-1)[i]}",
                n_mismatch=int(flat.size), first_index=i)
        return DiffReport(True, f"{name}: {got.size} items exactly equal")

    err = np.abs(got.astype(np.complex128) - want.astype(np.complex128))
    tol = atol + rtol * np.abs(want.astype(np.complex128))
    bad = err > tol
    if bad.any():
        flat = np.flatnonzero(bad.reshape(-1))
        i = int(flat[0])
        return DiffReport(
            False,
            f"{name}: {flat.size}/{got.size} items exceed tol "
            f"(atol={atol}, rtol={rtol}); first at flat index {i}: got "
            f"{got.reshape(-1)[i]} want {want.reshape(-1)[i]} "
            f"(err {err.reshape(-1)[i]:.3g}); max err {err.max():.3g}",
            n_mismatch=int(flat.size), first_index=i,
            max_abs_err=float(err.max()))
    return DiffReport(True,
                      f"{name}: {got.size} items within tol "
                      f"(max err {float(err.max()):.3g})",
                      max_abs_err=float(err.max()))


def assert_stream_eq(got, want, atol: float = 0.0, rtol: float = 0.0,
                     name: str = "stream") -> None:
    rep = stream_diff(got, want, atol=atol, rtol=rtol, name=name)
    if not rep:
        raise AssertionError(rep.message)


# --------------------------------------------------------------------------
# CLI — the reference tools/BlinkDiff executable's role:
#   python -m ziria_tpu_torch.utils.diff got.dbg want.ground \
#       --type=complex16 --mode=dbg --atol=1 [--prefix]
# exit 0 on match, 1 on mismatch (message on stderr).
# --------------------------------------------------------------------------


def _diff_main(argv=None) -> int:
    import argparse
    import sys

    from ziria_tpu_torch.runtime.buffers import ITEM_TYPES, StreamSpec, \
        read_stream

    p = argparse.ArgumentParser(
        prog="python -m ziria_tpu_torch.utils.diff",
        description="Golden-file comparator (BlinkDiff role): exact for "
                    "integer/bit streams, tolerance for floats/complex")
    p.add_argument("got")
    p.add_argument("want")
    p.add_argument("--type", default="int32", choices=ITEM_TYPES)
    p.add_argument("--mode", default="dbg", choices=["dbg", "bin"])
    p.add_argument("--atol", type=float, default=0.0)
    p.add_argument("--rtol", type=float, default=0.0)
    p.add_argument("--prefix", action="store_true",
                   help="compare only the common prefix (bin-mode bit "
                        "streams pad to byte boundaries)")
    args = p.parse_args(argv)

    got = read_stream(StreamSpec(ty=args.type, path=args.got,
                                 mode=args.mode))
    want = read_stream(StreamSpec(ty=args.type, path=args.want,
                                  mode=args.mode))
    if args.prefix:
        n = min(got.shape[0], want.shape[0])
        got, want = got[:n], want[:n]
    if args.atol or args.rtol:
        got = got.astype(np.float64)
        want = want.astype(np.float64)
    rep = stream_diff(got, want, atol=args.atol, rtol=args.rtol,
                      name=args.got)
    print(rep.message, file=sys.stderr if not rep.ok else sys.stdout)
    return 0 if rep.ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(_diff_main())
