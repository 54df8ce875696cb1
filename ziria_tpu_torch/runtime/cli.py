"""CLI driver, the ``run`` path (counterpart of ziria_tpu/runtime/cli.py).

The reference's compiled executables all share one CLI
(`csrc/params.c`, SURVEY.md §2.2): ``--input=file --input-file-name=X
--input-file-mode=dbg|bin --output=...``. This driver keeps that flag
surface and the compiler flags of the reference's driver: backend
selection (``--backend=interp|jit|hybrid``), the vectorization width,
``--fold``, ``--autolut``, the fixed-point policy ``--fxp-complex16``,
stream-state checkpoints (``--state-in``/``--state-out``, jit backend),
the pass dumps and the Viterbi knobs. The program is a
``.zir`` source file (``--src``).

    python -m ziria_tpu_torch --src=examples/wifi_rx.zir \
        --input=file --input-file-name=capture.bin --input-file-mode=bin \
        --output=file --output-file-name=out.bin --output-file-mode=bin \
        --backend=hybrid

Device work runs on the card (``--platform=cuda``, the default) unless
``--platform=cpu`` is given; with no card and no ``--platform=cpu``
the driver raises rather than run elsewhere. Flags and subcommands of
the reference whose modules are not ported exit non-zero naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

from ziria_tpu_torch.runtime.buffers import ITEM_TYPES, StreamSpec, \
    read_stream, write_stream

#: subcommands of the reference's driver, and the ROADMAP Queue 1 item
#: that ports what each runs
REFUSED_SUBCOMMANDS = {"lint": 4, "programs": 4, "autotune": 4,
                       "serve": 4}

#: flags of the reference's driver that this one refuses: flag -> (dest
#: in the reference's parser, how it takes a value, ROADMAP item)
REFUSED_FLAGS = {
    "--pp": ("pp", "value", "5"),
    "--pp-costs": ("pp_costs", "value", "5"),
    "--sp": ("sp", "value", "5"),
    "--profile": ("profile", "store_true", "4"),
    "--profile-trace": ("profile_trace", "value", "4"),
    "--scan": ("scan", "store_true", "6b"),
    "--batch-input-files": ("batch_input_files", "value", "6b"),
    "--batch-output-files": ("batch_output_files", "value", "6b"),
}


class _Refused(argparse.Action):
    """Exit non-zero naming the ROADMAP item that ports the flag."""

    def __call__(self, parser, namespace, values, option_string=None):
        item = REFUSED_FLAGS[option_string][2]
        parser.exit(2, f"{parser.prog}: {option_string} is not ported "
                       f"yet (ROADMAP Queue 1 item {item})\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ziria_tpu_torch",
        description="stream pipeline driver on PyTorch/CUDA "
                    "(reference-style params)")
    p.add_argument("--src", help="Ziria-like source file (.zir) to compile")

    # `memory` streams are the programmatic API (StreamSpec(data=...));
    # argv has no way to carry an array, so the CLI offers file|dummy only
    p.add_argument("--input", default="file", choices=["file", "dummy"])
    p.add_argument("--input-file-name")
    p.add_argument("--input-file-mode", default="dbg",
                   choices=["dbg", "bin"])
    p.add_argument("--input-type", default=None, choices=ITEM_TYPES,
                   help="item type (default: from the program's read[t], "
                        "else int32)")
    p.add_argument("--dummy-samples", type=int, default=0)

    p.add_argument("--output", default="file", choices=["file", "dummy"])
    p.add_argument("--output-file-name")
    p.add_argument("--output-file-mode", default="dbg",
                   choices=["dbg", "bin"])
    p.add_argument("--output-type", default=None, choices=ITEM_TYPES,
                   help="item type (default: from the program's write[t], "
                        "else int32)")

    p.add_argument("--backend", default="jit",
                   choices=["interp", "jit", "hybrid"])
    p.add_argument("--width", type=int, default=None,
                   help="vectorization width (default: planner)")
    p.add_argument("--fold", action="store_true", default=True)
    p.add_argument("--no-fold", dest="fold", action="store_false")
    p.add_argument("--autolut", action="store_true",
                   help="rewrite small-domain pure maps and calls into "
                        "table gathers (core/autolut.py, "
                        "frontend/lutinfer.py)")
    p.add_argument("--fxp-complex16", action="store_true",
                   help="int16 fixed-point complex16 policy: stream "
                        "items and arithmetic are integer IQ pairs "
                        "with C shorts semantics (wrap at store); "
                        "f32 is retained only inside explicitly "
                        "complex-typed ext calls such as v_fft")
    p.add_argument("--state-in", metavar="FILE",
                   help="resume the stream state from a checkpoint "
                        "written by --state-out (jit backend; the "
                        "program's fingerprint must match)")
    p.add_argument("--state-out", metavar="FILE",
                   help="write the stream state after the run to FILE "
                        "(.npz; jit backend)")
    p.add_argument("--ddump-fold", action="store_true",
                   help="dump the IR after folding")
    p.add_argument("--ddump-hybrid", action="store_true",
                   help="dump the hybrid executor's per-do-block "
                        "decisions (weight, device/effects/below-"
                        "threshold) and each stream loop's placement")
    p.add_argument("--stats", action="store_true",
                   help="print the fused plan (jit backend) and the "
                        "run's counters: do-blocks on the device and on "
                        "the host, device-loop iterations, host syncs, "
                        "viterbi_soft decodes and kernel launches")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where device work runs: the card (default) or "
                        "the CPU; with no card the driver raises unless "
                        "--platform=cpu is given")
    p.add_argument("--viterbi-window", type=int, default=None,
                   metavar="N",
                   help="decode every viterbi_soft ext on a device frame "
                        "with the sliding-window decode (window N, e.g. "
                        "1024) on the ACS and traceback kernels; also "
                        "via ZIRIA_VITERBI_WINDOW")
    p.add_argument("--viterbi-metric", default=None,
                   choices=["float32", "int16", "int8"],
                   help="path-metric dtype of every device viterbi_soft "
                        "ext (float32 the exact oracle, the default); "
                        "also via ZIRIA_VITERBI_METRIC")
    p.add_argument("--viterbi-radix", type=int, default=None,
                   choices=[2, 4],
                   help="trellis steps per ACS iteration of the windowed "
                        "decode's kernel (2 the default; 4 is bit-"
                        "identical at float32 and int16); also via "
                        "ZIRIA_VITERBI_RADIX")
    for flag, (dest, kind, _item) in REFUSED_FLAGS.items():
        p.add_argument(flag, dest=dest, action=_Refused,
                       nargs=0 if kind == "store_true" else None,
                       help=argparse.SUPPRESS)
    return p


def _resolve_prog(args):
    """Returns (comp, default_in_ty, default_out_ty)."""
    if not args.src:
        raise SystemExit("need --src=FILE (a .zir program)")
    from ziria_tpu_torch.frontend import compile_file
    prog = compile_file(args.src, fxp_complex16=args.fxp_complex16,
                        autolut=args.autolut)
    return prog.comp, prog.in_ty, prog.out_ty


def _device(platform: str):
    """The torch device of --platform: the card, which must be there,
    or the CPU when asked for."""
    import torch
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--platform=cuda: no CUDA device is available; pass "
            "--platform=cpu to run on the CPU")
    return torch.device("cuda")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in REFUSED_SUBCOMMANDS:
        print(f"ziria_tpu_torch: the `{argv[0]}` subcommand is not ported "
              f"yet (ROADMAP Queue 1 item "
              f"{REFUSED_SUBCOMMANDS[argv[0]]})", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    # viterbi_soft reads the env triple per call (frontend/externals.
    # viterbi_mode); scope the writes to this invocation so in-process
    # callers never inherit them, and let --viterbi-window=0 /
    # --viterbi-metric=float32 / --viterbi-radix=2 force-disable an
    # exported env value
    overrides = {}
    if args.viterbi_window is not None:
        overrides["ZIRIA_VITERBI_WINDOW"] = str(args.viterbi_window)
    if args.viterbi_metric is not None:
        overrides["ZIRIA_VITERBI_METRIC"] = args.viterbi_metric
    if args.viterbi_radix is not None:
        overrides["ZIRIA_VITERBI_RADIX"] = str(args.viterbi_radix)
    prev = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        return _run_cmd(args)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_cmd(args) -> int:
    dev = _device(args.platform)
    comp, src_in_ty, src_out_ty = _resolve_prog(args)
    in_ty = args.input_type or src_in_ty or "int32"
    out_ty = args.output_type or src_out_ty or "int32"

    # autolut first: fold's map-map fusion erases in_domain declarations,
    # so the LUT rewrite must see the maps before they fuse
    if args.autolut:
        from ziria_tpu_torch.core.autolut import autolut
        comp = autolut(comp)
    if args.fold:
        from ziria_tpu_torch.core.opt import fold
        comp = fold(comp)
    if args.ddump_fold:
        print(comp, file=sys.stderr)
    if args.ddump_hybrid:
        from ziria_tpu_torch.backend.hybrid import hybridize
        print("hybrid plan:", file=sys.stderr)
        hybridize(comp, dump=lambda s: print(s, file=sys.stderr),
                  device=dev)

    in_spec = StreamSpec(kind=args.input, ty=in_ty,
                         path=args.input_file_name,
                         mode=args.input_file_mode,
                         dummy_items=args.dummy_samples)
    out_spec = StreamSpec(kind=args.output, ty=out_ty,
                          path=args.output_file_name,
                          mode=args.output_file_mode)

    xs = read_stream(in_spec)
    reset_counters()
    t0 = time.perf_counter()
    ys, dt, backend = _run_backend(comp, xs, args, t0, dev)
    write_stream(out_spec, ys)
    LAST_RUN.update(backend=backend, seconds=dt, items_in=int(xs.shape[0]),
                    items_out=int(ys.shape[0]), **counters())
    if args.stats:
        c = counters()
        print(f"run: backend={backend} do-blocks device={c['blocks_device']}"
              f" host={c['blocks_host']} device_loop_iters="
              f"{c['device_loop_iters']} syncs={c['syncs']} viterbi_soft="
              f"{c['viterbi']} launches={c['launches']}", file=sys.stderr)
    if args.verbose:
        print(f"items in: {xs.shape[0]}, items out: {ys.shape[0]}, "
              f"time: {dt:.4f}s "
              f"({xs.shape[0] / max(dt, 1e-12):,.0f} items/s)",
              file=sys.stderr)
    return 0


#: the last run's backend, seconds, item counts and counters (for
#: in-process callers such as chip_smoke.py)
LAST_RUN: dict = {}


def reset_counters() -> None:
    from ziria_tpu_torch.backend import hybrid
    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.frontend import externals
    from ziria_tpu_torch.ops import viterbi_cuda
    E.reset_counts()
    hybrid.reset_counts()
    for k in externals.VITERBI_CALLS:
        externals.VITERBI_CALLS[k] = 0
    viterbi_cuda.reset_launches()


def counters() -> dict:
    from ziria_tpu_torch.backend import hybrid
    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.frontend import externals
    from ziria_tpu_torch.ops import viterbi_cuda
    return {"blocks_device": hybrid.BLOCKS["device"],
            "blocks_host": hybrid.BLOCKS["host"],
            "device_loop_iters": E.COUNTS["device_loop_iters"],
            "syncs": E.COUNTS["syncs"],
            "viterbi": dict(externals.VITERBI_CALLS),
            "launches": {k: v for k, v in viterbi_cuda.LAUNCHES.items()
                         if v}}


def _run_backend(comp, xs, args, t0, dev):
    """Run on interp / hybrid / jit; returns (ys, seconds, backend that
    ran)."""
    if args.backend in ("interp", "hybrid"):
        if args.state_in or args.state_out:
            raise SystemExit("--state-in/--state-out need --backend=jit "
                             "(stream state is the jit carry)")
        backend = args.backend
        if backend == "hybrid":
            # interpreter-driven control, heavy do-blocks on the device
            # (backend/hybrid.py) — for dynamic-control programs like
            # the flagship receiver that the fused jit path refuses
            from ziria_tpu_torch.backend.hybrid import hybridize
            comp = hybridize(comp, device=dev)
        from ziria_tpu_torch.interp.interp import run
        res = run(comp, list(xs))
        return (_host(res.out_array()), time.perf_counter() - t0,
                backend)
    from ziria_tpu_torch.backend.execute import run_jit_carry
    from ziria_tpu_torch.backend.lower import LowerError, lower
    stats: Optional[dict] = {} if args.stats else None
    try:
        carry = None
        if args.state_in:
            from ziria_tpu_torch.runtime.state import (load_state,
                                                       program_fingerprint)
            carry = load_state(args.state_in,
                               like=lower(comp, width=args.width,
                                          device=dev).init_carry,
                               fingerprint=program_fingerprint(comp))
        ys, carry = run_jit_carry(comp, xs, carry=carry, width=args.width,
                                  stats_out=stats, device=dev)
    except LowerError as e:
        if args.state_in or args.state_out:
            raise SystemExit(
                f"--state-in/--state-out need a fusable pipeline ({e})")
        # dynamic-control programs can't fuse; instead of refusing
        # (the reference's compiler compiles everything), run the
        # hybrid executor — same results, control on the host, heavy
        # blocks on the device. run_jit_carry writes nothing before it
        # returns, so the hybrid run starts from the same state.
        print(f"note: program has dynamic control "
              f"({e}); falling back to --backend=hybrid",
              file=sys.stderr)
        if args.stats:
            print("note: --stats reports the fused plan and is "
                  "unavailable under the hybrid fallback "
                  "(try --ddump-hybrid)", file=sys.stderr)
        from ziria_tpu_torch.backend.hybrid import hybridize
        from ziria_tpu_torch.interp.interp import run
        reset_counters()
        res = run(hybridize(comp, device=dev), list(xs))
        return (_host(res.out_array()), time.perf_counter() - t0,
                "hybrid")
    if args.state_out:
        from ziria_tpu_torch.runtime.state import (program_fingerprint,
                                                   save_state)
        save_state(args.state_out, carry,
                   fingerprint=program_fingerprint(comp))
    if args.stats:
        # printed straight from the executor's own split arithmetic
        print(f"plan: width={stats['width']} take={stats['take']} "
              f"emit={stats['emit']} "
              f"bulk_steps={stats['bulk_steps']} "
              f"remainder_iters={stats['remainder_iters']}",
              file=sys.stderr)
        for lbl, reps in zip(stats["labels"], stats["reps"]):
            print(f"  stage {lbl:<28s} {reps:>6d} firings/iter "
                  f"({reps * stats['width']} per bulk step)",
                  file=sys.stderr)
    return np.asarray(ys), time.perf_counter() - t0, "jit"


def _host(ys) -> np.ndarray:
    """The interpreter's output stack as numpy (items a device block
    left on the device come back here)."""
    import torch
    if isinstance(ys, torch.Tensor):
        return ys.detach().cpu().numpy()
    return np.asarray(ys)


if __name__ == "__main__":
    sys.exit(main())
