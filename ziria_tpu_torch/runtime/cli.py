"""CLI driver (counterpart of ziria_tpu/runtime/cli.py).

The reference's compiled executables all share one CLI
(`csrc/params.c`, SURVEY.md §2.2): ``--input=file --input-file-name=X
--input-file-mode=dbg|bin --output=...``. This driver keeps that flag
surface and the compiler flags of the reference's driver: backend
selection (``--backend=interp|jit|hybrid``), the vectorization width,
``--fold``, ``--autolut``, the fixed-point policy ``--fxp-complex16``,
stream-state checkpoints (``--state-in``/``--state-out``, jit backend),
the pass dumps, the Viterbi knobs and the library knobs
(``--fused-demap``, ``--batched-acquire``, ``--batched-tx``,
``--streaming-rx``, ``--multi-stream``, ``--fused-link``,
``--rx-sco-track``, ``--chaos``, ``--max-retries``,
``--channel-profile``), each written to its ``ZIRIA_*`` variable for
this invocation only. The program is a ``.zir`` source file (``--src``)
or a registered pipeline (``--prog``, ``--list-progs``).

    python -m ziria_tpu_torch --src=examples/wifi_rx.zir \
        --input=file --input-file-name=capture.bin --input-file-mode=bin \
        --output=file --output-file-name=out.bin --output-file-mode=bin \
        --backend=hybrid

Telemetry: ``--trace=PATH`` (or ``ZIRIA_TRACE``) writes a Chrome trace
of the run's spans, counter tracks and nvcc compiles
(``tools/trace_report.py`` summarizes it); ``--metrics-dump`` prints the
run's metrics exposition to stderr; ``--profile`` runs each top-level
stage apart and times it (host clock, and CUDA events on the card);
``--profile-trace=DIR`` writes a ``torch.profiler`` Chrome trace of the
run into DIR. Subcommands, dispatched before the flags are parsed:
``serve`` (runtime/serve.main), ``programs`` (utils/programs.main) and
``autotune`` (utils/autotune.main).

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
from typing import Callable, Dict, Optional

import numpy as np

from ziria_tpu_torch.runtime.buffers import ITEM_TYPES, StreamSpec, \
    read_stream, write_stream

#: subcommands of the reference's driver that this one refuses, and
#: the ROADMAP Queue 1 item that ports what each runs
REFUSED_SUBCOMMANDS = {"lint": "4d"}

#: flags of the reference's driver that this one refuses: flag -> (dest
#: in the reference's parser, how it takes a value, ROADMAP item)
REFUSED_FLAGS = {
    "--pp": ("pp", "value", "5"),
    "--pp-costs": ("pp_costs", "value", "5"),
    "--sp": ("sp", "value", "5"),
    "--ddump-vect": ("ddump_vect", "store_true", "6b"),
    "--scan": ("scan", "store_true", "6b"),
    "--batch-input-files": ("batch_input_files", "value", "6b"),
    "--batch-output-files": ("batch_output_files", "value", "6b"),
}


# --------------------------------------------------------------------------
# Program registry (reference :49-120)
# --------------------------------------------------------------------------


def _prog_fir():
    """BASELINE config #1: a 5-tap FIR low-pass over a float stream."""
    import torch

    from ziria_tpu_torch.core import ir

    taps = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32)

    def fir_step(state, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        state = torch.cat([x.reshape(1).to(state.device), state[:-1]])
        return state, (state * torch.from_numpy(taps).to(state.device)
                       ).sum()

    return ir.map_accum(fir_step, np.zeros(5, np.float32), name="fir5")


def _prog_fft(inverse: bool):
    """BASELINE config #2 (and its inverse): 64-point FFT blocks over
    complex pairs (numpy's convention; ``torch.fft``, which the jit
    backend's vmap of the firings can batch)."""
    import torch

    from ziria_tpu_torch.core import ir

    fn = torch.fft.ifft if inverse else torch.fft.fft

    def fft_block(v):
        v = torch.as_tensor(v).to(torch.float32)
        y = fn(torch.complex(v[..., 0], v[..., 1]))
        return torch.stack([y.real, y.imag], dim=-1)

    return ir.zmap(fft_block, in_arity=64, out_arity=64,
                   name="ifft64" if inverse else "fft64")


def _prog_scramble():
    """The 802.11 LFSR scrambler over a bit stream (the default seed)."""
    import torch

    from ziria_tpu_torch.core import ir
    from ziria_tpu_torch.ops import scramble
    from ziria_tpu_torch.phy.wifi.tx import DEFAULT_SCRAMBLER_SEED, \
        _seed_bits_np

    seq_np = scramble.np_lfsr_sequence_127(
        _seed_bits_np(DEFAULT_SCRAMBLER_SEED))

    def step(phase, b):
        b = torch.as_tensor(b)
        seq = torch.from_numpy(seq_np).to(b.device)
        out = b.to(torch.uint8) ^ seq[torch.as_tensor(phase) % 127]
        return phase + 1, out

    return ir.map_accum(step, 0, name="scramble")


def _wifi_tx_sym(rate_mbps: int):
    def build():
        from ziria_tpu_torch.phy.wifi.tx import tx_symbol_pipeline
        return tx_symbol_pipeline(rate_mbps)
    return build


PROGS: Dict[str, Callable] = {
    "fir": _prog_fir,
    "fft64": lambda: _prog_fft(False),
    "ifft64": lambda: _prog_fft(True),
    "scramble": _prog_scramble,
}
for _r in (6, 9, 12, 18, 24, 36, 48, 54):
    PROGS[f"wifi_tx_sym_{_r}"] = _wifi_tx_sym(_r)

#: the on/off library knobs: flag stem -> (argparse dest, variable)
KNOB_FLAGS = {
    "fused-demap": ("fused_demap", "ZIRIA_FUSED_DEMAP"),
    "batched-acquire": ("batched_acquire", "ZIRIA_BATCHED_ACQUIRE"),
    "batched-tx": ("batched_tx", "ZIRIA_BATCHED_TX"),
    "streaming-rx": ("streaming_rx", "ZIRIA_STREAMING_RX"),
    "fused-link": ("fused_link", "ZIRIA_FUSED_LINK"),
    "rx-sco-track": ("rx_sco_track", "ZIRIA_RX_SCO_TRACK"),
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
                    "(reference-style params)",
        epilog="subcommands: `python -m ziria_tpu_torch serve [--lanes N] "
               "[--sessions N] [--chaos SPEC]` runs the serving demo on "
               "the fleet; `python -m ziria_tpu_torch programs [--json] "
               "[--batch]` profiles every dispatch site under "
               "torch.profiler; `python -m ziria_tpu_torch autotune "
               "[--frames N] [--reps N]` runs the measured geometry "
               "search and records the winner for Geometry.tuned()")
    p.add_argument("--prog", help="registered pipeline name")
    p.add_argument("--src", help="Ziria-like source file (.zir) to compile")
    p.add_argument("--list-progs", action="store_true")

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
    p.add_argument("--profile", action="store_true",
                   help="per-stage time and item counts: each top-level "
                        "stage runs apart (a warm-up and a timed pass; "
                        "host clock, and CUDA events on the card); "
                        "totals differ from the fused run")
    p.add_argument("--profile-trace", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "(CPU activity, and CUDA on the card) into DIR")
    p.add_argument("--trace", metavar="PATH",
                   help="write a Chrome trace-event JSON of the run's "
                        "dispatch spans, counter tracks and nvcc compile "
                        "events to PATH (summarize with "
                        "tools/trace_report.py); also via ZIRIA_TRACE")
    p.add_argument("--metrics-dump", action="store_true",
                   help="print the run's metrics registry as Prometheus "
                        "text to stderr at exit")
    p.add_argument("--chaos", metavar="SPEC",
                   help="run under a seeded fault-injection plan "
                        "(utils/faults): '[seed=N;]site:kind[:key=val,"
                        "...]' items separated by ';'; also via "
                        "ZIRIA_CHAOS")
    p.add_argument("--max-retries", type=int, default=None, metavar="N",
                   help="transient-failure retry budget of every guarded "
                        "dispatch site (default 2); also via "
                        "ZIRIA_MAX_RETRIES")
    p.add_argument("--channel-profile", metavar="NAME[,NAME...]",
                   help="default channel profile of the stimulus "
                        "surfaces (phy/profiles; a comma list cycles per "
                        "lane); also via ZIRIA_CHANNEL_PROFILE")
    for stem, (dest, var) in KNOB_FLAGS.items():
        p.add_argument(f"--{stem}", dest=dest, action="store_true",
                       default=None, help=f"sets {var}=1 for this run")
        p.add_argument(f"--no-{stem}", dest=dest, action="store_false",
                       help=f"sets {var}=0 for this run")
    p.add_argument("--multi-stream", dest="multi_stream", type=int,
                   default=None, metavar="S",
                   help="S-stream fleet mode of the stream surface "
                        "(0 disables); also via ZIRIA_MULTI_STREAM")
    p.add_argument("--no-multi-stream", dest="multi_stream",
                   action="store_const", const=0,
                   help="S lone receivers in place of the fleet")
    for flag, (dest, kind, _item) in REFUSED_FLAGS.items():
        p.add_argument(flag, dest=dest, action=_Refused,
                       nargs=0 if kind == "store_true" else None,
                       help=argparse.SUPPRESS)
    return p


def _resolve_prog(args):
    """Returns (comp, default_in_ty, default_out_ty)."""
    if args.src:
        from ziria_tpu_torch.frontend import compile_file
        prog = compile_file(args.src, fxp_complex16=args.fxp_complex16,
                            autolut=args.autolut)
        return prog.comp, prog.in_ty, prog.out_ty
    if not args.prog:
        raise SystemExit("need --prog=NAME or --src=FILE "
                         "(--list-progs to enumerate)")
    if args.prog not in PROGS:
        raise SystemExit(
            f"unknown prog {args.prog!r}; known: {', '.join(sorted(PROGS))}")
    return PROGS[args.prog](), None, None


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


def _overrides(args) -> Dict[str, str]:
    """The ZIRIA_* variables this invocation sets, each flag checked
    first so a bad value is a flag error, not a failure deep in the
    run."""
    out = {}
    if args.viterbi_window is not None:
        out["ZIRIA_VITERBI_WINDOW"] = str(args.viterbi_window)
    if args.viterbi_metric is not None:
        out["ZIRIA_VITERBI_METRIC"] = args.viterbi_metric
    if args.viterbi_radix is not None:
        out["ZIRIA_VITERBI_RADIX"] = str(args.viterbi_radix)
    for dest, var in KNOB_FLAGS.values():
        v = getattr(args, dest)
        if v is not None:
            out[var] = "1" if v else "0"
    if args.multi_stream is not None:
        out["ZIRIA_MULTI_STREAM"] = str(args.multi_stream)
    if args.chaos is not None:
        from ziria_tpu_torch.utils import faults
        try:
            faults.parse_chaos_spec(args.chaos)
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")
        out["ZIRIA_CHAOS"] = args.chaos
    if args.max_retries is not None:
        if args.max_retries < 0:
            raise SystemExit(
                f"--max-retries: {args.max_retries} must be >= 0")
        out["ZIRIA_MAX_RETRIES"] = str(args.max_retries)
    if args.channel_profile is not None:
        from ziria_tpu_torch.phy import profiles
        try:
            profiles.parse_profile_spec(args.channel_profile)
        except ValueError as e:
            raise SystemExit(f"--channel-profile: {e}")
        out["ZIRIA_CHANNEL_PROFILE"] = args.channel_profile
    if args.trace:
        out["ZIRIA_TRACE"] = args.trace
    return out


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in REFUSED_SUBCOMMANDS:
        print(f"ziria_tpu_torch: the `{argv[0]}` subcommand is not ported "
              f"yet (ROADMAP Queue 1 item "
              f"{REFUSED_SUBCOMMANDS[argv[0]]})", file=sys.stderr)
        return 2
    if argv and argv[0] == "serve":
        from ziria_tpu_torch.runtime.serve import main as serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "programs":
        from ziria_tpu_torch.utils.programs import main as programs_main
        return programs_main(argv[1:])
    if argv and argv[0] == "autotune":
        from ziria_tpu_torch.utils.autotune import main as autotune_main
        return autotune_main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.list_progs:
        for name in sorted(PROGS):
            print(name)
        return 0
    # every knob is read per call (utils/geometry and the modules' own
    # readers); scope the writes to this invocation so in-process
    # callers never inherit them, and let --no-* / --viterbi-window=0 /
    # --viterbi-metric=float32 / --viterbi-radix=2 force-disable an
    # exported value
    overrides = _overrides(args)
    prev = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        return _main_run(args)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _main_run(args) -> int:
    """The telemetry shell around the run: with --trace / ZIRIA_TRACE
    the whole run is traced and exported, also when it fails; with
    --metrics-dump its registry's exposition goes to stderr at exit;
    with --chaos / ZIRIA_CHAOS it runs under that fault plan."""
    import contextlib

    from ziria_tpu_torch.utils import faults, telemetry

    tpath = telemetry.env_trace_path()
    try:
        chaos = faults.env_chaos()
    except ValueError as e:
        raise SystemExit(f"ZIRIA_CHAOS: {e}")
    if not tpath and not args.metrics_dump and chaos is None:
        return _run_cmd(args)
    reg = None
    try:
        with contextlib.ExitStack() as stack:
            if tpath:
                stack.enter_context(telemetry.tracing(tpath))
            if args.metrics_dump:
                reg = stack.enter_context(telemetry.collect())
            if chaos is not None:
                specs, seed = chaos
                stack.enter_context(faults.inject(*specs, seed=seed))
            return _run_cmd(args)
    finally:
        if tpath:
            print(f"telemetry trace written to {tpath} "
                  f"(summarize: python tools/trace_report.py {tpath})",
                  file=sys.stderr)
        if reg is not None:
            print("metrics exposition (utils/telemetry):",
                  file=sys.stderr)
            print(reg.exposition(), file=sys.stderr, end="")


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

    if args.profile and (args.state_in or args.state_out):
        raise SystemExit("--profile runs stages separately and cannot "
                         "combine with --state-in/--state-out")
    xs = read_stream(in_spec)
    reset_counters()
    LAST_RUN.clear()
    t0 = time.perf_counter()

    def run():
        if args.profile:
            ys = _run_profiled(comp, xs, args, dev)
            return ys, time.perf_counter() - t0, "profile"
        return _run_backend(comp, xs, args, t0, dev)

    if args.profile_trace:
        # --profile-trace=DIR: the run under the observatory's
        # torch.profiler, its Chrome trace kept as DIR/profile.pt.trace.json
        from ziria_tpu_torch.utils import programs
        with programs.Observatory().profile(
                "profile", dev, args.profile_trace) as obs:
            ys, dt, backend = run()
        path = obs.profiles["profile"]["trace_path"]
        LAST_RUN["profile_trace"] = path
        print(f"profiler trace written to {path}", file=sys.stderr)
    else:
        ys, dt, backend = run()
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


def _stage_runner(st, cur, width, dev):
    """A zero-argument call running one stage over `cur` (the
    reference's ``autosplit.stage_runner``), already run once as its
    warm-up: the jit backend when the stage lowers, else the hybrid
    executor, hybridized once so the warm-up warms what the timed call
    reuses. Returns (call, backend)."""
    from ziria_tpu_torch.backend.execute import run_jit_carry
    from ziria_tpu_torch.backend.lower import LowerError, lower

    def jit():
        return np.asarray(run_jit_carry(st, cur, width=width,
                                        device=dev)[0])
    try:
        lower(st, width=width, device=dev)
        jit()
        return jit, "jit"
    except LowerError:
        from ziria_tpu_torch.backend.hybrid import hybridize
        from ziria_tpu_torch.interp.interp import run
        hyb = hybridize(st, device=dev)

        def hybrid():
            return _host(run(hyb, list(cur)).out_array())
        hybrid()
        return hybrid, "hybrid"


def _run_profiled(comp, xs, args, dev):
    """--profile: each top-level stage runs apart over the previous
    stage's output, a warm-up pass then a timed one, on the host clock
    and (on the card) CUDA events around the timed pass. The output is
    the fused run's; only the times lose cross-stage fusion. The rows
    land in ``LAST_RUN["profile"]``."""
    import torch

    from ziria_tpu_torch.core.ir import pipeline_stages

    on_card = dev.type == "cuda"
    rows = []
    cur = np.asarray(xs)
    for st in pipeline_stages(comp):
        if args.backend == "interp":
            from ziria_tpu_torch.interp.interp import run

            def go(_st=st, _cur=cur):
                return _host(run(_st, list(_cur)).out_array())
            go()
            how = "interp"
        else:
            go, how = _stage_runner(st, cur, args.width, dev)
        if on_card:
            torch.cuda.synchronize(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        out = go()
        dt = time.perf_counter() - t0
        dev_ms = None
        if on_card:
            ev[1].record()
            torch.cuda.synchronize(dev)
            dev_ms = ev[0].elapsed_time(ev[1])
        rows.append({"stage": st.label(), "backend": how,
                     "items_in": int(cur.shape[0]),
                     "items_out": int(out.shape[0]), "host_ms": dt * 1e3,
                     "cuda_ms": dev_ms})
        cur = out
    total = sum(r["host_ms"] for r in rows) or 1e-9
    print(f"profile: {len(rows)} stage(s), backend={args.backend} "
          f"(stages timed unfused)", file=sys.stderr)
    for r in rows:
        card = "" if r["cuda_ms"] is None else \
            f"  {r['cuda_ms']:>9.3f} ms (CUDA events)"
        print(f"  stage {r['stage']:<28s} {r['items_in']:>8d} -> "
              f"{r['items_out']:>8d} items  {r['host_ms']:>9.3f} ms  "
              f"{100 * r['host_ms'] / total:>5.1f}%  ({r['backend']})"
              f"{card}", file=sys.stderr)
    LAST_RUN["profile"] = rows
    return cur


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
