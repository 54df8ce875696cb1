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
the driver raises rather than run elsewhere. ``--sp=N`` splits the
stream over N devices and ``--pp=N`` pipelines the stages across N
(``parallel/``), each mesh built on ``--platform``'s devices: the
cards, or 8 virtual entries on the CPU.
"""

from __future__ import annotations

# ziria: lint-ignore-file[R4] this module owns the scoped-env pattern:
# main() writes each flag's ZIRIA_* variable for one invocation and
# restores it after

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from ziria_tpu_torch.runtime.buffers import ITEM_TYPES, StreamSpec, \
    read_stream, write_stream

#: subcommands and flags of the reference's driver that this one refuses:
#: none (every ROADMAP Queue 1 item is ported)
REFUSED_SUBCOMMANDS: Dict[str, str] = {}
REFUSED_FLAGS: Dict[str, tuple] = {}


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
    p.add_argument("--sp", type=int, default=None, metavar="N",
                   help="split the stream over N devices of --platform "
                        "(sequence parallelism; jit backend, stateless "
                        "or fast-forwardable pipelines)")
    p.add_argument("--pp", type=int, default=None, metavar="N",
                   help="auto-pipeline the stages across N devices of "
                        "--platform (balanced |>>>| placement decided by "
                        "the compiler; jit backend)")
    p.add_argument("--pp-costs", choices=("proxy", "measured"),
                   default="proxy",
                   help="stage-cost model for --pp placement: 'proxy' "
                        "(items moved per steady-state iteration) or "
                        "'measured' (time each stage on a sample of "
                        "the real input before deciding)")
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
    p.add_argument("--ddump-vect", action="store_true",
                   help="dump the vectorization plan (core/vectorize.py)")
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
    p.add_argument("--scan", action="store_true",
                   help="long-capture mode: find every packet in the "
                        "--input-file-name complex16 capture and decode "
                        "them all with the in-language receiver, frame-"
                        "batched (phy/search.scan_and_decode); writes "
                        "the concatenated validated payload bits")
    p.add_argument("--batch-input-files", metavar="F1,F2,...",
                   help="run the program over N input files, chunk-"
                        "machine steps batched across them "
                        "(backend/framebatch.run_many); needs "
                        "--batch-output-files")
    p.add_argument("--batch-output-files", metavar="O1,O2,...",
                   help="one output file per --batch-input-files entry")
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
    if argv and argv[0] == "lint":
        # static analysis of the port's tree: pure AST, dispatched
        # before the flags are parsed and before torch is imported
        from ziria_tpu_torch.analysis.__main__ import main as lint_main
        return lint_main(argv[1:])
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
    if args.scan:
        return _run_scan(args, dev)
    comp, src_in_ty, src_out_ty = _resolve_prog(args)
    in_ty = args.input_type or src_in_ty or "int32"
    out_ty = args.output_type or src_out_ty or "int32"

    pre_read = None      # input parsed early by --pp-costs=measured
    # autolut first: fold's map-map fusion erases in_domain declarations,
    # so the LUT rewrite must see the maps before they fuse
    if args.autolut:
        from ziria_tpu_torch.core.autolut import autolut
        comp = autolut(comp)
    if args.pp is not None and args.pp >= 1:
        comp, pre_read = _auto_pp(comp, args, in_ty, dev)
    if args.fold:
        from ziria_tpu_torch.core.opt import fold
        comp = fold(comp)
    if args.ddump_fold:
        print(comp, file=sys.stderr)
    if args.ddump_vect:
        from ziria_tpu_torch.core.vectorize import vectorize
        print(vectorize(comp, device=dev).dump(), file=sys.stderr)
    if args.ddump_hybrid:
        from ziria_tpu_torch.backend.hybrid import hybridize
        print("hybrid plan:", file=sys.stderr)
        hybridize(comp, dump=lambda s: print(s, file=sys.stderr),
                  device=dev)

    if args.batch_input_files or args.batch_output_files:
        return _run_batch_files(comp, args, in_ty, out_ty, dev)

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
    xs = pre_read if pre_read is not None else read_stream(in_spec)
    reset_counters()
    LAST_RUN.clear()
    t0 = time.perf_counter()

    def run():
        _check_mesh_flags(args)
        if args.pp is not None:
            return _run_auto_pp(comp, xs, args, t0, dev)
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
              f"{c['viterbi']} launches={c['launches']} chunk="
              f"{c['chunk']}", file=sys.stderr)
    if args.verbose or args.ddump_hybrid or args.stats:
        _report_demoted()
    if args.verbose:
        print(f"items in: {xs.shape[0]}, items out: {ys.shape[0]}, "
              f"time: {dt:.4f}s "
              f"({xs.shape[0] / max(dt, 1e-12):,.0f} items/s)",
              file=sys.stderr)
    return 0


def _run_scan(args, dev) -> int:
    """--scan: the long-capture workflow, packet search and a frame-
    batched decode of every hit (phy/search.scan_and_decode). The
    program is fixed (the in-language receiver); --src/--prog are
    rejected so a mismatch cannot pass silently."""
    if args.src or args.prog:
        raise SystemExit("--scan uses the in-language receiver; drop "
                         "--src/--prog")
    if args.profile or args.profile_trace or args.stats \
            or args.pp is not None or args.state_in or args.state_out \
            or args.batch_input_files or args.batch_output_files:
        raise SystemExit("--scan cannot combine with --pp/--profile/"
                         "--profile-trace/--stats/--state-*/--batch-*")
    if args.input != "file" or not args.input_file_name:
        raise SystemExit("--scan needs --input=file with "
                         "--input-file-name (a complex16 capture)")
    if args.sp is not None and args.sp < 1:
        raise SystemExit(f"--sp={args.sp}: need at least 1 device")
    # fail on a bad output spec BEFORE the scan spends minutes
    out_spec = StreamSpec(kind=args.output, ty="bit",
                          path=args.output_file_name,
                          mode=args.output_file_mode)
    from ziria_tpu_torch.parallel.streampar import StreamParError, \
        stream_mesh
    from ziria_tpu_torch.phy.search import scan_and_decode

    xs = read_stream(StreamSpec(kind="file", ty="complex16",
                                path=args.input_file_name,
                                mode=args.input_file_mode))
    try:
        mesh = None
        if args.sp is not None:
            mesh = stream_mesh(args.sp, device=dev)
        reset_counters()
        t0 = time.perf_counter()
        hits = scan_and_decode(xs, mesh=mesh, device=dev)
    except StreamParError as e:
        raise SystemExit(f"--sp={args.sp}: {e}")
    dt = time.perf_counter() - t0
    payload = (np.concatenate([b for _s, b in hits])
               if hits else np.empty((0,), np.uint8))
    write_stream(out_spec, payload)
    LAST_RUN.clear()
    LAST_RUN.update(backend="scan", seconds=dt, items_in=int(xs.shape[0]),
                    items_out=int(payload.shape[0]),
                    packets=[s for s, _b in hits], **counters())
    if args.verbose:
        _report_demoted()
        print(f"scan: {xs.shape[0]} samples, {len(hits)} packet(s) "
              f"validated at {[s for s, _b in hits]}, "
              f"{payload.shape[0]} payload bits, time: {dt:.3f}s",
              file=sys.stderr)
    return 0


def _run_batch_files(comp, args, in_ty, out_ty, dev) -> int:
    """--batch-input-files: N independent streams through one
    hybridized program, chunk-machine steps batched across them
    (backend/framebatch.run_many). Each stream's output goes to the
    matching --batch-output-files entry, equal to N separate runs."""
    if not (args.batch_input_files and args.batch_output_files):
        raise SystemExit("--batch-input-files and --batch-output-files "
                         "must be given together")
    ins = [f for f in args.batch_input_files.split(",") if f]
    outs = [f for f in args.batch_output_files.split(",") if f]
    if len(ins) != len(outs):
        raise SystemExit(
            f"--batch-*: {len(ins)} inputs but {len(outs)} outputs")
    if args.backend == "jit":
        args.backend = "hybrid"           # the documented implication
    if args.backend != "hybrid" or args.profile or args.profile_trace \
            or args.stats or args.sp is not None \
            or args.pp is not None or args.state_in or args.state_out:
        raise SystemExit("--batch-input-files runs the hybrid backend "
                         "and cannot combine with --sp/--pp/--profile/"
                         "--profile-trace/--stats/--state-*")

    from ziria_tpu_torch.backend.chunked import STATS
    from ziria_tpu_torch.backend.framebatch import StepBatcher, run_many
    from ziria_tpu_torch.backend.hybrid import hybridize

    frames = [read_stream(StreamSpec(kind="file", ty=in_ty, path=f,
                                     mode=args.input_file_mode))
              for f in ins]
    hyb = hybridize(comp, device=dev)
    reset_counters()
    t0 = time.perf_counter()
    b = StepBatcher(len(frames))
    results = run_many(hyb, [list(x) for x in frames], batcher=b)
    dt = time.perf_counter() - t0
    for f, res in zip(outs, results):
        write_stream(StreamSpec(kind="file", ty=out_ty, path=f,
                                mode=args.output_file_mode),
                     _host(res.out_array()))
    LAST_RUN.clear()
    LAST_RUN.update(backend="hybrid", seconds=dt, frames=len(frames),
                    device_calls=b.device_calls,
                    group_sizes=list(b.group_sizes),
                    replays=STATS["replays"],
                    host_reads=STATS["host_reads"], **counters())
    if args.verbose or args.ddump_hybrid:
        _report_demoted()
    if args.verbose:
        n_in = sum(x.shape[0] for x in frames)
        n_out = sum(len(r.outputs) for r in results)
        print(f"batch: {len(frames)} streams, items in: {n_in}, "
              f"items out: {n_out}, device calls: {b.device_calls} "
              f"(group sizes {b.group_sizes}), time: {dt:.4f}s",
              file=sys.stderr)
    return 0


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
            # jit when the stage lowers, hybrid otherwise: the stage
            # timing of --pp-costs=measured too
            from ziria_tpu_torch.parallel.autosplit import stage_runner
            go = stage_runner(st, cur, width=args.width, device=dev)
            how = go.backend
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
    from ziria_tpu_torch.backend import chunked, hybrid
    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.frontend import externals
    from ziria_tpu_torch.ops import viterbi_cuda
    E.reset_counts()
    hybrid.reset_counts()
    chunked.reset_counts()
    for k in externals.VITERBI_CALLS:
        externals.VITERBI_CALLS[k] = 0
    viterbi_cuda.reset_launches()


def counters() -> dict:
    from ziria_tpu_torch.backend import chunked, hybrid
    from ziria_tpu_torch.frontend import eval as E
    from ziria_tpu_torch.frontend import externals
    from ziria_tpu_torch.ops import viterbi_cuda
    return {"blocks_device": hybrid.BLOCKS["device"],
            "blocks_host": hybrid.BLOCKS["host"],
            "device_loop_iters": E.COUNTS["device_loop_iters"],
            "syncs": E.COUNTS["syncs"],
            "viterbi": dict(externals.VITERBI_CALLS),
            "chunk": dict(chunked.STATS, demoted=len(chunked.DEMOTED)),
            "launches": {k: v for k, v in viterbi_cuda.LAUNCHES.items()
                         if v}}


def _report_demoted() -> None:
    """One stderr line per chunk machine that the run's discovery pass
    sent back to the interpreter (chunked.DEMOTED)."""
    from ziria_tpu_torch.backend import chunked
    for label, why in chunked.DEMOTED:
        print(f"chunk machine demoted to the interpreter: {label}: {why}",
              file=sys.stderr)


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
    if args.sp is not None:
        return _run_sp(comp, xs, args, t0, dev)
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


def _check_mesh_flags(args) -> None:
    """--sp and --pp checked before any run, so neither can be ignored."""
    if args.sp is not None:
        if args.sp < 1:
            raise SystemExit(f"--sp={args.sp}: need at least 1 device")
        if args.backend != "jit" or args.profile:
            raise SystemExit("--sp needs --backend=jit (sequence "
                             "parallelism shards the fused pipeline) "
                             "and cannot combine with --profile")
    if args.pp is not None:
        if args.pp < 1:
            raise SystemExit(f"--pp={args.pp}: need at least 1 device")
        if args.backend != "jit" or args.profile or args.sp is not None \
                or args.state_in or args.state_out:
            raise SystemExit("--pp needs --backend=jit and cannot "
                             "combine with --sp/--profile/--state-*")


def _auto_pp(comp, args, in_ty, dev):
    """--pp=N's placement, decided before fold (fold fuses across >>>
    but keeps |>>>| boundaries, so each segment still fuses inside).
    --pp=1 goes through the pass too: any |>>>| of the source lands on
    one device. Under --pp-costs=measured each stage is timed on the
    first 32768 items of the real input, which the run then reuses.
    Returns (comp, the input read, or None)."""
    from ziria_tpu_torch.parallel.autosplit import AutoSplitError, \
        auto_pipeline
    sample = pre_read = None
    if args.pp_costs == "measured":
        # refuse before seconds of sampling that the run would refuse
        if args.backend != "jit" or args.profile:
            raise SystemExit("--pp needs --backend=jit and cannot "
                             "combine with --profile")
        pre_read = read_stream(StreamSpec(
            kind=args.input, ty=in_ty, path=args.input_file_name,
            mode=args.input_file_mode, dummy_items=args.dummy_samples))
        if pre_read.shape[0] == 0:
            raise SystemExit("--pp-costs=measured: input sample is "
                             "empty (nothing to time)")
        sample = pre_read[: 1 << 15]
    try:
        comp = auto_pipeline(comp, args.pp, sample=sample,
                             width=args.width or 1, device=dev)
    except AutoSplitError as e:
        raise SystemExit(f"--pp={args.pp}: {e}")
    return comp, pre_read


def _run_sp(comp, xs, args, t0, dev):
    """--sp=N: the stream split over N devices of --platform
    (parallel/streampar.stream_parallel)."""
    from ziria_tpu_torch.backend.lower import LowerError
    from ziria_tpu_torch.parallel.streampar import StreamParError, \
        stream_mesh, stream_parallel
    if args.state_in or args.state_out:
        raise SystemExit("--sp cannot combine with --state-in/--state-out "
                         "(the sharded run has no single carry)")
    if args.stats:
        print("note: --stats reports the single-device fused plan and is "
              "unavailable under --sp", file=sys.stderr)
    try:
        ys = stream_parallel(comp, xs, stream_mesh(args.sp, device=dev),
                             width=args.width)
    except (StreamParError, LowerError) as e:
        raise SystemExit(f"--sp={args.sp}: {e}")
    return np.asarray(ys), time.perf_counter() - t0, "sp"


def _run_auto_pp(comp, xs, args, t0, dev):
    """--pp=N: the compiler-decided stage placement across N devices of
    --platform. Whole macro chunks run through the stage pipeline; a
    remainder continues on one device from the segments' exit carries,
    so any length equals the fused run."""
    from ziria_tpu_torch.backend.execute import run_jit_carry
    from ziria_tpu_torch.backend.lower import LowerError
    from ziria_tpu_torch.core import ir
    from ziria_tpu_torch.parallel.stages import lower_stage_parallel
    from ziria_tpu_torch.parallel.streampar import StreamParError, \
        stream_mesh

    if args.stats:
        print("note: --stats reports the fused single-device plan and "
              "is unavailable under --pp", file=sys.stderr)
    if args.width is not None and args.width < 1:
        raise SystemExit(f"--width={args.width}: must be >= 1")
    if args.width is None:
        print("note: --pp segments run at width 1; pass --width=W to "
              "vectorize each segment (widths multiply the macro "
              "chunk the input length must divide)", file=sys.stderr)
    try:
        # main() already decided the |>>>| placement (before fold)
        pp = lower_stage_parallel(
            comp, stream_mesh(args.pp, axis="pp", device=dev),
            width=args.width or 1, in_item=(xs.shape[1:], xs.dtype))
        m = xs.shape[0] // pp.take
        outs, carry = [], None
        if m:
            ys, carry = pp.run_carry(
                xs[: m * pp.take].reshape((m, pp.take) + xs.shape[1:]))
            outs.append(ys.reshape((m * pp.emit,) + ys.shape[2:]))
        if xs.shape[0] > m * pp.take or not m:
            # the remainder on the fused one-device path (the segments
            # as one >>> pipeline, the same carry layout)
            tail, _ = run_jit_carry(ir.pipe(*ir.par_segments(comp)),
                                    xs[m * pp.take:], carry=carry,
                                    width=args.width, device=dev)
            if np.asarray(tail).shape[0]:
                outs.append(np.asarray(tail))
    except (LowerError, StreamParError) as e:
        raise SystemExit(f"--pp={args.pp}: {e}")
    ys = (np.concatenate(outs, axis=0) if outs
          else np.empty((0,) + xs.shape[1:], xs.dtype))
    return ys, time.perf_counter() - t0, "pp"


def _host(ys) -> np.ndarray:
    """The interpreter's output stack as numpy (items a device block
    left on the device come back here)."""
    import torch
    if isinstance(ys, torch.Tensor):
        return ys.detach().cpu().numpy()
    return np.asarray(ys)


if __name__ == "__main__":
    sys.exit(main())
