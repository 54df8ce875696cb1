#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ziria_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. device: requires CUDA (exits non-zero without it), turns TF32 off for
   matmuls and convolutions, reports the card;
2. build: compiles every CUDA source under ziria_tpu_torch/csrc/ with
   nvcc for sm_90a, one nvcc per source, all started together;
3. kernel_parity: every kernel against its plain PyTorch version on the
   card, bitwise (decisions, final metrics as int32 bit patterns,
   traceback bits): the ACS kernel of each decode mode (float32, int16
   and int8 metrics at radix 2 and 4) and the traceback (float32 and
   int32 metrics) at B=128, T=8192 on random soft inputs with a lane
   with no erasure, an all-erasure lane, random erasure tails, tails
   ending 8 steps before to 8 after a renorm boundary, a -0.0 tail and
   an inf before a tail (whose sweep must not stop early), quantized
   for the integer modes, with an int8 lane of long +-15 runs that hits
   the -128 rail; each ACS kernel's stop steps lie past each frame's
   last live step, on a renorm boundary; the
   rate-switched fused kernel at B=128, 64 symbols, all 8 rates, random
   bit counts with the stop edge lanes (FUSED_*): an all-erasure lane,
   lanes ending 8 steps before to 8 after a renorm boundary, lanes of
   Tp bits and more, an inf symbol before a lane's bits end (whose
   sweep must not stop early), NaN symbols past a lane's bits and a
   lane whose metrics are +0 long before its bits end; the known-rate
   fused kernel at each rate, B=128, the same; both fused kernels at
   radix 2 and 4, each fused kernel's stop steps on renorm boundaries at
   or past each frame's bits, the edge lanes' at the first boundary they
   can. Each radix-4 kernel also equals its radix-2 twin bitwise;
4. end_to_end: 128 captures, 16 at each of the 8 rates, each a
   1000-byte PSDU (996 random bytes + FCS) behind a random offset, with
   a random CFO and AWGN at 25 dB, made by the port's TX and a seeded
   numpy channel. Each path runs with every launch count zeroed just
   before it and read just after, and must launch exactly the kernels
   named:
   a. ``receive_many(check_fcs=True)``: ACS and traceback kernels;
   b. ``fused_demap=True``: one rate-switched fused launch, one
      traceback; field for field equal to (a);
   c. ``batched_acquire=False, sco_track=True``: ACS and traceback;
   d. one capture per rate through ``rx.receive(check_fcs=True,
      fused_demap=True)``: 8 known-rate fused launches, equal to (a);
   e. the same 8 through the default ``rx.receive`` (the scan decoder,
      no kernel), equal again;
   f. ``viterbi_radix=4``: one radix-4 ACS launch; equal to (a);
   g. ``fused_demap=True, viterbi_radix=4``: one radix-4 rate-switched
      fused launch; equal to (a);
   h. ``viterbi_metric="int16"`` at radix 2 and 4: one int16 ACS launch
      each, the two equal field for field;
   i. ``viterbi_metric="int8"`` at radix 2 and 4: the same with int8;
   j. ``viterbi_window=1024``: one ACS launch over the 128 x 108 window
      lanes; equal to (a);
   k. the 8 per-rate captures through ``rx.receive`` with
      ``viterbi_radix=4`` (8 radix-4 ACS launches), ``viterbi_metric=
      "int8"`` (8 int8 ACS launches), ``fused_demap=True,
      viterbi_radix=4`` (8 radix-4 known-rate fused launches) and
      ``viterbi_metric="int16"`` (the int16 scan, no kernel); each
      equal to (a)'s lanes.
   Every lane of every path must come back ok with its rate, length,
   payload bits and a good FCS;
5. stream: the streaming receiver (``StreamReceiver``, pushed in
   slabs of 50,000 samples, then flushed) on two streams of the port's
   TX with random gaps, one CFO each and AWGN at 25 dB referenced to
   frame power: ``stream_default``, 256 frames at ``Geometry()``'s
   defaults (chunk 8192, frame_len 2048, K 8), the 8 rates in turn,
   each PSDU the longest that fits 20 symbols; ``stream_wide``, 128
   frames of 1000-byte PSDUs, one to a 32,768-sample window (chunk
   131,072, K 8: the 110,592-step trellis of ``receive_many``), in the
   default mode and with ``fused_demap=True``. Each run with every
   launch count zeroed just before it and read just after: every true
   frame emitted once, at its true start, right and with a good FCS;
   no overflow chunk, nothing degraded, no containment counter moved;
   ACS (fused: rate-switched fused) and traceback launches each equal
   to the decode dispatches, and no other launch; then each of those
   kernels, at the inputs of the run's first decode dispatch (8 lanes
   of 6,912 steps default, 110,592 wide), bitwise equal to its plain
   version, its stop steps checked as in phase 3, timed beside its
   plain version and its bound (these launches count nowhere). Then
   16 frames of
   the fused wide run (2 a rate) equal ``rx.receive(fused_demap=True)``
   over their windows; the wide stream checkpointed half way and
   resumed in a new receiver equals the uninterrupted run; and
   ``receive_many_device`` on the end-to-end batch, padded to its
   bucket and uploaded once, equals ``receive_many``. Times: samples/s
   and frames/s of each stream, mean CUDA-event ms of a chunk scan and
   of a decode, chunks, decode dispatches, chunks in flight, peak
   device memory;
6. fleet: the S-stream fleet (``MultiStreamReceiver`` at
   ``Geometry().n_streams`` = 8 streams, each stream's slab of 50,000
   samples pushed together, then flushed): ``fleet_default`` at
   ``Geometry()``'s defaults, six streams of 32 frames of 20 symbols
   (each starting at a different rate), an all-noise stream and a
   stream shorter than a chunk; ``fleet_wide`` at ``stream_wide``'s
   geometry, eight streams of 16 frames of 1000-byte PSDUs, in the
   default mode and with ``fused_demap=True``. Each run with the
   launch counts zeroed just before it and read just after: every
   true frame right, once, at its true start; each stream equal to a
   lone ``StreamReceiver`` on it; one scan a chunk-step and at most
   one decode; ACS (fused) and traceback launches equal to the decode
   dispatches; nothing degraded, no containment counter moved; the
   kernels at the first fleet decode's inputs (64 lanes) bitwise equal
   to their plain versions as in phase 5, and the decode's fronts
   giving each lane the same bits in the 64-lane batch as in its
   stream's 8. Then the wide fleet checkpointed half way
   (``checkpoint_fleet``), every lane restored into a fresh fleet,
   equal to the uninterrupted run. Times: aggregate and per-stream
   samples/s, CUDA-event ms of a chunk-step's scan and of a decode,
   chunk-steps, active lanes and steps in flight, peak device memory;
7. serve: ``ServeRuntime(ServeConfig(check_fcs=True))`` (8 lanes at
   ``Geometry()``): 24 clients of 8 frames each in ragged slabs of
   1,000-20,000 samples through ``run_clients``, 16 of them queued at
   first; one client's middle slab NaN in every 7th sample, one client
   evicted once half its stream is in its lane and reconnected with its
   blob. Every healthy session equal to a lone ``StreamReceiver`` and
   right; the NaN session quarantined (only its quarantine counters
   move), equal to a lone sanitizing ``StreamReceiver`` fed the slabs
   its lane got and emitting only frames of its clean stream;
   ``stats()`` balanced; at most two dispatches a chunk-step and two
   chunk-steps a tick; ``scrape()`` with
   ``serve.chunk_seconds``. Then the same clients with a snapshot every
   4 chunk-steps, the runtime dropped without a drain once half the
   frames were delivered, ``ServeRuntime.recover`` and the clients
   resubmitting from ``acked``: the emissions, deduplicated by start,
   equal the first run's (the NaN session's again only frames of its
   lone receiver);
8. link: ``link.loopback_many`` over 128 PSDUs of 1000 bytes (16 a
   rate, FCS appended and checked) at 25 dB per lane, CFO U(-0.01,
   0.01), delay U[0, 200), each run with the launch counts zeroed just
   before it and read just after: fused (one ACS and one traceback
   launch), fused with ``fused_demap=True`` (one rate-switched fused
   launch, one traceback) and staged (one ACS, one traceback); every
   lane right, the three equal field for field, nothing degraded. Then
   the ACS, traceback and rate-switched fused kernels at the first 16
   lanes of the link's decode inputs bitwise equal to their plain
   versions, stops checked; ``impair_many`` rows equal to
   ``impair_one`` bitwise; the per-frame oracle (``rx.receive`` with
   the known-rate fused kernel) equal to the batch on 8 lanes; an
   urban-profile batch fused equal to staged. Times: the fused batch
   (host clock, 3 reps), each stage under CUDA events (``encode_prep``,
   ``impair_many_graph`` and its threefry ``normal``, acquire, gather,
   front, ACS, traceback, CRC), the host's share on the host clock
   (``_LinkGeometry`` with its ``batch_host_prep``, ``_fused_pass``, the
   classification read's wait, ``_fused_results``), frames/s, capture
   samples/s, peak device memory;
9. sweep: ``link.sweep_ber`` over 64 PSDUs of 1000 bytes, rates 6, 24
   and 54 Mbit/s, 0-14 dB in 2 dB steps, seeds 0 and 1: one ACS and
   one traceback launch a (point, rate), nothing else; counts equal to
   ``loopback_ber_bits`` at two points; no error at 6 Mbit/s at 14 dB.
   The waterfall (BER per rate and SNR), wall ms and ms a (point,
   rate);
10. synth: ``serve.synth_load(8, 16, 12)``'s streams (made by
   ``link.stream_many_multi``) through ``receive_streams`` at the
   reference's serve-test geometry (chunk 4096, frame 1024, K 8; a
   12-byte PSDU + FCS fills at most 7 symbols, so every frame fits the
   window and none reaches the next frame's preamble): launches equal
   to the decode dispatches, every frame emitted once at its true start
   and right, each stream equal to a lone ``StreamReceiver``;
   samples/s;
11. compiler: the Ziria compiler of the port, through its CLI
   (``python -m ziria_tpu_torch``'s ``main``, ``--platform=cuda``):
   the ``--ddump-hybrid`` plan of ``examples/wifi_rx.zir``, whose
   stream-control loops must be the reference's chunk machines (1
   While, 32 For, in order: ``COMPILER_MACHINES``); the 28 golden cases of ``examples/make_golden.py``
   (``COMPILER_CASES``: 22 on the jit backend, ``wifi_tx_full``,
   ``wifi_tx_rates``, ``wifi_loopback`` and ``wifi_loopback_fxp`` on
   the interpreter, ``wifi_rx`` and ``wifi_rx_fxp`` on the hybrid
   backend; the four fixed-point cases under ``--fxp-complex16``, the
   two AutoLUT cases under ``--autolut``), each output equal to its
   committed ``.outfile.ground`` under the port's ``stream_diff`` at
   ``tests/test_golden.py``'s tolerances; a ``--state-out`` /
   ``--state-in`` round trip of ``scrambler.zir`` equal to its one-shot
   run; then the
   flagship ``examples/wifi_rx.zir`` on the hybrid backend at full
   width, one capture per rate at 54 and 6 Mbit/s, each a 1000-byte
   PSDU (+ FCS) from ``channel.impaired_capture``, once with the
   default decode (the scan decoder, no kernel) and once with
   ``--viterbi-window=1024`` (the ACS and traceback kernels, each
   launched at least once, each held bitwise to its plain version at
   its own inputs); the payload must come out right. The first such
   run also runs every chunk-machine step eagerly at the same inputs
   and holds the captured graph's step to it bitwise (it, pos, out_n,
   emitted items and carries of every lane). Each run reports the
   backend that ran, host ms (beside ``COMPILER_BEFORE_S``, the frame
   time before the loops ran as chunk machines), items in and out,
   do-blocks on the device and on the host, device-loop iterations,
   host syncs, viterbi_soft decodes, launches and the chunk machines'
   steps, captures, replays and host reads. No run of this phase, of
   the batch phase or of the ``wifi_rx`` trace may demote a chunk
   machine to the interpreter;
12. batch: frame batching, the packet search and the vectorizer through
   the CLI. ``--batch-input-files`` over ``BATCH_CAPS`` 24 Mbit/s
   captures of 60 bytes + FCS, default and ``--viterbi-window=64``
   (short enough to window a 60-byte frame): every output equal to its
   lone run (the program as the CLI builds it, one capture at a time)
   and to its PSDU, the batch's chunk-machine steps at most
   twice a lone frame's, launches zeroed just before each batch and
   read just after (none by default; ACS and traceback windowed, each
   held bitwise to its plain version at the batch's own inputs);
   ``--scan`` over a capture of one packet per ``SCAN_RATES`` rate
   (12-100 bytes + FCS, 900-sample noise gaps): every PSDU back, found
   where it was put; again with one packet's DATA negated: the other
   seven; ``--ddump-vect`` on ``scrambler.zir``, and ``run_vect`` of a
   static integer pipeline at the card's model constants equal to the
   CPU's; frames, steps, replays, host reads and ms;
13. fxp: the fixed-point path. Every ``ops/fxp`` primitive (the
   float64 DFT products included) and ``ext_math`` function on the card
   bitwise equal to the CPU; ``rx_fxp.decode_data_batch_fxp`` on 128
   frames at the reference benchmark's fxp stage geometry (a 1000-byte
   PSDU at 54 Mbit/s, frame_len 400 + 80 * 38; lane 0 its frame, the
   rest random PSDUs at 30 dB), exact and with ``viterbi_window=1024``,
   each run with the launch counts zeroed just before it and read just
   after (one ACS and one traceback launch): all 128 PSDUs right, the
   two runs equal, 4 lanes equal to the CPU's decode, the ACS and
   traceback kernels bitwise equal to their plain versions at the run's
   own inputs; ``rx.receive(fxp=True)`` on an impaired 1000-byte
   capture at 54 and at 6 Mbit/s (the scan decoder, no launch), right
   with a good FCS; ``transceiver.run_link`` of two short payloads
   between two stations, fxp off and on: delivered, ACKed, no retry.
   Times: batch ms (host clock, 3 reps), samples/s as ``bench.py``'s
   ``sps`` (128 * frame_len / batch seconds), CUDA-event ms of the
   front and of the decode, peak device memory;
14. observe: the CLI's run and serve surface, tracing, the program
   observatory and the autotuner, each through ``runtime/cli.main`` on
   the card. ``serve`` at the reference's defaults (4 lanes, 6 sessions
   of 2 frames, chunk 4096, frame 1024), then under a ``--chaos`` plan
   of transient scan and decode faults with ``--metrics-dump``, then with
   ``--snapshot-dir`` and a ``--recover`` from it: every report counts
   every frame, its stats balanced; the fault-free fleet's ACS and
   traceback launches equal to its decode dispatches, the faulted
   fleet's equal to each other, at least one and at most its decode
   dispatches. ``--prog`` for
   ``fir``, ``fft64``, ``ifft64``, ``scramble`` and ``wifi_tx_sym_54``
   on the card against ``--platform=cpu`` (``scramble`` bit-equal, the
   rest within ``OBSERVE_PROGS``' tolerances). ``--trace`` on
   ``scrambler.zir`` (the jit executor's spans) and on the ``wifi_rx``
   golden case with ``--viterbi-window=64`` and the kernels built afresh
   inside the run: its output equal to the ground file, the trace
   parsing, holding the hybrid and windowed-decode spans and one
   ``nvcc:viterbi.cu`` compile. ``--profile --profile-trace`` on
   ``scrambler.zir``: CUDA-event stage times, a profiler trace with
   kernels and the site ranges. ``programs --batch --trace-dir``: the
   128-capture ``receive_many`` batch (default and ``fused_demap``) and
   the 128-frame ``decode_data_batch_fxp`` batch under
   ``torch.profiler``, every PSDU right, the ACS, traceback and fused
   launches the profiler saw equal to the wrappers' counters and each
   block's own kernels (``OBSERVE_LAUNCHED``) launched, the kept trace
   naming the ACS and traceback kernels; per site its launches, device
   and host ms and top kernels, and each batch's device busy and idle
   share under the profiler and its busy ms over the batch's unprofiled
   ms. ``autotune --frames 8 --reps 2`` into a record file of
   its own: the winner identity-clean, ``Geometry.tuned`` reproducing
   it, no file of the checkout changed. At most ``OBSERVE_BUDGET_S``;
15. mesh: the port's ``parallel/`` on the card, every sharded run over
   ``MESH_ENTRIES`` (4) entries of ``cuda:0`` (the card's counterpart of
   the reference tests' virtual devices), launch counts zeroed just
   before each run and read just after. ``fleet_wide`` (8 streams of 16
   1000-byte frames, chunk 131,072) default and ``fused_demap`` through
   ``MultiStreamReceiver(mesh=)``: every frame right and equal to the
   fleet phase's unsharded run of the same streams (held there to their
   lone receivers); 4 ACS (fused) and 4 traceback launches a decode
   dispatch, one a shard; each shard's kernels at its first decode's
   inputs bitwise equal to their plain versions. ``sweep_ber_sharded``
   over the sweep phase's PSDUs and grid equal to ``sweep_ber`` count
   for count, 4 ACS and 4 traceback launches a (point, rate). The
   packet search over ``SCAN_RATES``' 8-packet capture split over 4
   ``sp`` entries: the metric within 2e-4 of the unsharded one, the
   starts and ``scan_and_decode``'s packets equal (timed unsharded,
   sharded, unsharded: the first pays the receiver's compile).
   ``stream_parallel`` (4 entries) of a scrambler phase counter with its
   ``advance`` and of
   the 5-tap FIR with ``memory=5`` (``--prog`` ``scramble`` and
   ``fir``, over the golden ``scrambler`` and ``fir`` inputs) and
   ``lower_stage_parallel`` (2 entries) of each program piped into
   itself, equal to ``run_jit`` (the scrambler bitwise, the FIR within
   1e-5). The CLI: ``--sp=1`` and ``--pp=1 --pp-costs=measured`` equal
   the runs without them; ``--sp=4`` and ``--pp=2`` refuse with the
   reference's message on one card. An NCCL process group of one up,
   one all_reduce, down. ``ServeConfig(shard=True)`` (an unsharded fleet
   on one card, the elastic rule) equal to ``shard=False``. At most
   ``MESH_BUDGET_S``;
16. soak: ``tools/soak.soak_stats`` of the port at the reference chip
   soak stage's arguments (``SOAK_ARGS``: 6 sessions of 4 frames on 8
   lanes, 4 in-process fault rounds, the ``urban`` channel round, 2
   SIGKILL rounds, seed 20260804, tick 0.05 s): every gate of the
   campaign holds (zero crashes, every session bit-identical to its
   uninterrupted oracle, recovery p99 within ``SOAK_SLO_S``), at least
   one SIGKILL lands, every child process (``python -m
   ziria_tpu_torch.tools.soak --child`` on the card) loads the kernel
   library without running nvcc and rebuilds the parent's streams bit
   for bit, and every recovered fleet makes at most 2 dispatches a
   chunk-step, no nvcc run, no library load and one ACS and one
   traceback launch a decode dispatch. With them one kind round for
   each of the 11 menu entries (``kind_frames`` 16: streams of 16
   frames, crashed once their input is exhausted), each kind firing
   and each round held to the same gates; launches zeroed just before the
   campaign and read just after; the ACS and traceback kernels at the
   warm pass's first decode bitwise equal to their plain versions as in
   phase 5. Then ``tools/windowed_ber``'s study (16 frames of 4096
   bits, window 512, overlaps 32/64/96, amplitudes 0.5-1.2, the scan
   decoder exact, the windowed decodes through the kernels, launches
   zeroed just before and read just after: one ACS and one traceback a
   windowed decode): at 1.2 with overlap 96 the windowed decode equals
   the exact one, at 0.9 the BERs agree within ``SOAK_BER_ENVELOPE``,
   and at every point and overlap the kernel path equals the plain
   versions in the ``_decode`` hook bitwise. Prints the faults by kind,
   each round's recovery seconds with p50 and p99, duplicates and
   deduplicated frames, each child's CUDA init seconds and the BER
   table. At most ``SOAK_BUDGET_S``;
17. timing: ``receive_many`` in every decode mode, the modes in turns
   (batch ms, frames/s, samples/s, peak device memory); CUDA-event
   times of each step of the default and fused decode paths and of
   each mode's decode step (quantize, window cut, ACS); per-capture
   ``receive`` ms per rate, fused and default; then each kernel at the
   main path's own inputs (and the ACS at the window path's) beside
   its plain version (held bitwise equal there too) and its bound;
   for each ACS and fused instance also the stop step per frame (max,
   mean), ns per step of the longest chain and the bound of the work it
   needed, every frame of the main path stopping at the first boundary
   it can; the traceback also on the fused path's words (zero past each
   frame's stop).

Phases 5-16 also print their wall seconds (``phase_s``). Then a
``{"kernels": [...]}`` line, the script's wall time, the
nvidia-smi name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failed check raises, and the script exits
non-zero without that line. It imports nothing of JAX or of the JAX
package.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 128                      # captures: the repo's benchmark batch
PSDU_BYTES = 1000            # 996 payload bytes + 4 FCS bytes
SNR_DB = 25.0
PARITY_T = 8192
PARITY_SYM = 64              # fused kernels' parity geometry (symbols)
WINDOW = 1024                # the windowed path's window
INF_LANE = 7                 # the parity lane with an inf soft value
# the fused kernels' stop edge lanes (fused_edge_lanes), also the CPU
# and card tests': lanes 0-16 with bit counts ending 8 steps before to 8
# after a renorm boundary, then one lane each of 0 bits, Tp bits, more
# than Tp bits, an inf symbol before its bits end, NaN symbols past its
# bits, and metrics +0 long before its bits end (BPSK, for the mixed
# kernel)
FUSED_EDGE = 17
FUSED_ZERO, FUSED_FULL, FUSED_LONG, FUSED_INF, FUSED_NAN, FUSED_QUIET = \
    range(FUSED_EDGE, FUSED_EDGE + 6)
FUSED_LANES = FUSED_EDGE + 6
FUSED_EXACT = [i for i in range(FUSED_LANES) if i != FUSED_INF]
# the stream phase: two streams of the port's TX, numpy gaps, one CFO
# per stream and AWGN at STREAM_SNR_DB referenced to frame power,
# pushed in slabs of STREAM_SLAB samples
STREAM_SNR_DB = 25.0
STREAM_SLAB = 50_000
STREAM_DEFAULT_FRAMES = 256      # at Geometry() (chunk 8192, frame 2048)
STREAM_DEFAULT_SYMBOLS = 20      # each PSDU the longest that fits them
STREAM_WIDE_FRAMES = 128         # 1000-byte PSDUs, one to a frame_len
STREAM_WIDE = {"chunk_len": 131072, "frame_len": 32768,
               "max_frames_per_chunk": 8}
STREAM_CFO = 0.004               # rad/sample
STREAM_DELAY = 60
STREAM_IDENTITY_PER_RATE = 2     # fused wide frames held to rx.receive
# the fleet phase: Geometry().n_streams streams through one
# MultiStreamReceiver, pushed STREAM_SLAB samples a stream at a time
FLEET_DEFAULT_STREAMS = 6        # 32 frames of 20 symbols each, + 2 odd
FLEET_DEFAULT_FRAMES = 32
FLEET_WIDE_FRAMES = 16           # 1000-byte PSDUs, 8 streams
# the serve phase: ServeRuntime at its default config (8 lanes,
# Geometry() defaults), SERVE_SESSIONS clients of SERVE_FRAMES frames
# in ragged slabs of SERVE_SLAB samples; one sends a NaN slab, one is
# evicted half way and reconnected with its blob
SERVE_SESSIONS = 24
SERVE_FRAMES = 8
SERVE_SLAB = (1_000, 20_000)
SERVE_NAN, SERVE_EVICT = 5, 2    # the sessions s5 and s2
# the link phase: LINK_B PSDUs of LINK_BYTES bytes (LINK_B / 8 a rate,
# FCS appended and checked) through link.loopback_many, per-lane SNR
# LINK_SNR_DB, CFO U(-LINK_CFO, LINK_CFO), delay U[0, LINK_DELAY); the
# kernels held to their plain versions on the first LINK_CHECK_LANES
# lanes of the first decode; the per-frame oracle on LINK_ORACLE lanes
LINK_B = 128
LINK_BYTES = 1000
LINK_SNR_DB = 25.0
LINK_CFO = 0.01
LINK_DELAY = 200
LINK_CHECK_LANES = 16
LINK_ORACLE = 8
LINK_IDENTITY_LANES = (0, 37, 90, 127)   # impair_many row == impair_one
LINK_SEED = 20261017
# the sweep phase: link.sweep_ber over SWEEP_B PSDUs of SWEEP_BYTES
SWEEP_B = 64
SWEEP_BYTES = 1000
SWEEP_RATES = (6, 24, 54)
SWEEP_SNRS = tuple(float(v) for v in range(0, 16, 2))   # 0 ... 14 dB
SWEEP_SEEDS = (0, 1)
SWEEP_LOOP_POINTS = ((0.0, 0), (8.0, 1))    # held to loopback_ber_bits
# the synth phase: serve.synth_load's SYNTH_SESSIONS streams of
# SYNTH_FRAMES frames of SYNTH_BYTES bytes through receive_streams at
# SYNTH_GEO, the reference's serve tests' geometry (tests/test_serve.py
# GEO). The window is sized to the longest frame (6 Mbit/s, 7 symbols,
# 960 samples): a window much wider than a short frame plus its 300-600
# sample gap holds the next frame's preamble, and the streaming
# receiver, the reference's as the port's, may time onto it
SYNTH_SESSIONS = 8
SYNTH_FRAMES = 16
SYNTH_BYTES = 12
SYNTH_GEO = {"chunk_len": 4096, "frame_len": 1024,
             "max_frames_per_chunk": 8}
SYNTH_SEED = 20261017
# the compiler phase: examples/make_golden.py's CASES as (name, file
# mode, backend, atol, CLI flags), the backend, tolerance and flags
# tests/test_golden.py gives each (--fxp-complex16 for FXP_CASES,
# --autolut for AUTOLUT_CASES; tests/test_torch_compiler_golden.py holds
# this table to the generator's)
COMPILER_CASES = (
    ("scrambler", "dbg", "jit", 0.0, ()),
    ("fir", "dbg", "jit", 0.0, ()),
    ("fft64", "dbg", "jit", 1.0, ()),
    ("interleaver", "dbg", "jit", 0.0, ()),
    ("wifi_tx_bpsk", "bin", "jit", 0.0, ()),
    ("lut_map", "dbg", "jit", 0.0, ("--autolut",)),
    ("qam16", "dbg", "jit", 1.0, ()),
    ("demap_bpsk", "dbg", "jit", 0.0001, ()),
    ("demap_qpsk", "dbg", "jit", 0.0001, ()),
    ("demap_qam16", "dbg", "jit", 0.0001, ()),
    ("demap_qam64", "bin", "jit", 0.0001, ()),
    ("deinterleave_bpsk", "dbg", "jit", 0.0, ()),
    ("deinterleave_qam16", "dbg", "jit", 0.0, ()),
    ("depuncture_23", "dbg", "jit", 0.0, ()),
    ("depuncture_34", "bin", "jit", 0.0, ()),
    ("pilot_track", "dbg", "jit", 1.0, ()),
    ("dc_remove", "dbg", "jit", 0.0, ()),
    ("crc_frame", "bin", "jit", 0.0, ()),
    ("correlator", "dbg", "jit", 0.0, ()),
    ("tx_qpsk_fxp", "bin", "jit", 0.0, ("--fxp-complex16",)),
    ("fm_demod", "dbg", "jit", 0.0, ("--fxp-complex16",)),
    ("wifi_tx_full", "bin", "interp", 1.0, ()),
    ("pack_bits", "dbg", "jit", 0.0, ("--autolut",)),
    ("wifi_rx", "bin", "hybrid", 0.0, ()),
    ("wifi_rx_fxp", "bin", "hybrid", 0.0, ("--fxp-complex16",)),
    ("wifi_tx_rates", "bin", "interp", 0.0, ()),
    ("wifi_loopback", "bin", "interp", 0.0, ()),
    ("wifi_loopback_fxp", "bin", "interp", 0.0, ("--fxp-complex16",)),
)
# the full-width runs of examples/wifi_rx.zir: one capture per rate,
# a PSDU of COMPILER_BYTES made by channel.impaired_capture (the recipe
# of examples/make_golden.py:149-155), default decode and windowed
COMPILER_RATES = (54, 6)
COMPILER_BYTES = 1000
COMPILER_SEED = 20261017
COMPILER_WINDOW = 1024
# seconds of a full-width wifi_rx.zir frame through the CLI before its
# loops ran as chunk machines (PERF.md §5), printed beside today's
COMPILER_BEFORE_S = "7.4-20.3"
# the plan of examples/wifi_rx.zir's stream-control loops: the
# reference's --ddump-hybrid (1 While, 32 For), in order
COMPILER_MACHINES = ("chunked While",) + ("chunked For",) * 32
# the batch phase: --batch-input-files over BATCH_CAPS impaired
# captures (tests/test_framebatch.py:127: 24 Mbit/s, 60 bytes + FCS,
# seeds 100 + k), default and windowed; then --scan over SCAN_RATES,
# one packet each of 12-100 bytes + FCS, between 900-sample noise gaps
# (tests/test_search.py:58), and again with one packet's DATA negated
BATCH_CAPS = 16
BATCH_MBPS = 24
BATCH_BYTES = 60
BATCH_SEED = 100
# a window short enough that a 60-byte frame's decode windows (and
# launches the ACS and traceback kernels), as OBSERVE_WINDOW
BATCH_WINDOW = 64
SCAN_RATES = (6, 9, 12, 18, 24, 36, 48, 54)
SCAN_GAP = 900
SCAN_SEED = 700
SCAN_CORRUPT = 3          # the packet whose DATA the second scan negates
# the compiler phase's --state-out/--state-in round trip (scrambler.zir)
STATE_BITS = 4096
STATE_SPLIT = 1500
# the fixed-point phase at the geometry of the reference benchmark's
# fxp_interior stage (bench.py: _setup and _fxp_stage): FXP_B frames of
# a 1000-byte PSDU at 54 Mbit/s, lane 0 the benchmark's own frame
# (default_rng(0)'s bytes, clean), the others random PSDUs under AWGN
FXP_B = 128
FXP_BYTES = 1000
FXP_MBPS = 54
FXP_SNR_DB = 30.0
FXP_WINDOW = 1024
FXP_CPU_LANES = 4        # lanes also decoded on the CPU, held bitwise
FXP_RECEIVE = (54, 6)    # rx.receive(fxp=True) captures: one per rate
FXP_LINK = (b"fixed-point frame one", b"and two")
FXP_SEED = 20261018
# the observe phase: the CLI's serve at the reference's defaults, then
# under transient faults with --metrics-dump, then snapshotted and
# recovered; the registry pipelines on the card against the CPU (input
# items and tolerance each); the traced, profiled golden cases (the
# wifi_rx one with a window short enough to launch the decode kernels,
# built afresh inside the trace; the profiler stays off there: under
# it, with its 142,813 kernels recorded, that run took 49 s on an H100
# host); the programs --batch profiles; the autotuner at a smoke size
OBSERVE_SERVE = ("--lanes", "4", "--sessions", "6", "--frames", "2",
                 "--chunk-len", "4096", "--frame-len", "1024")
OBSERVE_CHAOS = ("seed=3;rx.stream_chunk_multi:transient:every=5;"
                 "rx.stream_decode_multi:transient:every=3")
OBSERVE_PROGS = {"fir": ("float32", "float32", 1024, 1e-5),
                 "fft64": ("complex16", "float32", 1024, 1e-4),
                 "ifft64": ("complex16", "float32", 1024, 1e-4),
                 "scramble": ("bit", "bit", 4096, 0.0),
                 "wifi_tx_sym_54": ("bit", "float32", 8 * 216, 1e-4)}
OBSERVE_WINDOW = 64
OBSERVE_AUTOTUNE = ("--frames", "8", "--reps", "2")
OBSERVE_BUDGET_S = 120.0
# the kernels each programs --batch block must launch
OBSERVE_LAUNCHED = {"receive_many": ("acs", "traceback"),
                    "receive_many_fused": ("traceback", "fused_mixed"),
                    "fxp_batch": ("acs", "traceback")}
# the mesh phase: entries of cuda:0 a sharded run takes (the card's
# counterpart of the reference tests' virtual devices), the serve check's
# clients, the stage pipeline's entries, the CLI's golden programs
MESH_ENTRIES = 4
MESH_PP = 2
MESH_SERVE = (4, 4, 12)          # sessions, frames a session, PSDU bytes
MESH_SP_PROG = "interleaver"     # stateless: --sp=1 and the --sp refusal
MESH_PP_PROG = "qam16"           # two stages: the --pp=2 refusal
MESH_BUDGET_S = 120.0
# the soak phase: tools/soak.soak_stats at the arguments of the
# reference's chip soak stage (6 sessions, 8 lanes, 4 frames a session,
# 4 fault rounds, 2 SIGKILL rounds) and a kind round for each menu entry
# on 16-frame streams (the campaign's rounds crash one chunk-step in,
# before any dispatch or data fault can fire), then tools/windowed_ber's
# study at its own size; the guard's BER envelope (relative, absolute)
SOAK_ARGS = {"n_sessions": 6, "n_lanes": 8, "frames_per_session": 4,
             "rounds": 4, "sigkill_rounds": 2, "seed": 20260804,
             "tick_sleep": 0.05, "channel_profile": "urban",
             "kind_frames": 16}
SOAK_SLO_S = 30.0
SOAK_BER_ENVELOPE = (0.02, 2e-3)
SOAK_BUDGET_S = 240.0
# float operations per depunctured slot of the fused front: x * norm,
# |x|, up to three for the level formula, * gain, * valid, the mask
FRONT_OPS_PER_SLOT = 8
SYMBOL_BYTES = 96 * 4        # one equalized OFDM symbol: 48 float32 pairs
# the ACS modes: (metric dtype, radix) by launch key
MODES = {"acs": ("float32", 2), "acs_r4": ("float32", 4),
         "acs_i16": ("int16", 2), "acs_i16_r4": ("int16", 4),
         "acs_i8": ("int8", 2), "acs_i8_r4": ("int8", 4)}
# the CUDA instance behind each launch key (csrc/viterbi.cu) and the
# Pallas kernel it replaces (ziria_tpu/ops/viterbi_pallas.py)
KERNELS = {
    "acs": ("acs_kernel<F32, 2>", "ziria_tpu/ops/viterbi_pallas.py:332"),
    "traceback": ("traceback_kernel<float|int>",
                  "ziria_tpu/ops/viterbi_pallas.py:517"),
    "fused_mixed": ("fused_acs_mixed_kernel<2>",
                    "ziria_tpu/ops/viterbi_pallas.py:1174"),
    "fused_rate": ("fused_acs_rate_kernel<2>",
                   "ziria_tpu/ops/viterbi_pallas.py:893"),
    "acs_r4": ("acs_kernel<F32, 4>", "ziria_tpu/ops/viterbi_pallas.py:369"),
    "acs_i16": ("acs_kernel<I16, 2>", "ziria_tpu/ops/viterbi_pallas.py:402"),
    "acs_i16_r4": ("acs_kernel<I16, 4>",
                   "ziria_tpu/ops/viterbi_pallas.py:447"),
    "acs_i8": ("acs_kernel<I8, 2>", "ziria_tpu/ops/viterbi_pallas.py:447"),
    "acs_i8_r4": ("acs_kernel<I8, 4>", "ziria_tpu/ops/viterbi_pallas.py:447"),
    "fused_mixed_r4": ("fused_acs_mixed_kernel<4>",
                       "ziria_tpu/ops/viterbi_pallas.py:1174"),
    "fused_rate_r4": ("fused_acs_rate_kernel<4>",
                      "ziria_tpu/ops/viterbi_pallas.py:893"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_timed(obj, t0: float) -> float:
    """Print a phase's line with its wall seconds since `t0`; returns
    the time the next phase starts at."""
    now = time.perf_counter()
    emit(dict(obj, phase_s=now - t0))
    return now


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of `fn()` on the card over `reps` calls, from
    CUDA events around the whole run."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_timed(fn):
    """(result, milliseconds) of one `fn()` under CUDA events."""
    out = {}

    def run():
        out["r"] = fn()
    ms = cuda_ms(run)
    return out["r"], ms


def host_ms(fn):
    """(result, milliseconds) of `fn()` on the host clock, the card
    synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def make_captures(rng, device):
    """B captures: 16 per rate, PSDU_BYTES each (random body + FCS),
    random offset and CFO, complex AWGN at SNR_DB."""
    import torch

    from ziria_tpu_torch.ops.crc import append_crc32
    from ziria_tpu_torch.phy.wifi import params, tx
    from ziria_tpu_torch.utils.bits import bytes_to_bits

    caps, sent, rates = [], [], []
    sigma = np.sqrt(10 ** (-SNR_DB / 10) / 2)
    for k in range(B):
        m = params.RATE_MBPS_ORDER[k % 8]
        body = rng.integers(0, 256, PSDU_BYTES - 4).astype(np.uint8)
        s = tx.encode_frame(body, m, add_fcs=True, device=device)
        bits = append_crc32(bytes_to_bits(torch.from_numpy(body)))
        s = s.cpu().numpy()
        off = int(rng.integers(16, 4000))
        eps = float(rng.uniform(-0.01, 0.01))
        z = np.zeros(off + s.shape[0] + 200, np.complex128)
        z[off:off + s.shape[0]] = s[:, 0] + 1j * s[:, 1]
        z *= np.exp(1j * eps * np.arange(z.size))
        z += sigma * (rng.normal(size=z.size) + 1j * rng.normal(size=z.size))
        caps.append(np.stack([z.real, z.imag], -1).astype(np.float32))
        sent.append(bits.numpy())
        rates.append(m)
    return caps, sent, rates


def parity_inputs(rng, b, t):
    """Random soft pairs: lane 0 with no erasure, lane 3 all erasures,
    lanes 8, 16, ... with random erasure tails, lanes 9, 11, ..., 41
    live up to 8 steps before to 8 steps after the renorm boundary
    t // 2, lane 1 with a -0.0 tail, lane 7 with an inf before its
    tail."""
    llr = (rng.normal(size=(b, t, 2)) * 2.0).astype(np.float32)
    llr[3] = 0.0
    for k in range(8, b, 8):
        llr[k, int(rng.integers(t // 4, t)):] = 0.0
    for i, off in enumerate(range(-8, 9)):
        llr[9 + 2 * i, t // 2 + off:] = 0.0
    llr[1, t // 2 + 100:] = -0.0
    llr[INF_LANE, t // 3, 0] = np.inf
    llr[INF_LANE, 3 * t // 4:] = 0.0
    return llr


def last_live(torch, x):
    """(B,) the last step of each frame whose soft pair is not an
    erasure (-1 for none)."""
    live = (x != 0).any(dim=2)
    back = live.flip(1).to(torch.int8).argmax(dim=1)
    return torch.where(live.any(dim=1), x.shape[1] - 1 - back,
                       torch.full_like(back, -1))


def check_stops(torch, stops, x, what: str) -> dict:
    """The ACS kernel's stop steps: multiples of 64, past each frame's
    last live step, at most Tp. Returns their max and mean."""
    tp = x.shape[1]
    s = stops.long()
    check(bool(((s % 64 == 0) & (s <= tp) & (s > last_live(torch, x))).all()),
          f"{what}: stop steps out of their range")
    return {"max": int(s.max()), "mean": float(s.double().mean())}


def fused_edge_lanes(data, gain, nbits, ndbps, edge, tp):
    """Write the fused stop edge lanes (FUSED_*) into lanes 0 to
    FUSED_LANES - 1 of numpy symbols (B, n_sym, 48, 2), gains (B, 48)
    and bit counts (B,), around the renorm boundary `edge` of a trellis
    of `tp` steps, lane i at ndbps[i] bits a symbol. need_stop() holds
    on the FUSED_EXACT lanes if their gains are live; FUSED_QUIET's
    metrics stay +0 only at BPSK."""
    nbits[:FUSED_EDGE] = edge + np.arange(FUSED_EDGE) - 8
    nbits[FUSED_ZERO] = 0
    nbits[FUSED_FULL], nbits[FUSED_LONG] = tp, tp + 50
    nbits[FUSED_INF] = nbits[FUSED_QUIET] = edge + 40
    data[FUSED_INF, 1, 10, 0] = np.inf    # an I component: every rate's
    nbits[FUSED_NAN] = 3 * ndbps[FUSED_NAN]
    data[FUSED_NAN, 3:] = np.nan
    data[FUSED_QUIET, :4] = 0.0


def fused_parity_inputs(rng, ndbps, n_sym, cadence):
    """Random equalized symbols (len(ndbps), n_sym, 48, 2), gains (one
    nulled subcarrier) and bit counts, with the stop edge lanes around
    the renorm boundary in the middle of the trellis."""
    b = len(ndbps)
    data = rng.normal(0, 0.7, (b, n_sym, 48, 2)).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, (b, 48)).astype(np.float32)
    gain[FUSED_LANES:, 7] = 0.0
    nbits = rng.integers(0, n_sym * np.asarray(ndbps) + 1).astype(np.int32)
    tp = n_sym * max(ndbps)
    fused_edge_lanes(data, gain, nbits, ndbps, tp // cadence // 2 * cadence,
                     tp)
    return data, gain, nbits


def need_stop(nbits, cadence, tp):
    """The first renorm boundary at least 6 steps past each frame's bits
    (after 6 +0 pairs its 64 metrics are equal, and the renorm makes
    them +0), or Tp: where a fused kernel stops a frame whose soft
    values before its bits are finite and whose gains are live."""
    nb = np.asarray(nbits, np.int64)
    return np.minimum(-(-(nb + 6) // cadence) * cadence, tp)


def check_fused_stops(stops, nbits, cadence, tp, what, exact) -> dict:
    """A fused kernel's stop steps: multiples of the cadence, at most Tp,
    at or past each frame's bits (or Tp), and on the `exact` lanes the
    first boundary they could be. Returns their max and mean."""
    s = stops.cpu().numpy().astype(np.int64)
    nb = np.asarray(nbits, np.int64)
    check(bool(((s % cadence == 0) & (s <= tp)
                & ((s >= nb) | (s == tp))).all()),
          f"{what}: stop steps out of their range")
    check(bool((s[exact] == need_stop(nb[exact], cadence, tp)).all()),
          f"{what}: a frame did not stop at the first boundary it could")
    return {"max": int(s.max()), "mean": float(s.mean())}


def max_err(torch, got, want) -> float:
    """Largest absolute difference of two outputs (ACS pairs or bits)."""
    if isinstance(got, tuple):
        return max(max_err(torch, g, w) for g, w in zip(got, want))
    return float((got.double() - want.double()).abs().max())


def same_acs(torch, got, want, what: str) -> float:
    """ACS outputs (decisions, final metrics) against another run's:
    bitwise equal. Returns the largest absolute difference."""
    (dec, met), (dec_p, met_p) = got, want
    torch.cuda.synchronize()
    check(torch.equal(dec, dec_p), f"{what}: decisions differ")
    check(met.dtype == met_p.dtype
          and torch.equal(met.view(torch.int32), met_p.view(torch.int32)),
          f"{what}: final metrics are not bitwise equal")
    return max_err(torch, got, want)


def same_bits(torch, got, want, what: str) -> float:
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{what}: bits differ")
    return max_err(torch, got, want)


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over the float32 rate, the H100 SXM's
    published peaks of ``programs.DEVICE_PEAKS`` (float32 operations
    outside the tensor cores; integer adds counted at the same rate)."""
    from ziria_tpu_torch.utils.programs import DEVICE_PEAKS

    pk = DEVICE_PEAKS["h100"]
    tb_ = nbytes / (pk["hbm_gbps"] * 1e9) * 1e3
    to = nops / (pk["peak_tflops"] * 1e12) * 1e3
    return (tb_, "bytes") if tb_ >= to else (to, "operations")


def acs_ops(b, tp, cadence):
    """ACS operations: per state and step 4 adds, 1 compare, 1 select,
    plus the renorm's max and subtract every `cadence` steps (radix 4
    does the same decode; integer adds count as float32 ones)."""
    return b * tp * 64 * 6 + b * (tp // cadence) * 64 * 2


def acs_ops_to(stops, cadence):
    """ACS operations of the sweeps the kernel ran: each lane's steps up
    to its stop (as acs_ops)."""
    s = stops.long()
    return int(s.sum()) * 64 * 6 + int((s // cadence).sum()) * 64 * 2


def symbol_bytes_to(stops, nbits, ndbps):
    """Symbol bytes a fused decode needs: each frame's symbols up to its
    bit count or its stop, whichever comes first (every slot past the
    bits is a literal +0, whatever the symbols hold); frame i at
    ndbps[i] bits a symbol."""
    s = stops.cpu().numpy().astype(np.int64)
    used = np.minimum(s, np.asarray(nbits, np.int64))
    return int((-(-used // np.asarray(ndbps, np.int64))).sum()) * SYMBOL_BYTES


def held_to_plain(torch, what, fn, plain, compare, nbytes, nops, shape,
                  reps=5) -> dict:
    """A kernel wrapper `fn` against its plain version `plain` on the
    same inputs (`compare` fails the run on a difference); the plain
    version runs once under CUDA events, the kernel `reps` times.
    Returns the error, both times and the bound of `nbytes` and
    `nops`."""
    got = fn()
    want, plain_ms = cuda_timed(plain)
    err = compare(torch, got, want, what)
    del got, want
    b_ms, b_by = bound(nbytes, nops)
    return dict(max_abs_err=err, ms=cuda_ms(fn, reps=reps),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=shape)


def traceback_work(b, tp):
    """Traceback (bytes, operations): decision words and metrics in,
    bits out; 4 integer operations per step plus the 63-compare argmax,
    counted at the float32 rate."""
    return b * tp * 8 + b * 64 * 4 + b * tp, b * (tp * 4 + 63)


def mixed_fused_work(b, n_sym, tp):
    """The rate-switched fused kernel's (bytes, operations): symbols,
    gains, bit counts and rate rows in (ridx and the 8-rate bank of
    (2 * 216) 16-byte slot rows, n_dbps and norms), decisions and
    metrics out; the ACS plus the front's per-slot work. Also returns
    the bytes other than the symbols."""
    from ziria_tpu_torch.ops import viterbi_fused as vf
    from ziria_tpu_torch.phy.wifi.params import MAX_DBPS

    rest = (b * 48 * 4 + b * 4 * 2 + 8 * 2 * MAX_DBPS * 16 + 8 * 4 * 2
            + b * tp * 8 + b * 64 * 4)
    ops = acs_ops(b, tp, vf.MIXED_UNROLL) + b * tp * 2 * FRONT_OPS_PER_SLOT
    return b * n_sym * SYMBOL_BYTES + rest, ops, rest


def acs_bytes(b, tp, in_bytes):
    """ACS bytes: soft pairs in (`in_bytes` per value), one 8-byte
    decision word per step and 64 4-byte metrics out."""
    return b * tp * 2 * in_bytes + b * tp * 8 + b * 64 * 4


def longest_psdu(rate, n_sym: int) -> int:
    """The longest PSDU (bytes, FCS included) that fits n_sym DATA
    symbols at `rate`."""
    from ziria_tpu_torch.phy.wifi.params import n_symbols

    n = 1
    while n_symbols(n + 1, rate) <= n_sym:
        n += 1
    return n


def make_stream(rng, device, rates, lengths, gap_after, cfo, tail):
    """One continuous stream: a frame of the port's TX per (rate,
    length), each a random body + FCS, STREAM_DELAY idle samples first,
    gap_after(i, frame samples) samples after frame i, `tail` idle
    samples last, one CFO and complex AWGN at STREAM_SNR_DB
    referenced to the frames' mean power. Returns ((n, 2) float32,
    true starts, [(rate, length, psdu bits)])."""
    import torch

    from ziria_tpu_torch.ops.crc import append_crc32
    from ziria_tpu_torch.phy.wifi import tx
    from ziria_tpu_torch.utils.bits import bytes_to_bits

    frames, truth, starts = [], [], []
    pos = STREAM_DELAY
    for i, (m, n) in enumerate(zip(rates, lengths)):
        body = rng.integers(0, 256, n - 4).astype(np.uint8)
        f = tx.encode_frame(body, m, add_fcs=True, device=device).cpu().numpy()
        bits = append_crc32(bytes_to_bits(torch.from_numpy(body))).numpy()
        frames.append(f)
        truth.append((m, n, bits))
        starts.append(pos)
        pos += f.shape[0] + gap_after(i, f.shape[0])
    z = np.zeros(pos + tail, np.complex128)
    for st, f in zip(starts, frames):
        z[st:st + f.shape[0]] = f[:, 0] + 1j * f[:, 1]
    n_sig = sum(f.shape[0] for f in frames)
    p_sig = float(np.sum(np.abs(z) ** 2)) / n_sig
    z *= np.exp(1j * cfo * np.arange(z.size))
    sigma = np.sqrt(p_sig * 10 ** (-STREAM_SNR_DB / 10) / 2)
    z += sigma * (rng.normal(size=z.size) + 1j * rng.normal(size=z.size))
    return (np.stack([z.real, z.imag], -1).astype(np.float32),
            np.asarray(starts), truth)


def push_slabs(sr, stream, lo: int, hi: int):
    """Push stream[lo:hi] into a StreamReceiver in STREAM_SLAB slabs."""
    out = []
    for a in range(lo, hi, STREAM_SLAB):
        out += sr.push(stream[a:min(a + STREAM_SLAB, hi)])
    return out


class StepTimer:
    """CUDA events (or, with `host`, the host clock) around every call
    of the module functions named: their mean milliseconds a call."""

    def __init__(self, module, names, host: bool = False):
        self.module, self.names, self.events = module, names, {}
        self.host = host

    def __enter__(self):
        import torch

        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            calls = self.events.setdefault(n, [])

            def timed(*a, fn=fn, calls=calls, **k):
                if self.host:
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    calls.append((time.perf_counter() - t0) * 1e3)
                    return out
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                calls.append((e0, e1))
                return out
            setattr(self.module, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)

    def mean_ms(self):
        import torch

        torch.cuda.synchronize()
        return {n: (float(np.mean([c if self.host else c[0].elapsed_time(
                    c[1]) for c in cs])) if cs else None)
                for n, cs in self.events.items()}


class KernelTap:
    """While active, records the arguments of the first `n` calls of each
    kernel wrapper named (module, function name): ``args`` the first
    call's, :meth:`shard` the i-th's (one a shard of a sharded
    dispatch); the wrapper runs as before and counts its own launch. The
    tensors are kept, not copied: the decode makes each wrapper's inputs
    afresh and never writes them after the call."""

    def __init__(self, wrappers, n: int = 1):
        self.wrappers, self.n, self.calls = wrappers, n, {}

    @property
    def args(self):
        return {name: c[0] for name, c in self.calls.items()}

    def shard(self, i: int):
        view = KernelTap([])
        view.calls = {name: c[i:] for name, c in self.calls.items()}
        return view

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.wrappers]
        for m, n, fn in self.saved:
            def tapped(*a, fn=fn, n=n, **k):
                got = self.calls.setdefault(n, [])
                if len(got) < self.n:
                    got.append(([list(v) if isinstance(v, list) else v
                                 for v in a], dict(k)))
                return fn(*a, **k)
            setattr(m, n, tapped)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def stream_kernel_checks(torch, name, tap, fused):
    """Each kernel of a stream run at the inputs of its first decode
    dispatch, against its plain version, bitwise, with its stop steps
    checked as in the kernel_parity phase: the ACS (fused: rate-switched
    fused) kernel and the traceback. Returns {launch key: the kernel's
    error, times, bound, shape and stop steps}."""
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.phy.wifi.params import RATE_MBPS_ORDER

    out = {}
    (dec, met), _k = tap.args["traceback"]
    if fused:
        (data, gain, ridx, nbits, radix), _k = tap.args["fused_acs_mixed"]
        check(radix == 2, f"{name}: fused radix {radix}")
        b, n_sym, tp = int(data.shape[0]), int(data.shape[1]), int(dec.shape[1])
        nbytes, nops, _rest = mixed_fused_work(b, n_sym, tp)
        what = f"fused_mixed at {name}'s inputs"
        out["fused_mixed"] = held_to_plain(
            torch, what, lambda: vf.fused_acs_mixed(data, gain, ridx, nbits),
            lambda: vf.fused_acs_mixed_plain(data, gain, ridx, nbits),
            same_acs, nbytes, nops, [b, n_sym, tp])
        *_got, stops = vf.fused_acs_mixed_with_stops(data, gain, ridx, nbits)
        out["fused_mixed"]["stop_step"] = check_fused_stops(
            stops, nbits, vf.MIXED_UNROLL, tp, what, list(range(b)))
        out["fused_mixed"]["nbits"] = [int(v) for v in nbits]
        out["fused_mixed"]["rates_mbps"] = [RATE_MBPS_ORDER[int(r)]
                                            for r in ridx]
    else:
        (x, md, radix), _k = tap.args["acs"]
        check((md, radix) == ("float32", 2),
              f"{name}: ACS mode {md}, radix {radix}")
        b, tp = int(x.shape[0]), int(x.shape[1])
        what = f"acs at {name}'s inputs"
        out["acs"] = held_to_plain(
            torch, what, lambda: vc.acs(x, md, radix),
            lambda: vc.acs_plain(x, metric_dtype=md, radix=radix),
            same_acs, acs_bytes(b, tp, 4), acs_ops(b, tp, vc.RENORM),
            [b, tp])
        _dec, _met, stops = vc.acs_with_stops(x, md, radix)
        out["acs"]["stop_step"] = check_stops(torch, stops, x, what)
    b, tp = int(dec.shape[0]), int(dec.shape[1])
    out["traceback"] = held_to_plain(
        torch, f"traceback at {name}'s inputs",
        lambda: vc.traceback(dec, met), lambda: vc.traceback_plain(dec, met),
        same_bits, *traceback_work(b, tp), [b, tp])
    return out


def stream_phase(rng, dev, caps, sent, rates, card):
    """The streaming receiver on the card (the docstring's phase 5):
    stream_default, stream_wide in the default and fused modes, the
    checkpoint resume, the per-capture identity, receive_many_device.
    Returns (the phase's JSON object, each stream's launches)."""
    import torch

    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.phy.wifi import rx
    from ziria_tpu_torch.phy.wifi.params import RATE_MBPS_ORDER, RATES
    from ziria_tpu_torch.utils import dispatch, telemetry

    order = [RATE_MBPS_ORDER[i % 8] for i in range(STREAM_DEFAULT_FRAMES)]
    default_bytes = {m: longest_psdu(RATES[m], STREAM_DEFAULT_SYMBOLS)
                     for m in RATE_MBPS_ORDER}
    wide_rates = [RATE_MBPS_ORDER[i % 8] for i in range(STREAM_WIDE_FRAMES)]
    wl = STREAM_WIDE["frame_len"]
    streams = {
        "stream_default": (make_stream(
            rng, dev, order, [default_bytes[m] for m in order],
            lambda i, n: int(rng.integers(300, 600)), STREAM_CFO,
            2048), {}),
        "stream_wide": (make_stream(
            rng, dev, wide_rates, [PSDU_BYTES] * STREAM_WIDE_FRAMES,
            lambda i, n: wl - n + int(rng.integers(300, 600)),
            -STREAM_CFO, wl), STREAM_WIDE)}
    runs = {"stream_default": ("stream_default", {}),
            "stream_wide": ("stream_wide", {}),
            "stream_wide_fused": ("stream_wide", {"fused_demap": True})}
    out, launches_of, frames_of, checks_of = {}, {}, {}, {}
    for name, (src, knobs) in runs.items():
        (stream, starts, truth), geo = streams[src]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vc.reset_launches()
        vf.reset_launches()
        fused = bool(knobs.get("fused_demap"))
        tap = KernelTap([(vc, "traceback"),
                         (vf, "fused_acs_mixed") if fused else (vc, "acs")])
        with dispatch.count_dispatches() as d, telemetry.collect() as reg, \
                StepTimer(rx, ("stream_chunk_graph",
                               "stream_decode_graph")) as steps, tap:
            t0 = time.perf_counter()
            sr = framebatch.StreamReceiver(check_fcs=True, device=dev,
                                           **geo, **knobs)
            frames = push_slabs(sr, stream, 0, stream.shape[0]) + sr.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {**vc.LAUNCHES, **vf.LAUNCHES}
        st = sr.stats
        decodes = d.counts.get("rx.stream_decode", 0)
        wrong = [i for i, (f, (m, n, bits)) in enumerate(zip(frames, truth))
                 if not (f.result.ok and f.result.rate_mbps == m
                         and f.result.length_bytes == n
                         and f.result.crc_ok is True
                         and np.array_equal(f.result.psdu_bits, bits))]
        contained = {k: v for k, v in reg.counters().items()
                     if k.startswith("resilience.")}
        step_ms = steps.mean_ms()
        out[name] = {
            "geometry": {"chunk_len": sr.chunk_len, "frame_len": sr.frame_len,
                         "k": sr.k, "n_sym_bucket": sr.n_sym_bucket},
            "knobs": knobs, "samples": int(stream.shape[0]),
            "frames_sent": len(truth), "frames_emitted": len(frames),
            "wrong": wrong, "ms": ms,
            "samples_per_s": stream.shape[0] / ms * 1e3,
            "frames_per_s": len(frames) / ms * 1e3,
            "chunks": st.chunks, "decode_dispatches": decodes,
            "scan_ms_per_chunk": step_ms["stream_chunk_graph"],
            "decode_ms_per_dispatch": step_ms["stream_decode_graph"],
            "max_in_flight": st.max_in_flight,
            "overflow_chunks": st.overflow_chunks,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": launches, "stats": st._asdict(),
            "containment_counters": contained, "card": card}
        check([f.start for f in frames] == [int(s) for s in starts],
              f"{name}: emitted starts differ from the true starts")
        check(not wrong, f"{name}: frames decoded wrongly: {wrong}")
        check(st.overflow_chunks == 0, f"{name}: overflow chunks")
        check(not st.degraded and st.lane_blowups == 0
              and st.quarantines == 0 and st.sanitized == 0,
              f"{name}: containment ran: {st}")
        check(not any(contained.values()),
              f"{name}: containment counters moved: {contained}")
        acs_key = "fused_mixed" if fused else "acs"
        want = {k: 0 for k in launches}
        want.update({acs_key: decodes, "traceback": decodes})
        check(decodes > 0 and launches == want,
              f"{name}: launches {launches}, want {want}")
        launches_of[name] = launches
        frames_of[name] = frames
        # after the counts are read: these launches compare, and count
        # nowhere
        checks_of[name] = out[name]["kernels"] = stream_kernel_checks(
            torch, name, tap, fused)
        del tap

    # each rate's first frames of the fused wide run, held field for
    # field to per-capture rx.receive over the same window
    (stream, _starts, _truth), _geo = streams["stream_wide"]
    picked = {}
    for f in frames_of["stream_wide_fused"]:
        sel = picked.setdefault(f.result.rate_mbps, [])
        if len(sel) < STREAM_IDENTITY_PER_RATE:
            sel.append(f)
    ident = [f for sel in picked.values() for f in sel]
    check(len(ident) == 8 * STREAM_IDENTITY_PER_RATE,
          "identity: too few frames per rate")
    for f in ident:
        ref = rx.receive(stream[f.start:f.start + wl], check_fcs=True,
                         fused_demap=True, device=dev)
        check(same_result(f.result, ref),
              f"identity: the frame at {f.start} differs from rx.receive")

    # the default wide stream again, checkpointed half way through its
    # slabs and resumed in a new receiver
    half = stream.shape[0] // STREAM_SLAB // 2 * STREAM_SLAB
    sr = framebatch.StreamReceiver(check_fcs=True, device=dev, **STREAM_WIDE)
    resumed = push_slabs(sr, stream, 0, half)
    blob, drained = sr.checkpoint()
    sr = framebatch.StreamReceiver(check_fcs=True, device=dev,
                                   checkpoint=blob, **STREAM_WIDE)
    resumed += drained + push_slabs(sr, stream, half, stream.shape[0]) \
        + sr.flush()
    want = frames_of["stream_wide"]
    check([f.start for f in resumed] == [f.start for f in want]
          and all(same_result(a.result, b.result)
                  for a, b in zip(resumed, want)),
          "checkpoint: the resumed stream differs from the uninterrupted one")

    # receive_many_device on the end-to-end batch, padded to its bucket
    # and uploaded once, against receive_many on the same captures
    bucket = 1 << (max(c.shape[0] for c in caps) - 1).bit_length()
    x = np.zeros((len(caps), bucket, 2), np.float32)
    for i, c in enumerate(caps):
        x[i, :c.shape[0]] = c
    x_dev = torch.from_numpy(x).to(dev)
    vc.reset_launches()
    vf.reset_launches()
    got = framebatch.receive_many_device(x_dev, len(caps), check_fcs=True,
                                         device=dev)
    dev_launches = {**vc.LAUNCHES, **vf.LAUNCHES}
    want = framebatch.receive_many(list(x), check_fcs=True, device=dev)
    check(all(same_result(a, b) for a, b in zip(got, want))
          and len(got) == len(want) == len(caps),
          "receive_many_device differs from receive_many")
    check(all(r.ok and r.rate_mbps == m and r.crc_ok is True
              and np.array_equal(r.psdu_bits, b)
              for r, m, b in zip(got, rates, sent)),
          "receive_many_device: lanes decoded wrongly")
    check(dev_launches == {k: int(k in ("acs", "traceback"))
                           for k in dev_launches},
          f"receive_many_device: launches {dev_launches}")
    return ({"phase": "stream", "card": card, "streams": out,
             "identity_frames": len(ident), "identity": "equal",
             "checkpoint_resume": {"split_at_sample": half,
                                   "frames": len(resumed),
                                   "equal": True},
             "receive_many_device": {"lanes": len(caps), "bucket": bucket,
                                     "equal_to_receive_many": True,
                                     "launches": dev_launches}},
            launches_of, checks_of)


def same_result(a, b) -> bool:
    """Two RxResults equal field for field."""
    return ((a.ok, a.rate_mbps, a.length_bytes, a.crc_ok)
            == (b.ok, b.rate_mbps, b.length_bytes, b.crc_ok)
            and np.array_equal(a.psdu_bits, b.psdu_bits))


def push_fleet(msr, streams, lo: int, hi: int):
    """push_many each stream's [a, a + STREAM_SLAB) for a in [lo, hi)."""
    out = []
    for a in range(lo, hi, STREAM_SLAB):
        out += msr.push_many([x[a:min(a + STREAM_SLAB, hi)]
                              for x in streams])
    return out


def by_stream(pairs, n):
    out = [[] for _ in range(n)]
    for i, f in pairs:
        out[i].append(f)
    return out


def right(frames, starts, truth) -> bool:
    """Every true frame emitted once, at its true start, right."""
    return ([f.start for f in frames] == [int(s) for s in starts]
            and all(f.result.ok and f.result.rate_mbps == m
                    and f.result.length_bytes == n and f.result.crc_ok is True
                    and np.array_equal(f.result.psdu_bits, bits)
                    for f, (m, n, bits) in zip(frames, truth)))


def lone_frames(framebatch, dev, stream, **geo):
    """A lone StreamReceiver on `stream`, pushed in STREAM_SLAB slabs."""
    sr = framebatch.StreamReceiver(check_fcs=True, device=dev, **geo)
    return push_slabs(sr, stream, 0, stream.shape[0]) + sr.flush()


def same_frames(a, b) -> bool:
    return ([f.start for f in a] == [f.start for f in b]
            and all(same_result(x.result, y.result) for x, y in zip(a, b)))


def fleet_streams(rng, dev, wide: bool):
    """The fleet's 8 streams, each (samples, true starts, truth), every
    stream starting at a different rate, one CFO each. Wide: 16 frames
    of 1000-byte PSDUs a stream, one to a 32,768-sample window. Default:
    6 streams of 32 frames of 20 symbols, an all-noise stream, and a
    one-frame stream shorter than a chunk."""
    from ziria_tpu_torch.phy.wifi.params import RATE_MBPS_ORDER, RATES

    out = []
    if wide:
        wl = STREAM_WIDE["frame_len"]
        for i in range(8):
            rates = [RATE_MBPS_ORDER[(i + j) % 8]
                     for j in range(FLEET_WIDE_FRAMES)]
            out.append(make_stream(
                rng, dev, rates, [PSDU_BYTES] * len(rates),
                lambda j, n: wl - n + int(rng.integers(300, 600)),
                STREAM_CFO * (i - 3.5) / 4, wl))
        return out
    nbytes = {m: longest_psdu(RATES[m], STREAM_DEFAULT_SYMBOLS)
              for m in RATE_MBPS_ORDER}
    for i in range(FLEET_DEFAULT_STREAMS):
        rates = [RATE_MBPS_ORDER[(i + j) % 8]
                 for j in range(FLEET_DEFAULT_FRAMES)]
        out.append(make_stream(rng, dev, rates, [nbytes[m] for m in rates],
                               lambda j, n: int(rng.integers(300, 600)),
                               STREAM_CFO * (i - 3.5) / 4, 2048))
    noise = rng.normal(scale=0.05, size=(len(out[0][0]), 2))
    out.append((noise.astype(np.float32), np.zeros(0, np.int64), []))
    short = make_stream(rng, dev, [54], [nbytes[54]],
                        lambda j, n: 300, -STREAM_CFO, 2048)
    check(short[0].shape[0] < 8192, "the short stream is a chunk long")
    out.append(short)
    return out


def batch_check(torch, rx, cplx, name, args):
    """Hold the decode's fronts to give each lane the same values,
    bitwise, in the fleet's (S*K)-lane batch as in its stream's own
    K-lane batch, from the fleet decode's first inputs (`args`: segs,
    rows, ridx, nbits, npsdu, n_sym_bucket): the fleet equals S lone
    receivers only if no lane's soft values depend on the batch."""
    segs, rows, ridx, nbits, _npsdu, nsb = args[:6]
    s, k = rows.shape
    lane = torch.arange(s, device=segs.device).repeat_interleave(k)
    sel = segs[lane, torch.from_numpy(rows.reshape(-1)).to(segs.device)]
    out = {"lanes": s * k}
    with cplx.exact_fp32():
        fronts = {
            "mixed_front": lambda lo, hi: rx.mixed_front(
                sel[lo:hi], ridx.reshape(-1)[lo:hi],
                nbits.reshape(-1)[lo:hi], nsb),
            "front_symbols": lambda lo, hi: rx._front_symbols(
                sel[lo:hi], nsb)[0]}
        for front, fn in fronts.items():
            full = fn(0, s * k)
            each = torch.cat([fn(i * k, (i + 1) * k) for i in range(s)])
            diff = float((full - each).abs().max())
            check(torch.equal(full, each),
                  f"{name}: {front} of a lane differs between the "
                  f"{s * k}-lane batch and its stream's {k} (max {diff})")
            out[front] = {"bitwise_equal": True, "max_abs_diff": diff}
    return out


def fleet_phase(rng, dev, card):
    """The S-stream fleet on the card (the docstring's phase 6):
    fleet_default, fleet_wide in the default and fused modes, and a
    fleet checkpoint half way through fleet_wide. Returns (the phase's
    JSON object, each run's launches, each run's kernel checks, and the
    wide streams with each wide run's frames, for the mesh phase)."""
    import torch

    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import cplx, viterbi_cuda as vc, \
        viterbi_fused as vf
    from ziria_tpu_torch.phy.wifi import rx
    from ziria_tpu_torch.utils import dispatch, telemetry

    streams = {"fleet_default": (fleet_streams(rng, dev, False), {}),
               "fleet_wide": (fleet_streams(rng, dev, True), STREAM_WIDE)}
    runs = {"fleet_default": ("fleet_default", {}),
            "fleet_wide": ("fleet_wide", {}),
            "fleet_wide_fused": ("fleet_wide", {"fused_demap": True})}
    out, launches_of, checks_of, frames_of = {}, {}, {}, {}
    for name, (src, knobs) in runs.items():
        made, geo = streams[src]
        xs = [x for x, _s, _t in made]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vc.reset_launches()
        vf.reset_launches()
        fused = bool(knobs.get("fused_demap"))
        tap = KernelTap([(vc, "traceback"), (rx, "stream_decode_multi_graph"),
                         (vf, "fused_acs_mixed") if fused else (vc, "acs")])
        with dispatch.count_dispatches() as d, telemetry.collect() as reg, \
                StepTimer(rx, ("multi_stream_chunk_graph",
                               "stream_decode_multi_graph")) as steps, tap:
            t0 = time.perf_counter()
            msr = framebatch.MultiStreamReceiver(check_fcs=True, device=dev,
                                                 **geo, **knobs)
            got = push_fleet(msr, xs, 0, max(x.shape[0] for x in xs)) \
                + msr.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {**vc.LAUNCHES, **vf.LAUNCHES}
        st = msr.stats
        per = by_stream(got, msr.s)
        steps_n = d.counts.get("rx.stream_chunk_multi", 0)
        decodes = d.counts.get("rx.stream_decode_multi", 0)
        contained = {k: v for k, v in reg.counters().items()
                     if k.startswith("resilience.")}
        step_ms = steps.mean_ms()
        n_samples = sum(x.shape[0] for x in xs)
        out[name] = {
            "geometry": {"streams": msr.s, "chunk_len": msr.chunk_len,
                         "frame_len": msr.frame_len, "k": msr.k,
                         "n_sym_bucket": msr.n_sym_bucket},
            "knobs": knobs, "samples": n_samples,
            "stream_samples": [int(x.shape[0]) for x in xs],
            "frames_sent": sum(len(t) for _x, _s, t in made),
            "frames_emitted": len(got), "ms": ms,
            "samples_per_s": n_samples / ms * 1e3,
            "samples_per_s_per_stream": [x.shape[0] / ms * 1e3 for x in xs],
            "air_rate_share": n_samples / ms * 1e3 / (msr.s * 20e6),
            "frames_per_s": len(got) / ms * 1e3,
            "chunk_steps": st.chunk_steps, "decode_dispatches": decodes,
            "scan_ms_per_chunk_step": step_ms["multi_stream_chunk_graph"],
            "decode_ms_per_dispatch": step_ms["stream_decode_multi_graph"],
            "max_active_streams": st.max_active_streams,
            "max_in_flight": st.max_in_flight,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": launches, "stats": st._asdict(),
            "containment_counters": contained, "card": card}
        for i, (x, starts, truth) in enumerate(made):
            check(right(per[i], starts, truth),
                  f"{name}: stream {i} decoded wrongly")
        check(steps_n == st.chunk_steps and decodes <= steps_n
              and set(d.counts) <= {"rx.stream_chunk_multi",
                                    "rx.stream_decode_multi"},
              f"{name}: dispatches {dict(d.counts)}, {st.chunk_steps} steps")
        check(st.overflow_chunks == 0 and not st.degraded
              and st.lane_blowups == 0 and st.quarantines == 0
              and st.sanitized == 0, f"{name}: containment ran: {st}")
        check(not any(contained.values()),
              f"{name}: containment counters moved: {contained}")
        acs_key = "fused_mixed" if fused else "acs"
        want = {k: 0 for k in launches}
        want.update({acs_key: decodes, "traceback": decodes})
        check(decodes > 0 and launches == want,
              f"{name}: launches {launches}, want {want}")
        launches_of[name] = launches
        frames_of[name] = per
        # after the counts are read: these launches compare and count
        # nowhere
        for i, x in enumerate(xs):
            check(same_frames(per[i], lone_frames(framebatch, dev, x, **geo,
                                                  **knobs)),
                  f"{name}: stream {i} differs from a lone StreamReceiver")
        out[name]["equal_to_lone_receivers"] = True
        checks_of[name] = out[name]["kernels"] = stream_kernel_checks(
            torch, name, tap, fused)
        out[name]["batch_independence"] = batch_check(
            torch, rx, cplx, name, tap.args["stream_decode_multi_graph"][0])
        del tap

    # the wide fleet again, checkpointed half way (every lane) and
    # restored into a fresh fleet
    made, geo = streams["fleet_wide"]
    xs = [x for x, _s, _t in made]
    longest = max(x.shape[0] for x in xs)
    half = longest // STREAM_SLAB // 2 * STREAM_SLAB
    msr = framebatch.MultiStreamReceiver(check_fcs=True, device=dev, **geo)
    got = push_fleet(msr, xs, 0, half)
    blobs, drained = msr.checkpoint_fleet()
    msr = framebatch.MultiStreamReceiver(check_fcs=True, device=dev, **geo)
    for i, blob in blobs.items():
        msr.restore_stream(i, blob)
    got += drained + push_fleet(msr, xs, half, longest) + msr.flush()
    resumed = by_stream(got, msr.s)
    check(all(same_frames(a, b)
              for a, b in zip(resumed, frames_of["fleet_wide"])),
          "fleet checkpoint: the resumed fleet differs from the "
          "uninterrupted one")
    return ({"phase": "fleet", "card": card, "runs": out,
             "checkpoint_resume": {"split_at_sample": half,
                                   "lanes": len(blobs),
                                   "frames": len(got), "equal": True}},
            launches_of, checks_of,
            {"streams": made, "frames": {n: frames_of[n] for n in
                                         ("fleet_wide", "fleet_wide_fused")}})


def serve_clients(rng, dev, serve):
    """SERVE_SESSIONS clients: SERVE_FRAMES frames of 20 symbols each
    (the 8 rates in turn from a different one per client), in ragged
    slabs of SERVE_SLAB samples, one slab a tick; client SERVE_NAN's
    middle slab NaN in every 7th sample. Returns (clients, truth)."""
    from ziria_tpu_torch.phy.wifi.params import RATE_MBPS_ORDER, RATES

    nbytes = {m: longest_psdu(RATES[m], STREAM_DEFAULT_SYMBOLS)
              for m in RATE_MBPS_ORDER}
    clients, truth = [], {}
    for c in range(SERVE_SESSIONS):
        rates = [RATE_MBPS_ORDER[(c + j) % 8] for j in range(SERVE_FRAMES)]
        x, starts, tr = make_stream(
            rng, dev, rates, [nbytes[m] for m in rates],
            lambda j, n: int(rng.integers(300, 600)),
            STREAM_CFO * ((c % 8) - 3.5) / 4, 2048)
        cuts = [0]
        while cuts[-1] < x.shape[0]:
            cuts.append(min(x.shape[0], cuts[-1]
                            + int(rng.integers(*SERVE_SLAB))))
        sched = [(t, x[a:b]) for t, (a, b) in enumerate(zip(cuts, cuts[1:]))]
        mode = "ok"
        if c == SERVE_NAN:
            t, bad = sched[len(sched) // 2]
            bad = np.array(bad, copy=True)
            bad[::7] = np.nan
            sched[len(sched) // 2] = (t, bad)
            mode = "nan"
        sid = f"s{c}"
        clients.append(serve.ClientSpec(sid, sched, x, None, mode))
        truth[sid] = (starts, tr)
    return clients, truth


def serve_phase(rng, dev, card):
    """The serving runtime on the card (the docstring's phase 7): a run
    with a NaN client and an evicted client, then a run dropped half
    way and recovered from its snapshots. Returns (the phase's JSON
    object, the first run's launches)."""
    import tempfile

    import torch

    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.runtime import serve
    from ziria_tpu_torch.utils import dispatch

    clients, truth = serve_clients(rng, dev, serve)
    nan_sid, evict_sid = f"s{SERVE_NAN}", f"s{SERVE_EVICT}"
    lone = {c.sid: lone_frames(framebatch, dev, c.stream) for c in clients}
    half = {c.sid: c.stream.shape[0] // 2 for c in clients}
    ticks, nan_takes = [], []

    class Evicting(serve.ServeRuntime):
        """Evicts one session once half its stream is in its lane, and
        reconnects it with its blob (to the queue, when sessions wait),
        its staged slabs resubmitted."""
        evicted = None

        def _push(self, push):
            # what reaches the NaN session's lane, slab for slab
            for lane, take in push.items():
                if self._lane_sid.get(lane) == nan_sid:
                    nan_takes.append(np.array(take, copy=True))
            return super()._push(push)

        def step(self):
            with dispatch.count_dispatches() as d:
                out = super().step()
            ticks.append((d.counts.get("rx.stream_chunk_multi", 0),
                          d.counts.get("rx.stream_decode_multi", 0)))
            s = self._sessions.get(evict_sid)
            if self.evicted is not None or s is None or s.lane is None:
                return out
            c = self._rx.carry(s.lane)
            if c.offset + c.tail.shape[0] >= half[evict_sid]:
                blob, ems, staged = self.evict(evict_sid)
                r = self.connect(evict_sid, checkpoint=blob)
                check(r.admitted or r.queued, f"serve: reconnect {r}")
                for slab in staged:
                    check(self.submit(evict_sid, slab).accepted,
                          "serve: resubmit after the eviction")
                self.evicted = len(ticks)
                out += ems
            return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vc.reset_launches()
    vf.reset_launches()
    cfg = serve.ServeConfig(check_fcs=True)
    with dispatch.count_dispatches() as d:
        t0 = time.perf_counter()
        with Evicting(cfg, device=dev) as srv:
            frames = serve.run_clients(srv, clients)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = {**vc.LAUNCHES, **vf.LAUNCHES}
    st = srv.stats()
    decodes = d.counts.get("rx.stream_decode_multi", 0)
    lat = srv.registry.find("serve.chunk_seconds")
    counters = srv.registry.counters()
    contained = {k: v for k, v in counters.items()
                 if k.startswith("resilience.")}
    n_samples = sum(c.stream.shape[0] for c in clients)
    n_frames = sum(len(v) for v in frames.values())
    # the NaN session: exactly a lone sanitizing receiver's frames on
    # the slabs its lane got, and only frames of its clean stream
    sr = framebatch.StreamReceiver(check_fcs=True, sanitize=True,
                                   device=dev)
    nan_lone = [f for t in nan_takes for f in sr.push(t)] + sr.flush()
    check(sr.stats.quarantines >= 1
          and same_frames(frames[nan_sid], nan_lone),
          "serve: the NaN session differs from a lone sanitizing "
          "StreamReceiver on its slabs")
    by = {f.start: f for f in lone[nan_sid]}
    check(all(f.start in by and same_frames([f], [by[f.start]])
              for f in frames[nan_sid]),
          "serve: the NaN session emitted a frame its clean stream "
          "does not have")
    for c in clients:
        starts, tr = truth[c.sid]
        if c.sid == nan_sid:
            continue
        check(right(frames[c.sid], starts, tr),
              f"serve: session {c.sid} decoded wrongly")
        check(same_frames(frames[c.sid], lone[c.sid]),
              f"serve: session {c.sid} differs from a lone StreamReceiver")
    check(srv.evicted is not None, "serve: the eviction never happened")
    check(st.admitted == st.closed + st.shed + st.evicted
          + st.active_sessions and st.evicted == st.restored == 1
          and st.closed == SERVE_SESSIONS and st.shed == 0
          and st.frames == n_frames, f"serve: stats do not balance: {st}")
    check(d.total <= 2 * st.chunk_steps
          and set(d.counts) <= {"rx.stream_chunk_multi",
                                "rx.stream_decode_multi"},
          f"serve: dispatches {dict(d.counts)}, {st.chunk_steps} steps")
    # a tick moves up to one chunk of staging into each lane, whose
    # carried tail is under a chunk: at most two chunk-steps a tick, and
    # at most one decode per chunk-step (the previous step's drain)
    check(all(dec <= cs <= 2 for cs, dec in ticks),
          f"serve: a tick's (chunk-steps, decodes) over the bound: "
          f"{[t for t in ticks if not t[1] <= t[0] <= 2]}")
    check(counters.get("resilience.quarantines") == 1
          and set(contained) <= {"resilience.quarantines",
                                 "resilience.sanitized"},
          f"serve: containment {contained}")
    check(launches == {k: {"acs": decodes, "traceback": decodes}.get(k, 0)
                       for k in launches} and decodes > 0,
          f"serve: launches {launches}")
    page = srv.scrape()
    check(lat is not None and lat.count == st.chunk_steps
          and "serve_chunk_seconds_bucket" in page,
          "serve: no serve.chunk_seconds in the scrape")
    chunk_ms = lat.summary(scale=1e3)

    # the same clients again, snapshotting every 4 chunk-steps, the
    # runtime dropped half way without a drain, then recovered
    class Crash(Exception):
        pass

    delivered = []

    class Crashing(serve.ServeRuntime):
        """Dropped (Crash) at the first step after half the frames were
        delivered; records what it delivered."""

        def step(self):
            out = super().step()
            delivered.extend(out)
            if len(delivered) >= n_frames // 2:
                raise Crash()
            return out

        def close(self, sid):
            out = super().close(sid)
            delivered.extend(out)
            return out

    with tempfile.TemporaryDirectory() as snap_dir:
        cfg2 = cfg._replace(snapshot_dir=snap_dir, snapshot_every=4)
        crashed = Crashing(cfg2, device=dev)
        with crashed:
            try:
                serve.run_clients(crashed, clients)
            except Crash:
                pass
            crashed._drained = True          # dropped: no drain
        snaps = crashed.stats().snapshots
        rec = serve.ServeRuntime.recover(snap_dir, device=dev)
        left = [c for c in clients if c.sid not in rec._gone]
        with rec:
            again = serve.run_clients(rec, left)
        rst = rec.stats()
    merged, dups = {c.sid: {} for c in clients}, 0
    for sid, f in delivered + [(s, f) for s, fs in again.items() for f in fs]:
        have = merged[sid].get(f.start)
        if have is not None:
            check(same_frames([f], [have]),
                  f"recover: {sid} re-delivered a different frame")
            dups += 1
        merged[sid][f.start] = f
    for c in clients:
        got = [merged[c.sid][k] for k in sorted(merged[c.sid])]
        if c.sid == nan_sid:
            by = {f.start: f for f in lone[c.sid]}
            check(all(f.start in by and same_frames([f], [by[f.start]])
                      for f in got), "recover: the NaN session")
            continue
        check(same_frames(got, frames[c.sid]),
              f"recover: session {c.sid} differs from the uncrashed run")
    check(snaps >= 1 and rst.restarts == 1,
          f"recover: snapshots {snaps}, restarts {rst.restarts}")
    return ({"phase": "serve", "card": card, "config": cfg._asdict(),
             "sessions": SERVE_SESSIONS, "frames_per_session": SERVE_FRAMES,
             "admitted": st.admitted, "queued": st.queued,
             "rejected_admissions": st.rejected_admissions,
             "rejected_slabs": st.rejected_slabs, "shed": st.shed,
             "evicted": st.evicted, "restored": st.restored,
             "closed": st.closed, "quarantined_session": nan_sid,
             "evicted_at_tick": srv.evicted, "frames": n_frames,
             "chunk_steps": st.chunk_steps, "decode_dispatches": decodes,
             "max_chunk_steps_per_tick": max(cs for cs, _d in ticks),
             "max_dispatches_per_tick": max(cs + dec for cs, dec in ticks),
             "nan_session_frames": len(frames[nan_sid]), "ms": ms,
             "frames_per_s": n_frames / ms * 1e3,
             "samples_per_s": n_samples / ms * 1e3,
             "chunk_step_ms": chunk_ms,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
             "launches": launches, "containment_counters": contained,
             "equal_to_lone_receivers": True,
             "recovery": {"snapshots": snaps,
                          "delivered_before": len(delivered),
                          "duplicates": dups,
                          "recovered_sessions": len(rec.recovered),
                          "replayed": len(rec.replayed),
                          "deduped": rst.deduped,
                          "equal_to_uncrashed": True}},
            launches)


class _SlicedTap:
    """The first `n` lanes of a KernelTap's recorded kernel inputs, in
    the shape ``stream_kernel_checks`` reads."""

    def __init__(self, tap, n: int):
        def cut(v):
            return v[:n] if isinstance(v, list) or getattr(v, "ndim", 0) \
                else v
        self.args = {k: ([cut(v) for v in a], kw)
                     for k, (a, kw) in tap.args.items()}


def link_psdus(rng):
    """LINK_B PSDUs (LINK_B / 8 a rate, lane k at rate k % 8) and the
    per-lane channel: (psdus, rates, snr, cfo, delay)."""
    from ziria_tpu_torch.phy.wifi.params import RATE_MBPS_ORDER

    rates = [RATE_MBPS_ORDER[k % 8] for k in range(LINK_B)]
    psdus = [rng.integers(0, 256, LINK_BYTES).astype(np.uint8)
             for _ in rates]
    cfo = rng.uniform(-LINK_CFO, LINK_CFO, LINK_B)
    delay = rng.integers(0, LINK_DELAY, LINK_B)
    return psdus, rates, np.full(LINK_B, LINK_SNR_DB), cfo, delay


def link_right(results, psdus, rates) -> list:
    """Lanes of a loopback_many run that are not right: ok, rate,
    length (PSDU + FCS), FCS good and payload bits as sent."""
    import torch

    from ziria_tpu_torch.ops.crc import append_crc32
    from ziria_tpu_torch.utils.bits import bytes_to_bits

    bad = []
    for i, (r, p, m) in enumerate(zip(results, psdus, rates)):
        want = append_crc32(bytes_to_bits(torch.from_numpy(p))).numpy()
        if not (r.ok and r.rate_mbps == m and r.length_bytes == len(p) + 4
                and r.crc_ok is True and np.array_equal(r.psdu_bits, want)):
            bad.append(i)
    return bad


def link_phase(rng, dev, card):
    """The loopback link on the card: loopback_many fused (default and
    fused_demap) and staged over LINK_B full-width frames, each with
    the launch counts zeroed just before it and read just after; then
    the kernels at the link's first decode inputs against their plain
    versions, impair_many's rows against impair_one, the per-frame
    oracle, an urban batch, and the timing. Returns (the phase's JSON
    object, each run's launches, the kernel checks)."""
    import torch

    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.phy import channel, link
    from ziria_tpu_torch.phy.wifi import rx, tx
    from ziria_tpu_torch.utils import telemetry, threefry

    psdus, rates, snr, cfo, delay = link_psdus(rng)
    kw = dict(snr_db=snr, cfo=cfo, delay=delay, seed=LINK_SEED,
              add_fcs=True, check_fcs=True, device=dev)
    runs = {"link_fused": ({}, {"acs": 1, "traceback": 1}),
            "link_fused_demap": ({"fused_demap": True},
                                 {"fused_mixed": 1, "traceback": 1}),
            "link_staged": ({"fused": False}, {"acs": 1, "traceback": 1})}
    out, launches_of, results, taps = {}, {}, {}, {}
    for name, (knobs, want) in runs.items():
        fused_demap = bool(knobs.get("fused_demap"))
        tap = KernelTap([(vc, "traceback"),
                         (vf, "fused_acs_mixed") if fused_demap
                         else (vc, "acs")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vc.reset_launches()
        vf.reset_launches()
        with telemetry.collect() as reg, tap:
            res, ms = host_ms(lambda: link.loopback_many(psdus, rates, **kw,
                                                         **knobs))
        launches = {**vc.LAUNCHES, **vf.LAUNCHES}
        degraded = {k: v for k, v in reg.counters().items()
                    if "degraded" in k or k.startswith("resilience.")}
        results[name], launches_of[name], taps[name] = res, launches, tap
        bad = link_right(res, psdus, rates)
        out[name] = {"knobs": {k: v for k, v in knobs.items()},
                     "first_call_ms": ms, "launches": launches,
                     "correct": LINK_B - len(bad), "failed": bad,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                     "containment_counters": degraded}
        check(launches == {k: want.get(k, 0) for k in launches},
              f"{name}: launches {launches}, want {want}")
        check(not bad, f"{name}: lanes decoded wrongly: {bad}")
        check(not degraded, f"{name}: degraded or contained: {degraded}")
    for name in ("link_fused_demap", "link_staged"):
        check(all(same_result(a, b) for a, b in
                  zip(results[name], results["link_fused"])),
              f"{name} differs field for field from link_fused")

    # after the counts are read: these launches compare and count nowhere
    checks = {}
    for name, fused in (("link_fused", False), ("link_fused_demap", True)):
        checks[name] = stream_kernel_checks(
            torch, name, _SlicedTap(taps[name], LINK_CHECK_LANES), fused)
    del taps

    # impair_many row i against impair_one at lane i, on the card
    txb = tx.encode_many(psdus, rates, add_fcs=True, device=dev)
    _sb, l_cap = link._link_buckets(psdus, rates, True, int(delay.max()))
    caps = channel.impair_many(txb.samples[:LINK_B], txb.n_valid, snr, cfo,
                               delay, LINK_SEED, out_len=l_cap)
    for i in LINK_IDENTITY_LANES:
        one = channel.impair_one(txb.samples[i, :txb.n_valid[i]], snr[i],
                                 cfo[i], delay[i], LINK_SEED, i, l_cap,
                                 device=dev)
        check(torch.equal(one, caps[i]),
              f"impair_many row {i} differs from impair_one")
    del caps, txb
    # the per-frame oracle (rx.receive with the known-rate fused kernel)
    # on the first LINK_ORACLE lanes: the same capture bucket and lane
    # keys as the batch
    oracle = link.loopback_many(psdus[:LINK_ORACLE], rates[:LINK_ORACLE],
                                **dict(kw, snr_db=snr[:LINK_ORACLE],
                                       cfo=cfo[:LINK_ORACLE],
                                       delay=delay[:LINK_ORACLE]),
                                batched_tx=False, fused_demap=True)
    check(all(same_result(a, b) for a, b in
              zip(oracle, results["link_fused_demap"][:LINK_ORACLE])),
          "the per-frame oracle differs from the fused_demap batch")
    # one urban batch: fused equal to staged
    urban = {f: link.loopback_many(psdus, rates, **kw, fused=f,
                                   channel_profile="urban")
             for f in (True, False)}
    check(all(same_result(a, b) for a, b in zip(urban[True], urban[False])),
          "urban: fused differs from staged")

    # timing: the fused batch on the host clock, 3 reps, then each stage
    # under CUDA events (one more run)
    reps = 3
    batch_ms = sum(host_ms(lambda: link.loopback_many(psdus, rates, **kw))[1]
                   for _ in range(reps)) / reps
    with StepTimer(tx, ("encode_prep",)) as s_tx, \
            StepTimer(channel, ("impair_many_graph",)) as s_ch, \
            StepTimer(threefry, ("normal",)) as s_tf, \
            StepTimer(rx, ("acquire_frame_graph", "gather_segment_graph",
                           "mixed_front", "crc_psdu_many_graph")) as s_rx, \
            StepTimer(vc, ("acs", "traceback")) as s_k:
        link.loopback_many(psdus, rates, **kw)
    step = {**s_tx.mean_ms(), **s_ch.mean_ms(), **s_tf.mean_ms(),
            **s_rx.mean_ms(), **s_k.mean_ms()}
    # the host's share, on the host clock (one more run): the batch
    # geometry (its TX host prep within), the device pass's launches,
    # the wait for the classification read, the per-lane results
    torch.cuda.synchronize()
    with StepTimer(link, ("_LinkGeometry", "_fused_pass", "_fused_results",
                          "_loopback_fused"), host=True) as h_link, \
            StepTimer(tx, ("batch_host_prep",), host=True) as h_tx:
        (_r, total_ms) = host_ms(lambda: link.loopback_many(psdus, rates,
                                                            **kw))
    host = {**h_link.mean_ms(), **h_tx.mean_ms(), "loopback_many": total_ms}
    host["head_read_wait"] = (host["_loopback_fused"] - host["_fused_pass"]
                              - host["_fused_results"])
    host["outside_geometry_and_pass"] = (
        total_ms - host["_LinkGeometry"] - host["_loopback_fused"])
    samples = LINK_B * l_cap
    return ({"phase": "link", "card": card, "frames": LINK_B,
             "psdu_bytes": LINK_BYTES, "fcs": True, "snr_db": LINK_SNR_DB,
             "cfo_max": LINK_CFO, "delay_max": LINK_DELAY,
             "capture_bucket": l_cap, "runs": out,
             "fused_equals_staged": True, "fused_demap_equals_fused": True,
             "impair_many_rows_equal_impair_one": list(LINK_IDENTITY_LANES),
             "perframe_oracle_lanes": LINK_ORACLE,
             "urban_fused_equals_staged": True,
             "urban_correct": LINK_B - len(link_right(urban[True], psdus,
                                                      rates)),
             "kernels": checks, "batch_ms": batch_ms, "reps": reps,
             "frames_per_s": LINK_B / batch_ms * 1e3,
             "capture_samples_per_s": samples / batch_ms * 1e3,
             "step_ms": step, "host_ms": host},
            launches_of, checks)


def sweep_phase(rng, dev, card):
    """The BER sweep on the card: sweep_ber over SWEEP_B full-width
    PSDUs, SWEEP_RATES x SWEEP_SNRS x SWEEP_SEEDS, launch counts zeroed
    just before and read just after; held to a loop of
    loopback_ber_bits at SWEEP_LOOP_POINTS. Returns (the phase's JSON
    object, its launches, and its PSDUs and counts for the mesh
    phase)."""
    import torch

    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.phy import link
    from ziria_tpu_torch.utils import telemetry

    psdus = rng.integers(0, 256, (SWEEP_B, SWEEP_BYTES)).astype(np.uint8)
    torch.cuda.synchronize()
    vc.reset_launches()
    vf.reset_launches()
    with telemetry.collect() as reg:
        errs, ms = host_ms(lambda: link.sweep_ber(
            psdus, SWEEP_RATES, SWEEP_SNRS, SWEEP_SEEDS, device=dev))
    launches = {**vc.LAUNCHES, **vf.LAUNCHES}
    degraded = {k: v for k, v in reg.counters().items()
                if "degraded" in k or k.startswith("resilience.")}
    n_decodes = len(SWEEP_RATES) * len(SWEEP_SNRS) * len(SWEEP_SEEDS)
    want = {k: 0 for k in launches}
    want.update(acs=n_decodes, traceback=n_decodes)
    check(launches == want, f"sweep: launches {launches}, want {want}")
    check(not degraded, f"sweep: degraded or contained: {degraded}")
    check(errs.shape == (len(SWEEP_RATES), len(SWEEP_SNRS),
                         len(SWEEP_SEEDS)), f"sweep: shape {errs.shape}")
    check(int(errs[SWEEP_RATES.index(6), -1].sum()) == 0,
          "sweep: errors at 6 Mbit/s at the top SNR")
    bits = np.unpackbits(psdus, axis=1, bitorder="little")
    for snr, seed in SWEEP_LOOP_POINTS:
        si, ki = SWEEP_SNRS.index(snr), SWEEP_SEEDS.index(seed)
        for ri, m in enumerate(SWEEP_RATES):
            got = link.loopback_ber_bits(psdus, m, snr, seed, device=dev)
            check(int((got != bits).sum()) == int(errs[ri, si, ki]),
                  f"sweep: {m} Mbit/s at {snr} dB seed {seed} differs from "
                  f"loopback_ber_bits")
    n_bits = SWEEP_B * 8 * SWEEP_BYTES * len(SWEEP_SEEDS)
    ber = {str(m): {str(s): float(errs[ri, si].sum()) / n_bits
                    for si, s in enumerate(SWEEP_SNRS)}
           for ri, m in enumerate(SWEEP_RATES)}
    return ({"phase": "sweep", "card": card, "frames": SWEEP_B,
             "psdu_bytes": SWEEP_BYTES, "rates": list(SWEEP_RATES),
             "snr_db": list(SWEEP_SNRS), "seeds": list(SWEEP_SEEDS),
             "errors": errs.tolist(), "ber": ber, "ms": ms,
             "ms_per_point_rate": ms / n_decodes, "launches": launches,
             "equal_to_loop_at": [list(p) for p in SWEEP_LOOP_POINTS]},
            launches, (psdus, errs))


def fxp_primitive_checks(rng, dev):
    """Every ops/fxp primitive and ext_math function on the card against
    the same call on the CPU (the ext_math functions against their
    numpy path, the interpreter's): bitwise, at random values, the
    int16 rails and int32 edges, and for quantize_q at NaN, +-inf and
    +-1e9. Returns {function: elements compared}."""
    import torch

    from ziria_tpu_torch.ops import ext_math, fxp

    i32 = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64) \
        .astype(np.int32)
    i32[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
    big = rng.integers(-2 ** 28, 2 ** 28, (2, 4096)).astype(np.int32)
    big[:, :3] = [[0, 0, 5], [0, -3, 0]]
    flt = np.concatenate([rng.normal(0, 8, 4096),
                          [np.nan, np.inf, -np.inf, 1e9, -1e9, 15.9995,
                           -16.0005, 0.0]]).astype(np.float32)
    pairs = rng.integers(-2 ** 15, 2 ** 15, (256, 64, 2)).astype(np.int32)
    pairs[:2] = np.where(rng.integers(0, 2, (2, 64, 2)) > 0, 32767,
                         -32768)
    pairs[2], pairs[3] = -32768, 32767
    conj = rng.integers(-2 ** 15, 2 ** 15, (256, 64, 2)).astype(np.int32)
    rot = rng.integers(-2 ** 16, 2 ** 16, (4096, 2)).astype(np.int32)
    ang = rng.integers(-32768, 32768, 4096).astype(np.int32)
    i16 = rng.integers(-32768, 32768, (2, 4096)).astype(np.int16)
    i16[:, :2] = [[-32768, 32767], [0, -32768]]
    c64 = (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)
    (rh, rl), _im = fxp._TW64
    cases = {
        "rsra": (lambda x: torch.stack([fxp.rsra(x, s)
                                        for s in (0, 1, 7, 10)]), [i32]),
        "sat16": (fxp.sat16, [i32]),
        "quantize_q": (lambda x: torch.stack(
            [fxp.quantize_q(x, q) for q in (0, 11, 15)]), [flt]),
        "cordic_atan2": (lambda y, x: torch.stack(fxp.cordic_atan2(y, x)),
                         list(big)),
        "cordic_rotate": (lambda p, a: torch.stack(
            [fxp.cordic_rotate(p, a, k) for k in (15, 10)]), [rot, ang]),
        "_gemm_q14": (lambda x: fxp._gemm_q14(x, rh, rl), [pairs[..., 0]]),
        "dft64_q14": (lambda p: torch.stack(
            [fxp.dft64_q14(p, s) for s in (0, 7, 10)]), [pairs]),
        "idft64_wifi_q14": (fxp.idft64_wifi_q14, [pairs]),
        "cmul_conj_i32": (lambda a, b: fxp.cmul_conj_i32(a, b, 4),
                          [pairs, conj]),
        "cabs2_i32": (lambda p: fxp.cabs2_i32(p, 4), [pairs]),
        "isqrt_u32": (fxp.isqrt_u32, [np.abs(i32[4:]).astype(np.int32)]),
    }
    out = {}
    for name, (fn, arrs) in cases.items():
        got = fn(*[torch.from_numpy(a).to(dev) for a in arrs])
        want = fn(*[torch.from_numpy(a) for a in arrs])
        check(got.device.type == dev.type and got.dtype == want.dtype
              and torch.equal(got.cpu(), want),
              f"fxp {name}: the card differs from the CPU")
        out[name] = int(want.numel())
    ext = {"sin_int16": [i16[0]], "cos_int16": [i16[0]],
           "atan2_int16": list(i16), "usqrt": [i32], "ulog2": [i32],
           "dft64_fxp": [c64], "idft64_fxp": [c64]}
    for name, arrs in ext.items():
        fn = getattr(ext_math, name)
        got = fn(*[torch.from_numpy(a).to(dev) for a in arrs])
        want = fn(*arrs)
        check(got.device.type == dev.type
              and np.array_equal(got.cpu().numpy(), want)
              and got.cpu().numpy().dtype == want.dtype,
              f"ext_math {name}: the card differs from the numpy path")
        out[name] = int(want.size)
    return out


def fxp_frames(rng, dev):
    """FXP_B frames at the benchmark stage's geometry: (float32 frames
    on the card, PSDU bits (B, 8 * FXP_BYTES), rate, n_sym)."""
    import torch

    from ziria_tpu_torch.phy.wifi import tx
    from ziria_tpu_torch.phy.wifi.params import RATES, n_symbols

    rate = RATES[FXP_MBPS]
    n_sym = n_symbols(FXP_BYTES, rate)
    psdus = rng.integers(0, 256, (FXP_B, FXP_BYTES)).astype(np.uint8)
    psdus[0] = np.random.default_rng(0).integers(0, 256, FXP_BYTES)
    frames = tx.encode_batch(psdus, FXP_MBPS, device=dev).cpu().numpy()
    sigma = np.sqrt(10 ** (-FXP_SNR_DB / 10) / 2)
    frames[1:] += (sigma * rng.normal(size=frames[1:].shape)) \
        .astype(np.float32)
    check(frames.shape[1] == 400 + 80 * n_sym, "fxp frame length")
    bits = np.unpackbits(psdus, axis=1, bitorder="little")
    return torch.from_numpy(frames).to(dev), bits, rate, n_sym


def fxp_phase(rng, dev, card):
    """The fixed-point path on the card: the primitives bitwise against
    the CPU; decode_data_batch_fxp on FXP_B benchmark-geometry frames,
    exact and windowed, each run with the launch counts zeroed just
    before it and read just after (one ACS and one traceback launch),
    every PSDU right, the kernels held bitwise to their plain versions
    at the run's own inputs, FXP_CPU_LANES lanes equal to the CPU's
    decode; rx.receive(fxp=True) on one impaired 1000-byte capture per
    rate of FXP_RECEIVE (the scan decoder: no launch); run_link of
    FXP_LINK between two stations, fxp off and on. Times: batch ms on
    the host clock and samples/s as bench.py's sps (FXP_B * frame_len
    / batch seconds), CUDA-event ms of the front and the decode, peak
    device memory. Returns (the phase's JSON object, launches by run,
    the kernel checks)."""
    import torch

    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.phy import channel
    from ziria_tpu_torch.phy.wifi import rx, rx_fxp, transceiver as trx

    out = {"phase": "fxp", "card": card,
           "primitives_bitwise": fxp_primitive_checks(rng, dev)}
    frames, want, rate, n_sym = fxp_frames(rng, dev)
    frame_len = int(frames.shape[1])
    fq = rx_fxp.quantize_frame(frames)
    check(torch.equal(fq.cpu(), rx_fxp.quantize_frame(frames.cpu())),
          "fxp quantize_frame: the card differs from the CPU")
    nbits = 8 * FXP_BYTES

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vc.reset_launches()
        vf.reset_launches()
        res, ms = host_ms(fn)
        launches = {k: v for k, v in {**vc.LAUNCHES, **vf.LAUNCHES}.items()
                    if v}
        return res, launches, ms, torch.cuda.max_memory_allocated(dev)

    runs, launches, checks, first = {}, {}, {}, None
    for name, window in (("fxp_batch", None),
                         ("fxp_batch_window", FXP_WINDOW)):
        tap = KernelTap([(vc, "acs"), (vc, "traceback")])
        with tap:
            (psdu, _svc), launches[name], ms, peak = counted(
                lambda w=window: rx_fxp.decode_data_batch_fxp(
                    fq, rate, n_sym, nbits, viterbi_window=w))
        check(launches[name] == {"acs": 1, "traceback": 1},
              f"{name}: launches {launches[name]}")
        got = psdu.cpu().numpy()
        bad = [i for i in range(FXP_B) if not np.array_equal(got[i],
                                                             want[i])]
        check(not bad, f"{name}: lanes decoded wrongly: {bad}")
        if first is None:
            first = got
        check(np.array_equal(got, first), f"{name} differs from exact")
        checks[name] = stream_kernel_checks(torch, name, tap, False)
        cpu_bits, _s = rx_fxp.decode_data_batch_fxp(
            fq[:FXP_CPU_LANES].cpu(), rate, n_sym, nbits,
            viterbi_window=window)
        check(np.array_equal(cpu_bits.numpy(), got[:FXP_CPU_LANES]),
              f"{name}: the card differs from the CPU")
        runs[name] = dict(first_call_ms=ms, peak_mem_bytes=peak,
                          launches=launches[name], window=window,
                          frames_right=FXP_B,
                          cpu_lanes_bitwise=FXP_CPU_LANES)

    # times: the whole batch on the host clock, then its two steps under
    # CUDA events
    reps = 3
    dep = rx_fxp._front_batch(fq, rate, n_sym).to(torch.float32)
    for name, window in (("fxp_batch", None),
                         ("fxp_batch_window", FXP_WINDOW)):
        ms = 0.0
        for _ in range(reps):
            _r, t = host_ms(lambda w=window: rx_fxp.decode_data_batch_fxp(
                fq, rate, n_sym, nbits, viterbi_window=w))
            ms += t / reps
        runs[name].update(
            batch_ms=ms, samples_per_s=FXP_B * frame_len / ms * 1e3,
            frames_per_s=FXP_B / ms * 1e3,
            front_ms=cuda_ms(lambda: rx_fxp._front_batch(fq, rate, n_sym),
                             reps=reps),
            decode_ms=cuda_ms(lambda w=window: vc.viterbi_decode_batch_opt(
                dep, n_bits=n_sym * rate.n_dbps, window=w), reps=reps))
    out.update(frames=FXP_B, psdu_bytes=FXP_BYTES, rate_mbps=FXP_MBPS,
               n_sym=n_sym, frame_len=frame_len, snr_db=FXP_SNR_DB,
               reps=reps, batch=runs)

    recv = {}
    for k, mbps in enumerate(FXP_RECEIVE):
        psdu, xi = channel.impaired_capture(mbps, FXP_BYTES, FXP_SEED + k,
                                            add_fcs=True, device=dev)
        res, lc, ms, _peak = counted(lambda: rx.receive(
            np.asarray(xi, np.float32), check_fcs=True, fxp=True,
            device=dev))
        name = f"fxp_receive_{mbps}"
        launches[name] = lc
        bits = np.unpackbits(np.asarray(psdu, np.uint8), bitorder="little")
        check(res.ok and res.rate_mbps == mbps and res.crc_ok is True
              and np.array_equal(res.psdu_bits[: bits.size], bits),
              f"{name}: decoded wrongly")
        check(not lc, f"{name}: launches {lc} (the scan decoder)")
        recv[name] = dict(ms=ms, samples=int(xi.shape[0]),
                          length_bytes=res.length_bytes)
    out["receive"] = recv

    link = {}
    for fx in (False, True):
        a = trx.Station(addr=1, rate_mbps=24, fxp=fx, device=dev)
        b = trx.Station(addr=2, fxp=fx, device=dev)
        name = "fxp_link" if fx else "float_link"
        _r, launches[name], ms, _peak = counted(
            lambda a=a, b=b: trx.run_link(a, b, list(FXP_LINK)))
        check([p for _s, p in b.delivered] == list(FXP_LINK)
              and a.acked == list(range(len(FXP_LINK))) and not a.failed
              and a.counters["retries"] == 0 and b.counters["dups"] == 0,
              f"{name}: delivered {b.delivered}, acked {a.acked}, "
              f"counters {a.counters}")
        check(not launches[name], f"{name}: launches {launches[name]}")
        link[name] = dict(ms=ms, delivered=len(b.delivered),
                          acked=len(a.acked), counters_a=a.counters,
                          counters_b=b.counters)
    out["link"] = link
    out["kernels"] = checks
    return out, launches, checks


def cli_out(argv):
    """(return code, stdout, stderr) of one in-process ``cli.main``."""
    import contextlib
    import io

    from ziria_tpu_torch.runtime import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def serve_report(argv, sessions, frames, what):
    """One ``serve`` subcommand run on the card, its JSON report checked:
    every session's frames served, the stats balanced. Returns (the
    report, host ms, stderr, the decode dispatches, the ACS and
    traceback launches)."""
    from ziria_tpu_torch.ops import viterbi_cuda as vc
    from ziria_tpu_torch.utils import dispatch

    vc.reset_launches()
    with dispatch.count_dispatches() as d:
        (rc, out, err), ms = host_ms(lambda: cli_out(["serve", *argv]))
    check(rc == 0, f"serve {what}: returned {rc}")
    rep = json.loads(out.strip().splitlines()[-1])
    st = rep["stats"]
    check(rep["frames"] == st["frames"] == sessions * frames
          and st["admitted"] == st["closed"] == sessions
          and st["shed"] == st["evicted"] == st["rejected_slabs"] == 0
          and st["active_sessions"] == st["queue_depth"] == 0,
          f"serve {what}: unbalanced report {rep}")
    return (rep, ms, err, d.counts.get("rx.stream_decode_multi", 0),
            dict(vc.LAUNCHES))


def fresh_build(tmp):
    """Point the kernel build at an empty directory under `tmp` and drop
    the loaded library, so the next launch compiles with nvcc again.
    Returns a function that puts the old directory back."""
    from ziria_tpu_torch import cuda_build
    from ziria_tpu_torch.ops import viterbi_cuda as vc

    old = cuda_build.BUILD_DIR

    def reset(path):
        cuda_build.BUILD_DIR = path
        cuda_build._libs.clear()
        vc._lib.cache_clear()
    reset(os.path.join(tmp, "build"))
    return lambda: reset(old)


def golden_argv(name, mode, backend, outfile, extra=()):
    here = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(here, "examples")
    return [f"--src={os.path.join(ex, name + '.zir')}",
            f"--input-file-name={os.path.join(ex, 'golden', name)}.infile",
            f"--input-file-mode={mode}", f"--output-file-mode={mode}",
            f"--output-file-name={outfile}", f"--backend={backend}", *extra]


def site_split(rep, labels):
    """Launches, device ms and host ms of `labels` in a profile."""
    return {lb: {k: rep["sites"].get(lb, {}).get(k, 0)
                 for k in ("calls", "launches", "device_ms", "host_ms")}
            for lb in labels}


def observe_phase(rng, dev, card):
    """The CLI's run and serve surface, tracing, the observatory and the
    autotuner on the card, all through ``runtime/cli.main``. Returns
    (the phase's JSON object, the batch profiles' launch counters)."""
    import tempfile

    import torch

    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
        write_stream
    from ziria_tpu_torch.utils import geometry, programs
    from ziria_tpu_torch.utils.diff import stream_diff

    t_phase = time.perf_counter()
    out = {"phase": "observe", "card": card}
    n_sessions, n_frames = (int(OBSERVE_SERVE[OBSERVE_SERVE.index(f) + 1])
                            for f in ("--sessions", "--frames"))
    with tempfile.TemporaryDirectory() as tmp:
        # serve: defaults, then chaos with --metrics-dump, then
        # snapshots and a recovery
        serve = {}
        rep, ms, _err, decodes, launches = serve_report(
            OBSERVE_SERVE, n_sessions, n_frames, "defaults")
        check(launches["acs"] == launches["traceback"] == decodes > 0,
              f"serve: {decodes} decodes but launches {launches}")
        serve["defaults"] = dict(ms=ms, decode_dispatches=decodes,
                                 launches={k: v for k, v in launches.items()
                                           if v}, report=rep)
        rep, ms, err, decodes, launches = serve_report(
            OBSERVE_SERVE + ("--chaos", OBSERVE_CHAOS, "--metrics-dump"),
            n_sessions, n_frames, "chaos")
        check("metrics exposition" in err and "resilience_retries" in err,
              "serve --chaos --metrics-dump: no exposition or no retry")
        check(1 <= launches["acs"] == launches["traceback"] <= decodes,
              f"serve chaos: {decodes} decodes, launches {launches}")
        serve["chaos"] = dict(ms=ms, decode_dispatches=decodes,
                              launches={k: v for k, v in launches.items()
                                        if v}, report=rep, spec=OBSERVE_CHAOS)
        snap = os.path.join(tmp, "snap")
        for what, extra in (("snapshot", ("--snapshot-dir", snap,
                                          "--snapshot-every", "2")),
                            ("recover", ("--snapshot-dir", snap,
                                         "--recover"))):
            rep, ms, _err, decodes, launches = serve_report(
                OBSERVE_SERVE + extra, n_sessions, n_frames, what)
            serve[what] = dict(ms=ms, decode_dispatches=decodes,
                               report=rep)
        check(serve["recover"]["report"]["stats"]["restarts"] == 1,
              "serve --recover did not restart from the snapshot dir")
        out["serve"] = serve

        # --prog on the card against --platform=cpu
        progs = {}
        for name, (ity, oty, n, atol) in OBSERVE_PROGS.items():
            shape = (n, 2) if ity.startswith("complex") else (n,)
            xs = (rng.normal(size=shape).astype(np.float32)
                  if ity == "float32" else
                  rng.integers(0, 2, shape).astype(np.uint8)
                  if ity == "bit" else
                  rng.integers(-1, 2, shape).astype(np.int16))
            inf = os.path.join(tmp, f"{name}.in")
            write_stream(StreamSpec(ty=ity, path=inf), xs)
            got = {}
            for plat in ("cuda", "cpu"):
                outf = os.path.join(tmp, f"{name}.{plat}.out")
                (rc, _o, _e), ms = host_ms(lambda: cli_out([
                    f"--prog={name}", f"--input-file-name={inf}",
                    f"--input-type={ity}", f"--output-file-name={outf}",
                    f"--output-type={oty}", f"--platform={plat}"]))
                check(rc == 0, f"--prog={name} on {plat}: returned {rc}")
                got[plat] = read_stream(StreamSpec(ty=oty, path=outf))
                progs.setdefault(name, {})[f"{plat}_ms"] = ms
            a, b = got["cuda"], got["cpu"]
            check(a.shape == b.shape and a.shape[0] > 0,
                  f"--prog={name}: shapes {a.shape} {b.shape}")
            err = float(np.abs(a.astype(np.float64) - b).max())
            check(err <= atol, f"--prog={name}: card vs CPU {err} > {atol}")
            progs[name].update(items_in=n, max_abs_err=err, atol=atol)
        out["progs"] = progs

        # --trace: a jit golden case, then the wifi_rx golden case with
        # the decode windowed (its kernels launched) and the kernels
        # built afresh inside the trace
        traces = {}
        path = os.path.join(tmp, "scrambler.trace.json")
        outf = os.path.join(tmp, "scrambler.out")
        (rc, _o, _e), ms = host_ms(lambda: cli_out(golden_argv(
            "scrambler", "dbg", "jit", outf, (f"--trace={path}",))))
        check(rc == 0, "scrambler --trace failed")
        obj = json.load(open(path))
        spans = sorted({e["name"] for e in obj["traceEvents"]
                        if e.get("cat") == "host"})
        check(bool(spans) and set(spans) <= {"execute.scan_bulk",
                                             "execute.scan_rem"},
              f"scrambler trace spans {spans}")
        traces["scrambler"] = dict(ms=ms, events=len(obj["traceEvents"]),
                                   spans=spans)
        path = os.path.join(tmp, "wifi_rx.trace.json")
        outf = os.path.join(tmp, "wifi_rx.out")
        restore = fresh_build(tmp)
        try:
            (rc, _o, _e), ms = host_ms(lambda: cli_out(golden_argv(
                "wifi_rx", "bin", "hybrid", outf,
                (f"--trace={path}", f"--viterbi-window={OBSERVE_WINDOW}"))))
        finally:
            restore()
        check(rc == 0, "wifi_rx --trace failed")
        here = os.path.dirname(os.path.abspath(__file__))
        want = read_stream(StreamSpec(ty="bit", path=os.path.join(
            here, "examples", "golden", "wifi_rx.outfile.ground"),
            mode="bin"))
        got = read_stream(StreamSpec(ty="bit", path=outf, mode="bin"))
        check(bool(stream_diff(got, want, name="wifi_rx")),
              "wifi_rx windowed: the output differs from its ground file")
        obj = json.load(open(path))
        evs = obj["traceEvents"]
        spans = sorted({e["name"] for e in evs if e.get("cat") == "host"})
        compiles = [dict(name=e["name"], ms=e["dur"] / 1e3, **e["args"])
                    for e in evs if e.get("cat") == "compile"]
        check({"hybrid.device_block", "externals.viterbi_windowed"}
              <= set(spans), f"wifi_rx trace spans {spans}")
        check([c["name"] for c in compiles] == ["nvcc:viterbi.cu"],
              f"wifi_rx trace compile events {compiles}")
        launches = cli.LAST_RUN["launches"]
        check(launches.get("acs", 0) >= 1
              and launches.get("traceback", 0) >= 1,
              f"wifi_rx windowed: launches {launches}")
        check(cli.LAST_RUN["chunk"]["demoted"] == 0,
              "wifi_rx --trace: a chunk machine was demoted")
        traces["wifi_rx"] = dict(ms=ms, window=OBSERVE_WINDOW,
                                 events=len(evs), spans=spans,
                                 compiles=compiles, launches=launches)
        out["trace"] = traces

        # --profile and --profile-trace on a jit case
        ptdir = os.path.join(tmp, "scrambler_profile")
        (rc, _o, _e), ms = host_ms(lambda: cli_out(golden_argv(
            "scrambler", "dbg", "jit", os.path.join(tmp, "p.out"),
            ("--profile", f"--profile-trace={ptdir}"))))
        check(rc == 0, "scrambler --profile failed")
        rows = cli.LAST_RUN["profile"]
        check(all(r["cuda_ms"] is not None for r in rows),
              "--profile gave no CUDA-event time on the card")
        pt = json.load(open(cli.LAST_RUN["profile_trace"]))["traceEvents"]
        kern = [e for e in pt if e.get("cat") == "kernel"]
        anns = {e["name"] for e in pt if e.get("cat") == "user_annotation"}
        check(bool(kern) and anns & {"execute.scan_bulk",
                                     "execute.scan_rem"},
              "scrambler profiler trace: no kernel or no site range")
        out["profile"] = dict(ms=ms, stages=rows, profiler_kernels=len(kern))

        # programs --batch: the profiled batches, launches held to the
        # wrappers' counters
        pdir = os.path.join(tmp, "programs")
        (rc, o, _e), ms = host_ms(lambda: cli_out(
            ["programs", "--batch", "--json", f"--trace-dir={pdir}"]))
        check(rc == 0, "programs --batch failed")
        rep = json.loads(o)
        pt = json.load(open(rep["profiles"]["receive_many"]["trace_path"]))
        knames = {e["name"] for e in pt["traceEvents"]
                  if e.get("cat") == "kernel"}
        check(any("acs_kernel" in k for k in knames)
              and any("traceback_kernel" in k for k in knames),
              "programs --trace-dir: the profiler trace names no ACS or "
              "traceback kernel")
        batches, counters = {}, {}
        for name, pr in rep["profiles"].items():
            lc = pr["launch_counters"]
            seen = {"acs": programs.kernel_count(pr, r"acs_kernel", "fused"),
                    "traceback": programs.kernel_count(
                        pr, r"traceback_kernel"),
                    "fused_mixed": programs.kernel_count(
                        pr, r"fused_acs_mixed_kernel")}
            for k, v in seen.items():
                check(v == lc.get(k, 0), f"programs {name}: the profiler "
                      f"saw {v} {k} launches, the counters {lc}")
            for k in OBSERVE_LAUNCHED[name]:
                check(seen[k] >= 1, f"programs {name}: no {k} launch")
            check(rep["right"][name] == B, f"programs {name}: "
                  f"{rep['right'][name]} of {B} PSDUs right")
            top = sorted(pr["sites"].items(),
                         key=lambda kv: -kv[1]["device_ms"])
            batches[name] = dict(
                wall_ms=pr["wall_ms"], window_ms=pr["window_ms"],
                busy_ms=pr["busy_ms"], busy_share=pr["busy_share"],
                idle_share=pr["idle_share"],
                unprofiled_ms=pr["unprofiled_ms"],
                window_over_unprofiled=pr["window_over_unprofiled"],
                idle_share_unprofiled=pr["idle_share_unprofiled"],
                kernels=pr["kernels"], launch_counters=lc,
                sites={k: {f: v.get(f) for f in
                           ("calls", "host_ms", "launches", "copies",
                            "device_ms", "top_kernels")}
                       for k, v in top},
                acquisition=site_split(pr, (
                    "rx.acquire_pad", "rx.acquire_many", "sync.fir_valid",
                    "sync.sliding_sum", "rx.signal_scan")))
            counters[name] = lc
        check(rep["sites_covered"] >= 1, "programs: no site covered")
        out["programs"] = dict(ms=ms, batches=batches,
                               device_kind=rep["device_kind"],
                               device_peaks=rep["devicePeaks"])

        # autotune at a smoke size into a record file of its own; no
        # file of the repo may change
        before = repo_files()
        ledger = os.path.join(tmp, "tuned.jsonl")
        (rc, o, _e), ms = host_ms(lambda: cli_out(
            ["autotune", *OBSERVE_AUTOTUNE, "--ledger", ledger]))
        check(rc == 0 and "reproduces the winner" in o,
              f"autotune failed: {o[-400:]}")
        from ziria_tpu_torch.utils import autotune
        res = dict(autotune.MAIN_RESULT)
        kind = torch.cuda.get_device_name(0)
        check(res["device_kind"] == kind, "autotune: wrong device kind")
        check(res["winner"] not in res["identity_rejected"],
              "autotune: the winner failed the identity gate")
        check(geometry.Geometry.tuned(kind, ledger).as_dict()
              == res["geometry"], "Geometry.tuned does not reproduce it")
        check(repo_files() == before, "autotune changed a file of the repo")
        out["autotune"] = dict(
            ms=ms, winner=res["winner"], speedup=res["speedup"],
            sps_tuned=res["sps_tuned"], baseline_sps=res["baseline_sps"],
            pruned=[r["label"] for r in res["pruned"]],
            identity_rejected=res["identity_rejected"],
            measured=res["measured"])
    out["wall_s"] = time.perf_counter() - t_phase
    check(out["wall_s"] <= OBSERVE_BUDGET_S,
          f"observe phase took {out['wall_s']:.1f} s of its "
          f"{OBSERVE_BUDGET_S} s")
    return out, counters


def repo_files():
    """(path, size, mtime) of every file of the checkout around this
    script, build outputs and caches aside."""
    here = os.path.dirname(os.path.abspath(__file__))
    skip = {".git", "__pycache__", "build", ".jax_cache", ".pytest_cache"}
    out = []
    for d, dirs, files in os.walk(here):
        dirs[:] = [x for x in dirs if x not in skip]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out.append((os.path.relpath(os.path.join(d, f), here),
                        st.st_size, st.st_mtime_ns))
    return sorted(out)


def synth_phase(rng, dev, card):
    """serve.synth_load's streams through receive_streams on the card
    at SYNTH_GEO, launch counts zeroed just before and read just after;
    every frame emitted once at its true start and right, and each
    stream equal to a lone receiver's.
    Returns (the phase's JSON object, its launches)."""
    import torch

    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.ops.crc import append_crc32
    from ziria_tpu_torch.phy import link
    from ziria_tpu_torch.phy.wifi.params import RATES
    from ziria_tpu_torch.runtime import serve
    from ziria_tpu_torch.utils import dispatch
    from ziria_tpu_torch.utils.bits import bytes_to_bits

    seed = SYNTH_SEED
    clients = serve.synth_load(SYNTH_SESSIONS, SYNTH_FRAMES, SYNTH_BYTES,
                               seed=seed, device=dev)
    # synth_load's own recipe, for the truth: the same PSDUs and streams
    trng = np.random.default_rng(seed)
    rates_all = sorted(RATES)
    per_rates = [[rates_all[(i + j) % 8] for j in range(SYNTH_FRAMES)]
                 for i in range(SYNTH_SESSIONS)]
    per_psdus = [[trng.integers(0, 256, SYNTH_BYTES).astype(np.uint8)
                  for _ in r] for r in per_rates]
    streams, starts = link.stream_many_multi(
        per_psdus, per_rates, snr_db=30.0, cfo=1e-4, delay=60, seed=seed,
        add_fcs=True, tail=1024, device=dev)
    xs = [c.stream for c in clients]
    check(all(np.array_equal(a, b) for a, b in zip(xs, streams)),
          "synth: synth_load's streams differ from stream_many_multi's")
    torch.cuda.synchronize()
    vc.reset_launches()
    vf.reset_launches()
    with dispatch.count_dispatches() as d:
        (per, stats), ms = host_ms(lambda: framebatch.receive_streams(
            xs, check_fcs=True, device=dev, **SYNTH_GEO))
    launches = {**vc.LAUNCHES, **vf.LAUNCHES}
    decodes = d.counts.get("rx.stream_decode_multi", 0)
    want = {k: 0 for k in launches}
    want.update(acs=decodes, traceback=decodes)
    check(decodes > 0 and launches == want,
          f"synth: launches {launches}, want {want}")
    n_right = 0
    for i in range(SYNTH_SESSIONS):
        sts = [int(v) for v in starts[i]]
        check([f.start for f in per[i]] == sts,
              f"synth: stream {i} emitted {[f.start for f in per[i]]}, "
              f"sent {sts}")
        for k, (f, m, p) in enumerate(zip(per[i], per_rates[i],
                                          per_psdus[i])):
            bits = append_crc32(bytes_to_bits(torch.from_numpy(p))).numpy()
            ok = (f.result.ok and f.result.rate_mbps == m
                  and f.result.length_bytes == SYNTH_BYTES + 4
                  and f.result.crc_ok is True
                  and np.array_equal(f.result.psdu_bits, bits))
            n_right += ok
            check(ok, f"synth: stream {i} frame {k} decoded wrongly")
        check(same_frames(per[i], lone_frames(framebatch, dev, xs[i],
                                              **SYNTH_GEO)),
              f"synth: stream {i} differs from a lone StreamReceiver")
    n = sum(x.shape[0] for x in xs)
    return ({"phase": "synth", "card": card, "sessions": SYNTH_SESSIONS,
             "frames_per_session": SYNTH_FRAMES, "psdu_bytes": SYNTH_BYTES,
             "seed": seed, "geometry": SYNTH_GEO, "samples": n, "ms": ms,
             "samples_per_s": n / ms * 1e3,
             "frames": sum(len(p) for p in per),
             "chunk_steps": stats.chunk_steps, "decode_dispatches": decodes,
             "frames_right": n_right,
             "launches": launches, "equal_to_lone_receivers": True},
            launches)


def mesh_phase(rng, dev, card, fleet_wide, sweep_run):
    """The mesh on the card (the docstring's phase 15): the wide fleets
    over MESH_ENTRIES entries of one card against the fleet phase's
    unsharded runs, each shard's kernels held to their plain versions;
    sweep_ber_sharded against the sweep phase's counts; the sharded
    packet search; stream_parallel and lower_stage_parallel against
    run_jit; the CLI's --sp/--pp; an NCCL world of one; ServeConfig
    .shard. Returns (the phase's JSON object, each run's launches)."""
    import socket
    import tempfile

    import torch

    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.backend.execute import run_jit
    from ziria_tpu_torch.core import ir
    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.parallel import (lower_stage_parallel, multihost,
                                          stream_parallel)
    from ziria_tpu_torch.parallel.mesh import Mesh
    from ziria_tpu_torch.phy import link, search
    from ziria_tpu_torch.runtime import cli, serve
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream
    from ziria_tpu_torch.utils import dispatch

    n = MESH_ENTRIES
    dp, sp = Mesh([dev] * n, ("dp",)), Mesh([dev] * n, ("sp",))
    out, launches_of, checks_of = {}, {}, {}

    def counted(fn):
        torch.cuda.synchronize()
        vc.reset_launches()
        vf.reset_launches()
        with dispatch.count_dispatches() as d:
            got, ms = host_ms(fn)
        return got, ms, {**vc.LAUNCHES, **vf.LAUNCHES}, dict(d.counts)

    # 1. the wide fleets, default and fused, over n entries of the card
    made = fleet_wide["streams"]
    xs = [x for x, _s, _t in made]
    for name, knobs in (("fleet_wide", {}),
                        ("fleet_wide_fused", {"fused_demap": True})):
        fused = bool(knobs)
        acs_key = "fused_mixed" if fused else "acs"
        tap = KernelTap([(vc, "traceback"),
                         (vf, "fused_acs_mixed") if fused else (vc, "acs")],
                        n)

        def run(knobs=knobs):
            msr = framebatch.MultiStreamReceiver(
                check_fcs=True, mesh=dp, device=dev, **STREAM_WIDE,
                **knobs)
            got = push_fleet(msr, xs, 0, max(x.shape[0] for x in xs)) \
                + msr.flush()
            return by_stream(got, msr.s), msr.stats
        with tap:
            (per, st), ms, launches, counts = counted(run)
        decodes = counts.get("rx.stream_decode_multi", 0)
        want = {k: 0 for k in launches}
        want.update({acs_key: n * decodes, "traceback": n * decodes})
        check(decodes > 0 and launches == want,
              f"mesh {name}: launches {launches}, want {want} ({n} a "
              f"decode dispatch, one a shard)")
        check(counts.get("rx.stream_chunk_multi", 0) == st.chunk_steps
              and not st.degraded and st.lane_blowups == 0,
              f"mesh {name}: dispatches {counts}, stats {st}")
        for i, (x, starts, truth) in enumerate(made):
            check(right(per[i], starts, truth),
                  f"mesh {name}: stream {i} decoded wrongly")
            check(same_frames(per[i], fleet_wide["frames"][name][i]),
                  f"mesh {name}: stream {i} differs from the unsharded "
                  f"fleet (held to its lone receiver in the fleet phase)")
        launches_of[name] = launches
        # after the counts are read: these launches compare and count
        # nowhere
        checks_of[name] = [stream_kernel_checks(
            torch, f"mesh {name} shard {i}", tap.shard(i), fused)
            for i in range(n)]
        n_samples = sum(x.shape[0] for x in xs)
        out[name] = {"entries": n, "knobs": knobs, "ms": ms,
                     "samples_per_s": n_samples / ms * 1e3,
                     "chunk_steps": st.chunk_steps,
                     "decode_dispatches": decodes, "launches": launches,
                     "equal_to_unsharded_fleet": True,
                     "shard_kernels": checks_of[name]}

    # 2. the sweep with its lanes over n entries
    psdus, errs = sweep_run
    got, ms, launches, _c = counted(lambda: link.sweep_ber_sharded(
        psdus, SWEEP_RATES, SWEEP_SNRS, SWEEP_SEEDS, mesh=dp, device=dev))
    n_dec = len(SWEEP_RATES) * len(SWEEP_SNRS) * len(SWEEP_SEEDS)
    want = {k: 0 for k in launches}
    want.update(acs=n * n_dec, traceback=n * n_dec)
    check(launches == want, f"mesh sweep: launches {launches}, want {want}")
    check(np.array_equal(got, errs),
          "mesh sweep: sweep_ber_sharded differs from sweep_ber")
    launches_of["sweep_sharded"] = launches
    out["sweep_sharded"] = {"entries": n, "ms": ms, "launches": launches,
                            "equal_to_sweep_ber": True}

    # 3. the packet search with its metric over n sp entries
    cap, _psdus, put = scan_capture(rng, dev)
    m1 = search.detection_metric(cap, device=dev)
    mn = search.detection_metric(cap, mesh=sp, device=dev)
    err = float(np.abs(m1 - mn).max())
    check(m1.shape == mn.shape and err <= 2e-4,
          f"mesh search: sharded metric off by {err}")
    starts = search.find_packets(cap, device=dev)
    check(np.array_equal(starts, search.find_packets(cap, mesh=sp,
                                                     device=dev)),
          "mesh search: sharded starts differ")
    # unsharded, sharded, unsharded: the first call on this device pays
    # the receiver's compile and graph captures
    (hits1, ms_first), (hits, ms), (_h, ms1) = (
        host_ms(lambda m=m: search.scan_and_decode(cap, mesh=m, device=dev))
        for m in (None, sp, None))
    check(len(hits) == len(put) == len(hits1)
          and all(a == b and np.array_equal(x, y)
                  for (a, x), (b, y) in zip(hits, hits1)),
          f"mesh search: scan_and_decode over the mesh found "
          f"{[h for h, _b in hits]}, unsharded {[h for h, _b in hits1]}")
    out["search"] = {"entries": n, "packets": len(hits),
                     "metric_max_abs_err": err, "ms": ms,
                     "unsharded_ms": ms1, "unsharded_first_ms": ms_first,
                     "starts_equal": True}

    # 4. the compiler's programs: a scrambler phase counter with its
    # fast-forward and the 5-tap FIR with its memory over n sp entries,
    # each program twice as a 2-stage pipeline over MESH_PP pp entries
    here = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(here, "examples", "golden")
    bits = read_stream(StreamSpec(ty="bit", path=os.path.join(
        gold, "scrambler.infile"), mode="dbg"))
    samples = read_stream(StreamSpec(ty="float32", path=os.path.join(
        gold, "fir.infile"), mode="dbg"))
    scr, fir = cli.PROGS["scramble"](), cli.PROGS["fir"]()
    progs = {"scramble": (ir.map_accum(scr.f, 0, name="scramble",
                                       advance=lambda p, k: p + k), bits),
             "fir": (ir.map_accum(fir.f, np.zeros(5, np.float32),
                                  name="fir5", memory=5), samples)}
    pp = Mesh([dev] * MESH_PP, ("pp",))
    compiled = {}
    for name, (comp, items) in progs.items():
        want = run_jit(comp, items, device=dev)
        got, ms = host_ms(lambda: stream_parallel(comp, items, sp))
        e1 = float(np.abs(np.asarray(got, np.float64) - want).max())
        pipe2 = ir.par_pipe(comp, comp)
        lo = lower_stage_parallel(pipe2, pp, width=8,
                                  in_item=(items.shape[1:], items.dtype))
        m = items.shape[0] // lo.take
        ys = lo.run(items[:m * lo.take].reshape((m, lo.take)
                                                + items.shape[1:]))
        want2 = run_jit(ir.pipe(comp, comp), items[:m * lo.take],
                        width=8, device=dev)
        e2 = float(np.abs(ys.reshape(want2.shape).astype(np.float64)
                          - want2).max())
        tol = 0.0 if name == "scramble" else 1e-5
        check(got.shape == want.shape and e1 <= tol and e2 <= tol,
              f"mesh {name}: stream_parallel off by {e1}, stage "
              f"pipeline by {e2}")
        compiled[name] = {"items": int(items.shape[0]), "sp_ms": ms,
                          "sp_max_abs_err": e1, "pp_max_abs_err": e2,
                          "pp_macro_steps": m}
    out["compiler"] = compiled

    # 5. the CLI's mesh flags on the card's one device
    flags = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, prog, extra in (
                ("sp1", MESH_SP_PROG, ("--sp=1",)),
                ("pp1_measured", "scrambler",
                 ("--pp=1", "--pp-costs=measured"))):
            runs = []
            for tag, more in (("plain", ()), (name, extra)):
                f = os.path.join(tmp, f"{prog}.{tag}.out")
                rc, _o, err = cli_out(golden_argv(prog, "dbg", "jit", f,
                                                  more))
                check(rc == 0, f"mesh cli {name}: returned {rc}: "
                               f"{err[-300:]}")
                with open(f) as fh:
                    runs.append(fh.read())
            check(runs[0] == runs[1], f"mesh cli {name}: output differs "
                                      f"from the run without {extra}")
            flags[name] = {"program": prog, "equal_to_plain": True}
        for name, prog, flag, msg in (
                ("sp4", MESH_SP_PROG, "--sp=4", "--sp=4: need 4 devices, "
                                                "only 1 visible"),
                ("pp2", MESH_PP_PROG, "--pp=2", "--pp=2: need 2 devices, "
                                                "only 1 visible")):
            f = os.path.join(tmp, f"{prog}.{name}.out")
            try:
                cli_out(golden_argv(prog, "dbg", "jit", f, (flag,)))
                said = None
            except SystemExit as e:
                said = str(e)
            if torch.cuda.device_count() == 1:
                check(said == msg, f"mesh cli {name}: {said!r}, want "
                                   f"{msg!r}")
            flags[name] = {"program": prog, "refused": said}
    out["cli"] = flags

    # 6. an NCCL world of one: up, one all_reduce, down
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    check(multihost.init_multihost(f"127.0.0.1:{port}", 1, 0,
                                   device="cuda", timeout_s=120),
          "mesh processes: init_multihost did not bring the group up")
    try:
        import torch.distributed as dist
        v = torch.arange(4, dtype=torch.int64, device=dev)
        dist.all_reduce(v)
        info = multihost.mesh_info(multihost.build_mesh(dp=1, pp=1,
                                                        device="cuda"))
        check(dist.get_backend() == "nccl" and v.tolist() == [0, 1, 2, 3]
              and info["n_processes"] == 1,
              f"mesh processes: {dist.get_backend()}, {v.tolist()}, {info}")
    finally:
        multihost.shutdown_multihost()
    check(not torch.distributed.is_initialized(),
          "mesh processes: the group is still up")
    out["processes"] = {"backend": "nccl", "world": 1,
                        "up_down_s": time.perf_counter() - t0}

    # 7. ServeConfig.shard on the one card: the elastic rule gives an
    # unsharded fleet there; its frames equal shard=False's
    sessions, frames, nbytes = MESH_SERVE
    clients = serve.synth_load(sessions, frames, nbytes, seed=SYNTH_SEED,
                               device=dev)
    served, meshes = [], []
    for shard in (True, False):
        cfg = serve.ServeConfig(n_lanes=sessions, shard=shard,
                                check_fcs=True, **SYNTH_GEO)
        with serve.ServeRuntime(cfg, device=dev) as srv:
            meshes.append(srv._rx.mesh)
            served.append(serve.run_clients(srv, clients))
    check(meshes[1] is None and (meshes[0] is None) ==
          (torch.cuda.device_count() == 1),
          f"mesh serve: shard=True built {meshes[0]}")
    check(all(same_frames(served[0][c.sid], served[1][c.sid])
              for c in clients)
          and sum(len(v) for v in served[0].values()) == sessions * frames,
          "mesh serve: shard=True differs from shard=False")
    out["serve"] = {"sessions": sessions, "frames": sessions * frames,
                    "mesh": None if meshes[0] is None else meshes[0].size,
                    "equal": True}
    return {"phase": "mesh", "card": card, "runs": out}, launches_of


def soak_phase(dev, card):
    """The chaos-soak campaign and the windowed BER study on the card
    (the docstring's phase 16). Returns (the phase's JSON object, each
    part's launches, the kernel checks at the warm pass's first
    decode)."""
    import torch

    from ziria_tpu_torch.ops import viterbi_cuda as vc, viterbi_fused as vf
    from ziria_tpu_torch.tools import soak, windowed_ber as wb

    def counted(fn):
        torch.cuda.synchronize()
        vc.reset_launches()
        vf.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, {**vc.LAUNCHES, **vf.LAUNCHES}, time.perf_counter() - t0

    # 1. the campaign; the kernels held to plain at the warm pass's first
    # decode (after the counts are read: those launches count nowhere)
    tap = KernelTap([(vc, "acs"), (vc, "traceback")])
    ev, soak_launches, campaign_s = counted(
        lambda: soak.soak_stats(**SOAK_ARGS, recovery_slo_s=SOAK_SLO_S,
                                device=dev, warm_tap=tap))
    checks = stream_kernel_checks(torch, "soak_warm", tap, False)
    del tap
    posts = ev["post_recovery"]
    check(ev["zero_crashes"] and ev["identity"] == "bit_identical"
          and ev["recovery_p99_s"] <= SOAK_SLO_S,
          f"soak: gates {ev['zero_crashes']}, {ev['identity']}, "
          f"p99 {ev['recovery_p99_s']}")
    check(ev["kills"]["killed"] >= 1, f"soak: no SIGKILL landed "
          f"({ev['kills']})")
    check(all(c["nvcc_builds"] == 0 and c["device"] == str(dev)
              for c in ev["children"]),
          f"soak: a child ran nvcc or another device: {ev['children']}")
    check(len(posts) == 1 + len(ev["kind_rounds"])
          + sum(c["killed"] for c in ev["children"])
          and all(p["launches"]["acs"] == p["launches"]["traceback"]
                  == p["decode_dispatches"] and p["dpcs"] <= 2.0
                  and p["nvcc_builds"] == p["library_loads"] == 0
                  for p in posts)
          and sum(p["decode_dispatches"] for p in posts) > 0,
          f"soak: a recovered fleet's budget: {posts}")
    check(soak_launches["acs"] == soak_launches["traceback"] > 0
          and sum(soak_launches.values()) == 2 * soak_launches["acs"],
          f"soak: launches {soak_launches}")

    # 2. the BER study, its windowed decodes through the kernels
    ber, ber_launches, ber_s = counted(lambda: wb.main(device=dev))
    n_dec = len(wb.AMPS) * len(wb.OVERLAPS)
    check(ber_launches == {k: (n_dec if k in ("acs", "traceback") else 0)
                           for k in ber_launches},
          f"windowed_ber: launches {ber_launches}, want {n_dec} each")
    pts = {p["llr_amp"]: p for p in ber["points"]}
    ov = str(vc.DEFAULT_WINDOW_OVERLAP)
    check(pts[1.2]["overlaps"][ov]["disagree_vs_exact"] == 0.0,
          f"windowed_ber: amplitude 1.2, overlap {ov} differs from exact")
    ber_e, ber_w = pts[0.9]["ber_exact"], pts[0.9]["overlaps"][ov]["ber"]
    rel, absl = SOAK_BER_ENVELOPE
    check(abs(ber_w - ber_e) < rel * max(ber_e, 1e-9) + absl,
          f"windowed_ber: amplitude 0.9 BER {ber_w} against exact {ber_e}")
    # the kernel path against the plain versions in the hook, every point
    # and overlap, bitwise (these launches count nowhere)
    t0 = time.perf_counter()
    for amp, _msgs, llrs in wb.points():
        x = torch.from_numpy(llrs).to(dev)
        for o in wb.OVERLAPS:
            check(torch.equal(wb.windowed(x, o),
                              wb.windowed(x, o, _decode=wb.plain_engine)),
                  f"windowed_ber: amplitude {amp}, overlap {o}: the kernels "
                  f"differ from their plain versions")
    plain_s = time.perf_counter() - t0
    children = ev["children"]
    return ({"phase": "soak", "card": card, "args": SOAK_ARGS,
             "slo_s": SOAK_SLO_S, "campaign_s": campaign_s,
             "faults_injected": ev["faults_injected"],
             "faults_by_kind": ev["faults_by_kind"],
             "recovery_s": ev["recovery_s"],
             "recovery_p50_s": ev["recovery_p50_s"],
             "recovery_p99_s": ev["recovery_p99_s"],
             "duplicates": ev["duplicates"], "deduped": ev["deduped"],
             "snapshots": ev["snapshots"],
             "journal_errors": ev["journal_errors"],
             "oracle_frames": ev["oracle_frames"],
             "channel_round_frames": ev["channel_round_frames"],
             "kind_rounds": ev["kind_rounds"],
             "kills": ev["kills"], "post_recovery": posts,
             "child_cuda_init_s": [c["cuda_init_s"] for c in children],
             "children": children, "launches": soak_launches,
             "kernels": checks,
             "windowed_ber": {"s": ber_s, "launches": ber_launches,
                              "plain_hook_s": plain_s,
                              "equal_to_plain": True, "table": ber}},
            {"campaign": soak_launches, "windowed_ber": ber_launches},
            checks)


def run_zir(src, infile, mode, backend, outfile, platform, extra=()):
    """One run of the port's CLI (``python -m ziria_tpu_torch``) on a
    file; returns (its output stream, the run's record: backend that
    ran, host ms, items, do-blocks, device-loop iterations, syncs,
    viterbi_soft decodes, kernel launches)."""
    from ziria_tpu_torch.frontend import compile_file
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream

    argv = [f"--src={src}", "--input=file", f"--input-file-name={infile}",
            f"--input-file-mode={mode}", "--output=file",
            f"--output-file-name={outfile}", f"--output-file-mode={mode}",
            f"--backend={backend}", f"--platform={platform}", *extra]
    rc = cli.main(argv)
    check(rc == 0, f"{src}: the CLI returned {rc}")
    prog = compile_file(src, fxp_complex16="--fxp-complex16" in extra)
    got = read_stream(StreamSpec(ty=prog.out_ty, path=outfile, mode=mode))
    run = dict(cli.LAST_RUN)
    run["ms"] = run.pop("seconds") * 1e3
    check(run["chunk"]["demoted"] == 0,
          f"{src}: {run['chunk']['demoted']} chunk machines demoted")
    return got, prog.out_ty, run


def golden_case(name, mode, backend, atol, flags, tmpdir, platform):
    """One golden case through the CLI with the case's `flags`
    (``--fxp-complex16``, ``--autolut``), its output held to the
    committed .outfile.ground by the port's stream_diff at `atol`.
    Returns the run's record."""
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream
    from ziria_tpu_torch.utils.diff import stream_diff

    here = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(here, "examples")
    gold = os.path.join(ex, "golden")
    got, ty, run = run_zir(os.path.join(ex, f"{name}.zir"),
                           os.path.join(gold, f"{name}.infile"), mode,
                           backend, os.path.join(tmpdir, f"{name}.out"),
                           platform, flags)
    want = read_stream(StreamSpec(
        ty=ty, path=os.path.join(gold, f"{name}.outfile.ground"), mode=mode))
    if atol:
        rep = stream_diff(got.astype(np.float64), want.astype(np.float64),
                          atol=atol, name=name)
    else:
        rep = stream_diff(got, want, name=name)
    check(bool(rep), f"compiler golden {name}: {rep.message}")
    return dict(run, max_abs_err=rep.max_abs_err, atol=atol)


def state_roundtrip(rng, tmpdir, platform):
    """examples/scrambler.zir (a stateful jit pipeline) on STATE_BITS
    random bits through the CLI once in one shot, then split at
    STATE_SPLIT: the first part with --state-out, the rest with
    --state-in from that checkpoint. The two parts' outputs, joined,
    must equal the one-shot output. Returns the three runs' ms."""
    from ziria_tpu_torch.runtime.buffers import StreamSpec, write_stream

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "examples", "scrambler.zir")
    xs = rng.integers(0, 2, STATE_BITS).astype(np.uint8)
    ck = os.path.join(tmpdir, "state.npz")
    outs, ms = [], {}
    for tag, part, extra in (("one_shot", xs, ()),
                             ("first", xs[:STATE_SPLIT],
                              (f"--state-out={ck}",)),
                             ("rest", xs[STATE_SPLIT:],
                              (f"--state-in={ck}",))):
        inf = os.path.join(tmpdir, f"state_{tag}.in")
        write_stream(StreamSpec(ty="bit", path=inf), part)
        got, _ty, run = run_zir(src, inf, "dbg", "jit",
                                os.path.join(tmpdir, f"state_{tag}.out"),
                                platform, extra)
        check(run["backend"] == "jit", f"state {tag}: ran {run['backend']}")
        outs.append(got)
        ms[tag] = run["ms"]
    check(np.array_equal(np.concatenate(outs[1:]), outs[0]),
          "--state-out/--state-in: the split run differs from one shot")
    return dict(bits=STATE_BITS, split=STATE_SPLIT, ms=ms,
                equal_to_one_shot=True)


def compiler_plan(dev) -> dict:
    """The port's --ddump-hybrid of examples/wifi_rx.zir (folded, as
    the CLI runs it): its loops must be COMPILER_MACHINES, the
    reference's plan. Returns the machine counts."""
    from ziria_tpu_torch.backend import hybrid
    from ziria_tpu_torch.core.opt import fold
    from ziria_tpu_torch.frontend import compile_file

    here = os.path.dirname(os.path.abspath(__file__))
    lines = []
    hybrid.hybridize(fold(compile_file(os.path.join(
        here, "examples", "wifi_rx.zir")).comp), dump=lines.append,
        device=dev)
    loops = tuple(ln.strip() for ln in lines
                  if "chunked" in ln or ln.lstrip().startswith("loop "))
    check(loops == COMPILER_MACHINES,
          f"compiler: the wifi_rx.zir plan's loops are {loops}")
    return {"While": loops.count("chunked While"),
            "For": loops.count("chunked For")}


class GraphHeldToEager:
    """While active, every chunk-machine step (backend/chunked
    ._Machine.run) runs twice at the same lanes: the eager masked loop,
    then the captured graph, whose result the run goes on with; the
    two must agree bitwise in it/pos/out_n, the emitted items and every
    carry of every lane."""

    def __init__(self):
        self.steps, self.lanes, self.mismatch = 0, 0, []

    def __enter__(self):
        import torch

        from ziria_tpu_torch.backend import chunked
        self.cls, self.real = chunked._Machine, chunked._Machine.run

        def both(mach, lanes, graphs=None):
            eager = self.real(mach, lanes, graphs=False)
            graph = self.real(mach, lanes, graphs=True)
            for a, b in zip(eager, graph):
                same = a[:3] == b[:3] and (
                    (a[3] is None and b[3] is None)
                    or np.array_equal(a[3], b[3])) and all(
                    torch.equal(x, y) for x, y in zip(a[4], b[4]))
                if not same:
                    self.mismatch.append(mach.node.orig.label())
            self.steps += 1
            self.lanes += len(lanes)
            return graph
        self.cls.run = both
        return self

    def __exit__(self, *exc):
        self.cls.run = self.real

    def report(self) -> dict:
        return {"steps": self.steps, "lanes": self.lanes,
                "mismatch": self.mismatch}


def scan_capture(rng, dev, corrupt=None):
    """One packet per rate of SCAN_RATES (PSDUs of 12-100 bytes + FCS,
    ``channel.impaired_capture`` without its own lead and tail) between
    SCAN_GAP-sample noise gaps, int16 IQ; with `corrupt`, that packet's
    DATA is negated over 16 samples. Returns (capture, PSDUs, starts)."""
    from ziria_tpu_torch.phy import channel

    def gap(n):
        return np.clip(np.round(rng.normal(scale=20.0, size=(n, 2))),
                       -32768, 32767).astype(np.int16)

    parts, psdus, starts = [gap(SCAN_GAP)], [], []
    pos = SCAN_GAP
    for k, mbps in enumerate(SCAN_RATES):
        nb = int(rng.integers(12, 101))
        psdu, xi = channel.impaired_capture(
            mbps, nb, seed=SCAN_SEED + k, cfo=0.001, pre=0, post=0,
            noise=0.02, add_fcs=True, device=dev)
        xi = np.asarray(xi)
        if k == corrupt:
            xi = np.array(xi)
            xi[500:516] = -xi[500:516]
        psdus.append(np.asarray(psdu))
        starts.append(pos)
        parts += [xi, gap(SCAN_GAP)]
        pos += xi.shape[0] + SCAN_GAP
    return np.concatenate(parts), psdus, starts


def batch_phase(rng, dev, card):
    """Frame batching, the packet search and the vectorizer on the
    card. ``--batch-input-files`` over BATCH_CAPS captures, default and
    ``--viterbi-window``: every output equal to its lone run (the
    program as the CLI builds it, one capture at a time) and to its
    PSDU, the batch's chunk-machine steps at most 2x a lone run's
    on average, launch counts zeroed just before each batch and read
    just after, the windowed batch's ACS and traceback held bitwise to
    their plain versions at their own inputs. ``--scan`` over a capture
    of one packet per SCAN_RATES rate: every packet's PSDU back, found
    where it was put; again with one packet's DATA negated: the other 7.
    The vectorizer: ``--ddump-vect`` runs, and ``run_vect`` of a static
    integer pipeline gives the CPU's output. Returns (the phase's JSON
    object, the batches' launches, the kernel checks)."""
    import tempfile

    import torch

    import ziria_tpu_torch as z
    from ziria_tpu_torch.backend import chunked, hybrid
    from ziria_tpu_torch.backend.execute import run_vect
    from ziria_tpu_torch.core import vectorize as V
    from ziria_tpu_torch.core.opt import fold
    from ziria_tpu_torch.frontend import compile_file
    from ziria_tpu_torch.interp.interp import run as interp_run
    from ziria_tpu_torch.ops import viterbi_cuda as vc
    from ziria_tpu_torch.phy import channel
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
        write_stream

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "examples", "wifi_rx.zir")
    platform = torch.device(dev).type
    out = {"phase": "batch", "card": card, "frames": BATCH_CAPS,
           "mbps": BATCH_MBPS, "psdu_bytes": BATCH_BYTES}
    launches, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        caps, ins, frames = [], [], []
        for k in range(BATCH_CAPS):
            psdu, xi = channel.impaired_capture(
                BATCH_MBPS, BATCH_BYTES, seed=BATCH_SEED + k, add_fcs=True,
                device=dev)
            caps.append(np.unpackbits(np.asarray(psdu), bitorder="little"))
            ins.append(os.path.join(tmp, f"cap{k}.bin"))
            write_stream(StreamSpec(ty="complex16", path=ins[-1],
                                    mode="bin"), np.asarray(xi))
            frames.append(read_stream(StreamSpec(ty="complex16",
                                                 path=ins[-1], mode="bin")))
        # the lone runs: the program as the CLI runs it (folded,
        # hybridized), each capture alone, in this process
        hyb = hybrid.hybridize(fold(compile_file(src).comp), device=dev)
        for how, extra in (("default", ()), ("windowed", (
                f"--viterbi-window={BATCH_WINDOW}",))):
            env = {"ZIRIA_VITERBI_WINDOW": str(BATCH_WINDOW)} if extra \
                else {}
            prev = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                chunked.reset_counts()
                t0 = time.perf_counter()
                lone = [np.asarray(interp_run(hyb, [p for p in x]).out_array(),
                                   np.uint8) for x in frames]
                ms = (time.perf_counter() - t0) * 1e3
                calls = chunked.STATS["device_calls"]
                check(not chunked.DEMOTED,
                      f"batch {how}: lone runs demoted {chunked.DEMOTED}")
            finally:
                for k, v in prev.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            outs = [os.path.join(tmp, f"{how}{k}.out")
                    for k in range(BATCH_CAPS)]
            tap = KernelTap([(vc, "acs"), (vc, "traceback")])
            torch.cuda.synchronize()
            with tap:
                rc = cli.main([f"--src={src}", f"--platform={platform}",
                               "--input-file-mode=bin",
                               "--output-file-mode=bin",
                               f"--batch-input-files={','.join(ins)}",
                               f"--batch-output-files={','.join(outs)}",
                               *extra])
            check(rc == 0, f"batch {how}: the CLI returned {rc}")
            rec = dict(cli.LAST_RUN)
            name = f"batch_{how}"
            check(rec["chunk"]["demoted"] == 0,
                  f"{name}: {rec['chunk']['demoted']} chunk machines "
                  f"demoted")
            launches[name] = dict(rec["launches"])
            right = 0
            for f, want, single in zip(outs, caps, lone):
                got = read_stream(StreamSpec(ty="bit", path=f, mode="bin"))
                check(np.array_equal(got, single),
                      f"{name}: an output differs from its lone run")
                right += int(np.array_equal(got, want))
            check(right == BATCH_CAPS,
                  f"{name}: {right} of {BATCH_CAPS} PSDUs right")
            single_avg = calls / BATCH_CAPS
            check(rec["device_calls"] <= 2 * single_avg,
                  f"{name}: {rec['device_calls']} steps against "
                  f"{single_avg} a lone frame")
            if how == "windowed":
                check(launches[name].get("acs", 0) >= 1
                      and launches[name].get("traceback", 0) >= 1,
                      f"{name}: launches {launches[name]}")
                checks[name] = stream_kernel_checks(torch, name, tap, False)
            else:
                check(not launches[name],
                      f"{name}: launches {launches[name]}")
            out[how] = {"right": right, "device_calls": rec["device_calls"],
                        "group_sizes": rec["group_sizes"],
                        "single_device_calls_avg": single_avg,
                        "replays": rec["replays"],
                        "host_reads": rec["host_reads"],
                        "ms": rec["seconds"] * 1e3,
                        "lone_ms": ms, "launches": launches[name],
                        "demoted": rec["chunk"]["demoted"]}

        scans = {}
        for name, corrupt in (("scan", None), ("scan_corrupt",
                                               SCAN_CORRUPT)):
            cap, psdus, starts = scan_capture(
                np.random.default_rng(SCAN_SEED), dev, corrupt)
            inf = os.path.join(tmp, f"{name}.bin")
            outf = os.path.join(tmp, f"{name}.out")
            write_stream(StreamSpec(ty="complex16", path=inf, mode="bin"),
                         cap)
            rc = cli.main(["--scan", f"--platform={platform}",
                           f"--input-file-name={inf}",
                           "--input-file-mode=bin",
                           f"--output-file-name={outf}",
                           "--output-file-mode=bin"])
            check(rc == 0, f"{name}: the CLI returned {rc}")
            found = cli.LAST_RUN["packets"]
            check(cli.LAST_RUN["chunk"]["demoted"] == 0,
                  f"{name}: {cli.LAST_RUN['chunk']['demoted']} chunk "
                  f"machines demoted")
            keep = [k for k in range(len(psdus)) if k != corrupt]
            want = np.concatenate([np.unpackbits(psdus[k],
                                                 bitorder="little")
                                   for k in keep])
            got = read_stream(StreamSpec(ty="bit", path=outf, mode="bin"))
            check(len(found) == len(keep) and np.array_equal(got, want),
                  f"{name}: {len(found)} packets back of {len(keep)}")
            for s, k in zip(found, keep):
                check(starts[k] - 64 <= s <= starts[k] + 160,
                      f"{name}: packet {k} found at {s}, put at "
                      f"{starts[k]}")
            scans[name] = {"packets": len(found), "expected": len(keep),
                           "samples": int(cap.shape[0]),
                           "ms": cli.LAST_RUN["seconds"] * 1e3,
                           "demoted": cli.LAST_RUN["chunk"]["demoted"]}
        out.update(scans)

        # the vectorizer: --ddump-vect through the CLI, run_vect here
        rc = cli.main([f"--src={os.path.join(here, 'examples', 'scrambler.zir')}",
                       f"--input-file-name="
                       f"{os.path.join(here, 'examples', 'golden', 'scrambler.infile')}",
                       f"--output-file-name={os.path.join(tmp, 'v.out')}",
                       f"--platform={platform}", "--ddump-vect"])
        check(rc == 0, f"--ddump-vect: the CLI returned {rc}")
    prog = z.pipe(z.zmap(lambda x: x * 3 - 1),
                  z.map_accum(lambda s, x: (s + x, s ^ x), np.int32(0)),
                  z.zmap(lambda x: x % 1000))
    xs = (np.arange(1 << 16, dtype=np.int32) * 7919) % 65521
    plan = V.vectorize(prog, device=dev)
    got = run_vect(prog, xs, device=dev, plan=plan)
    want = run_vect(prog, xs, device="cpu")
    check(np.array_equal(np.asarray(got), np.asarray(want)),
          "run_vect: the card's output differs from the CPU's")
    out["vect"] = {"widths": [sg.width for sg in plan.segments],
                   "constants": plan.constants, "items": int(xs.shape[0]),
                   "equal_to_cpu": True}
    return out, launches, checks


def compiler_phase(rng, dev, card):
    """The compiler on the card: the plan of examples/wifi_rx.zir names
    the reference's chunk machines (compiler_plan); the 28 golden cases
    through the port's CLI on their backends and flags, each output
    equal to its ground file; a --state-out/--state-in round trip
    (state_roundtrip); then examples/wifi_rx.zir at full width, one
    1000-byte capture per rate of COMPILER_RATES, default decode and
    --viterbi-window, the payload right, every chunk-machine step of
    the first run held bitwise to its eager step at the same inputs
    (GraphHeldToEager); the windowed runs' ACS and traceback launches
    held bitwise to their plain versions at their own inputs. Launch
    counts zeroed just before each run and read just after. Returns
    (the phase's JSON object, the full-width runs' launches, the kernel
    checks)."""
    import contextlib
    import tempfile

    import torch

    from ziria_tpu_torch.ops import viterbi_cuda as vc
    from ziria_tpu_torch.phy import channel
    from ziria_tpu_torch.runtime.buffers import StreamSpec, write_stream

    here = os.path.dirname(os.path.abspath(__file__))
    platform = torch.device(dev).type
    out = {"phase": "compiler", "card": card, "golden": {}, "full": {},
           "plan": compiler_plan(dev), "before_full_s": COMPILER_BEFORE_S}
    launches, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, mode, backend, atol, flags in COMPILER_CASES:
            out["golden"][name] = golden_case(name, mode, backend, atol,
                                              flags, tmp, platform)
        out["golden_s"] = time.perf_counter() - t0
        out["state_roundtrip"] = state_roundtrip(rng, tmp, platform)
        for k, rate in enumerate(COMPILER_RATES):
            psdu, xi = channel.impaired_capture(
                rate, COMPILER_BYTES, COMPILER_SEED + k, floor=0.02,
                add_fcs=True, device=dev)
            cap = os.path.join(tmp, f"cap{rate}.bin")
            write_stream(StreamSpec(ty="complex16", path=cap, mode="bin"), xi)
            want = np.unpackbits(psdu, bitorder="little")
            for how, extra in (("default", ()), ("windowed", (
                    f"--viterbi-window={COMPILER_WINDOW}",))):
                name = f"wifi_rx_{rate}_{how}"
                tap = KernelTap([(vc, "acs"), (vc, "traceback")])
                torch.cuda.synchronize()
                # the first frame: every chunk-machine step also runs
                # eagerly at the same inputs, held bitwise to the graph
                held = GraphHeldToEager() if (k, how) == (0, "default") \
                    else contextlib.nullcontext()
                with tap, held:
                    got, _ty, run = run_zir(
                        os.path.join(here, "examples", "wifi_rx.zir"), cap,
                        "bin", "hybrid", os.path.join(tmp, f"{name}.out"),
                        platform, extra)
                if (k, how) == (0, "default"):
                    out["graph_vs_eager"] = held.report()
                    check(held.steps >= 3 and not held.mismatch,
                          f"compiler {name}: graph steps against eager "
                          f"{held.report()}")
                launches[name] = dict(run["launches"])
                check(got.shape[0] >= want.shape[0]
                      and got.shape[0] - want.shape[0] < 8
                      and np.array_equal(got[: want.shape[0]], want),
                      f"compiler {name}: the payload is wrong")
                if how == "windowed":
                    check(launches[name].get("acs", 0) >= 1
                          and launches[name].get("traceback", 0) >= 1,
                          f"compiler {name}: launches {launches[name]}")
                    checks[name] = stream_kernel_checks(torch, name, tap,
                                                        False)
                else:
                    check(not launches[name],
                          f"compiler {name}: launches {launches[name]}")
                out["full"][name] = dict(run, rate_mbps=rate,
                                         psdu_bytes=COMPILER_BYTES,
                                         samples=int(xi.shape[0]))
    out["kernels"] = checks
    return out, launches, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    wall0 = time.perf_counter()

    import torch

    # ---- 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ziria_tpu_torch import cuda_build
    from ziria_tpu_torch.backend import framebatch
    from ziria_tpu_torch.ops import cplx, scramble, viterbi_cuda as vc, \
        viterbi_fused as vf
    from ziria_tpu_torch.phy.wifi import rx
    from ziria_tpu_torch.utils import geometry
    from ziria_tpu_torch.utils.dispatch import pad_lanes
    from ziria_tpu_torch.phy.wifi.params import MAX_DBPS, RATE_INDEX, \
        RATE_MBPS_ORDER, RATES

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    card = {"name": kind, "nvidia_smi": smi}
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # ---- 2. build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.basename(v["path"])
                        for k, v in built.items()},
          "ptxas": [ln.strip() for v in built.values()
                    for ln in v["log"].splitlines() if "Used" in ln
                    or "spill" in ln]})

    # ---- 3. kernel parity
    rng = np.random.default_rng(args.seed)
    llr = torch.from_numpy(parity_inputs(rng, B, PARITY_T)).to(dev)
    parity, parity_stops = {}, {}
    ref2 = {}
    for key, (md, radix) in MODES.items():
        x = llr if md == "float32" else vc._quantize_for(md, llr)
        if md == "int8":
            x[5] = 15                            # long +-15 runs: the rail
            x[5, PARITY_T // 4: PARITY_T // 2] = -15
        *got, stops = vc.acs_with_stops(x, md, radix)
        got = tuple(got)
        err = same_acs(torch, got, vc.acs_plain(x, metric_dtype=md,
                                                radix=radix), key)
        parity_stops[key] = check_stops(torch, stops, x, key)
        if md == "float32":
            check(int(stops[INF_LANE]) == PARITY_T,
                  f"{key}: the inf lane stopped early")
        if md == "int8":
            check(bool((got[1][5] == -128).any()),
                  "int8 parity lane did not reach the -128 rail")
        if radix == 2:
            ref2[md] = got
        else:
            same_acs(torch, got, ref2[md], f"{key} against radix 2")
        bits = vc.traceback(*got)
        err_tb = same_bits(torch, bits, vc.traceback_plain(*got),
                           f"traceback after {key}")
        parity[key] = err
        parity["traceback"] = max(parity.get("traceback", 0.0), err_tb)
    del llr, ref2, got, x, bits, stops

    ridx = np.arange(B) % 8
    ridx[FUSED_QUIET] = 0                 # BPSK: zero symbols, +0 pairs
    ndbps = [RATES[RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    inputs = fused_parity_inputs(rng, ndbps, PARITY_SYM, vf.MIXED_UNROLL)
    d, g, nb = (torch.from_numpy(a).to(dev) for a in inputs)
    twin = None
    for radix, key in ((2, "fused_mixed"), (4, "fused_mixed_r4")):
        *got, stops = vf.fused_acs_mixed_with_stops(d, g, ridx, nb, radix)
        got = tuple(got)
        parity[key] = same_acs(torch, got, vf.fused_acs_mixed_plain(
            d, g, ridx, nb, radix), key)
        same_bits(torch, vc.traceback(*got), vc.traceback_plain(*got), key)
        tp = PARITY_SYM * MAX_DBPS
        parity_stops[key] = check_fused_stops(
            stops, inputs[2], vf.MIXED_UNROLL, tp, key, FUSED_EXACT)
        check(int(stops[FUSED_INF]) == tp,
              f"{key}: the inf lane stopped early")
        if twin is not None:
            same_acs(torch, got, twin, f"{key} against radix 2")
        twin = got
    for m in RATE_MBPS_ORDER:
        rate = RATES[m]
        spb = vf.symbols_per_block(rate)
        n_sym = -(-PARITY_SYM // spb) * spb
        inputs = fused_parity_inputs(rng, [rate.n_dbps] * B, n_sym,
                                     spb * rate.n_dbps)
        d, g, nb = (torch.from_numpy(a).to(dev) for a in inputs)
        twin = None
        for radix, key in ((2, "fused_rate"), (4, "fused_rate_r4")):
            what = f"{key} at {m} Mbps"
            *got, stops = vf.fused_acs_rate_with_stops(d, g, rate, nb, radix)
            got = tuple(got)
            err = same_acs(torch, got, vf.fused_acs_rate_plain(
                d, g, rate, nb, radix), what)
            same_bits(torch, vc.traceback(*got), vc.traceback_plain(*got),
                      what)
            parity[key] = max(parity.get(key, 0.0), err)
            tp = n_sym * rate.n_dbps
            parity_stops.setdefault(key, {})[m] = check_fused_stops(
                stops, inputs[2], spb * rate.n_dbps, tp, what, FUSED_EXACT)
            check(int(stops[FUSED_INF]) == tp,
                  f"{what}: the inf lane stopped early")
            if twin is not None:
                same_acs(torch, got, twin, f"{what} against radix 2")
            twin = got
    del d, g, nb, got, twin, stops
    emit({"phase": "kernel_parity", "B": B, "T": PARITY_T,
          "fused_symbols": PARITY_SYM, "equal": "bitwise to plain; "
          "radix 4 bitwise to radix 2", "max_abs_err": parity,
          "stop_steps": parity_stops})

    # ---- 4. end to end: each path with the launch counts zeroed just
    # before it and read just after
    caps, sent, rates = make_captures(rng, dev)
    n_samples = sum(c.shape[0] for c in caps)

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        vc.reset_launches()
        vf.reset_launches()
        out, ms = host_ms(fn)
        launches = {**vc.LAUNCHES, **vf.LAUNCHES}
        return out, launches, ms, torch.cuda.max_memory_allocated(dev)

    def wrong(results, idx):
        return [i for i, r in zip(idx, results)
                if not (r.ok and r.rate_mbps == rates[i]
                        and r.length_bytes == PSDU_BYTES
                        and r.crc_ok is True
                        and np.array_equal(r.psdu_bits, sent[i]))]

    def same_fields(a, b):
        return all((x.ok, x.rate_mbps, x.length_bytes, x.crc_ok)
                   == (y.ok, y.rate_mbps, y.length_bytes, y.crc_ok)
                   and np.array_equal(x.psdu_bits, y.psdu_bits)
                   for x, y in zip(a, b))

    paths, results = {}, {}
    every = list(range(B))
    one_per_rate = list(range(8))            # capture k is at rate k % 8

    def path(name, fn, idx, want, equal_to=None):
        """Run one path counted; check every lane and that exactly the
        `want` launch counts are non-zero."""
        res, launches, ms, peak = counted(fn)
        results[name] = res
        paths[name] = dict(launches=launches, first_call_ms=ms,
                           peak_mem_bytes=peak, failed=wrong(res, idx))
        check(launches == {k: want.get(k, 0) for k in launches},
              f"{name}: launches {launches}, want {want}")
        if equal_to is not None:
            ref = results[equal_to]
            ref = ref if len(ref) == len(res) else [ref[k] for k in idx]
            paths[name]["equal_to"] = equal_to
            check(same_fields(res, ref),
                  f"{name} differs field for field from {equal_to}")

    def many(**knobs):
        return lambda: framebatch.receive_many(caps, check_fcs=True,
                                               device=dev, **knobs)

    def each(**knobs):
        def run():
            return [rx.receive(caps[k], check_fcs=True, device=dev, **knobs)
                    for k in one_per_rate]
        return run

    eight = len(one_per_rate)
    path("receive_many", many(), every, {"acs": 1, "traceback": 1})
    path("receive_many_fused", many(fused_demap=True), every,
         {"fused_mixed": 1, "traceback": 1}, "receive_many")
    path("receive_many_percapture_sco",
         many(batched_acquire=False, sco_track=True), every,
         {"acs": 1, "traceback": 1})
    per_capture_ms = {}
    for fused in (True, False):
        name = "receive_fused" if fused else "receive"
        times = {}

        def timed_each(fused=fused, times=times):
            out = []
            for k in one_per_rate:
                r, times[rates[k]] = host_ms(
                    lambda k=k: rx.receive(caps[k], check_fcs=True,
                                           fused_demap=fused, device=dev))
                out.append(r)
            return out
        path(name, timed_each, one_per_rate,
             {"fused_rate": eight, "traceback": eight} if fused else {},
             "receive_many")
        per_capture_ms[name] = times
    path("receive_many_radix4", many(viterbi_radix=4), every,
         {"acs_r4": 1, "traceback": 1}, "receive_many")
    path("receive_many_fused_radix4", many(fused_demap=True, viterbi_radix=4),
         every, {"fused_mixed_r4": 1, "traceback": 1}, "receive_many")
    for md, short in (("int16", "i16"), ("int8", "i8")):
        path(f"receive_many_{md}", many(viterbi_metric=md), every,
             {f"acs_{short}": 1, "traceback": 1})
        path(f"receive_many_{md}_radix4",
             many(viterbi_metric=md, viterbi_radix=4), every,
             {f"acs_{short}_r4": 1, "traceback": 1}, f"receive_many_{md}")
    path("receive_many_window", many(viterbi_window=WINDOW), every,
         {"acs": 1, "traceback": 1}, "receive_many")
    path("receive_radix4", each(viterbi_radix=4), one_per_rate,
         {"acs_r4": eight, "traceback": eight}, "receive_many")
    path("receive_int8", each(viterbi_metric="int8"), one_per_rate,
         {"acs_i8": eight, "traceback": eight}, "receive_many")
    path("receive_fused_radix4", each(fused_demap=True, viterbi_radix=4),
         one_per_rate, {"fused_rate_r4": eight, "traceback": eight},
         "receive_many")
    path("receive_int16", each(viterbi_metric="int16"), one_per_rate, {},
         "receive_many")
    correct = {p: (B if p.startswith("receive_many") else eight)
               - len(v["failed"]) for p, v in paths.items()}
    emit({"phase": "end_to_end", "frames": B, "psdu_bytes": PSDU_BYTES,
          "snr_db": SNR_DB, "correct": correct, "paths": paths})
    for p, v in paths.items():
        check(not v["failed"], f"{p}: lanes decoded wrongly: {v['failed']}")
    del results

    # ---- 5. the streaming receiver
    t_ph = time.perf_counter()
    stream_line, stream_launches, stream_checks = stream_phase(
        rng, dev, caps, sent, rates, card)
    t_ph = emit_timed(stream_line, t_ph)

    # ---- 6. the S-stream fleet, 7. the serving runtime
    fleet_line, fleet_launches, fleet_checks, fleet_wide = fleet_phase(
        rng, dev, card)
    t_ph = emit_timed(fleet_line, t_ph)
    serve_line, fleet_launches["serve"] = serve_phase(rng, dev, card)
    t_ph = emit_timed(serve_line, t_ph)

    # ---- 8. the loopback link, 9. the BER sweep, 10. the load generator
    link_line, link_launches, link_checks = link_phase(rng, dev, card)
    t_ph = emit_timed(link_line, t_ph)
    sweep_line, sweep_launches, sweep_run = sweep_phase(rng, dev, card)
    t_ph = emit_timed(sweep_line, t_ph)
    synth_line, synth_launches = synth_phase(rng, dev, card)
    t_ph = emit_timed(synth_line, t_ph)

    # ---- 11. the compiler
    compiler_line, compiler_launches, compiler_checks = compiler_phase(
        rng, dev, card)
    t_ph = emit_timed(compiler_line, t_ph)

    # ---- 12. frame batching, the packet search, the vectorizer
    batch_line, batch_launches, batch_checks = batch_phase(rng, dev, card)
    t_ph = emit_timed(batch_line, t_ph)
    compiler_launches.update(batch_launches)
    compiler_checks.update(batch_checks)

    # ---- 13. the fixed-point path
    fxp_line, fxp_launches, fxp_checks = fxp_phase(rng, dev, card)
    t_ph = emit_timed(fxp_line, t_ph)

    # ---- 14. the CLI surface, tracing, the observatory, the autotuner
    observe_line, observe_launches = observe_phase(rng, dev, card)
    t_ph = emit_timed(observe_line, t_ph)

    # ---- 15. the mesh
    mesh_line, mesh_launches = mesh_phase(rng, dev, card, fleet_wide,
                                          sweep_run)
    t_ph = emit_timed(dict(mesh_line, budget_s=MESH_BUDGET_S), t_ph)

    # ---- 16. the chaos-soak campaign, the windowed BER study
    soak_line, soak_launches, soak_checks = soak_phase(dev, card)
    soak_s = time.perf_counter() - t_ph
    t_ph = emit_timed(dict(soak_line, budget_s=SOAK_BUDGET_S), t_ph)
    check(soak_s <= SOAK_BUDGET_S,
          f"soak: {soak_s:.1f} s, over its {SOAK_BUDGET_S} s budget")

    # ---- 17. timing
    # receive_many in every decode mode, the modes in turns on one card
    modes = {"default": {}, "fused": {"fused_demap": True},
             "radix4": {"viterbi_radix": 4},
             "fused_radix4": {"fused_demap": True, "viterbi_radix": 4},
             "int16": {"viterbi_metric": "int16"},
             "int16_radix4": {"viterbi_metric": "int16", "viterbi_radix": 4},
             "int8": {"viterbi_metric": "int8"},
             "int8_radix4": {"viterbi_metric": "int8", "viterbi_radix": 4},
             "window": {"viterbi_window": WINDOW}}
    peak_of = {"default": "receive_many", "fused": "receive_many_fused",
               "radix4": "receive_many_radix4",
               "fused_radix4": "receive_many_fused_radix4",
               "int16": "receive_many_int16",
               "int16_radix4": "receive_many_int16_radix4",
               "int8": "receive_many_int8",
               "int8_radix4": "receive_many_int8_radix4",
               "window": "receive_many_window"}
    reps = 3
    total = dict.fromkeys(modes, 0.0)
    for _ in range(reps):
        for name, knobs in modes.items():
            _out, ms = host_ms(many(**knobs))
            total[name] += ms / reps
    batch = {name: {"receive_many_ms": ms, "frames_per_s": B / ms * 1e3,
                    "samples_per_s": n_samples / ms * 1e3,
                    "peak_mem_bytes": paths[peak_of[name]]["peak_mem_bytes"]}
             for name, ms in total.items()}

    # the steps of the default and fused decode paths one by one, and
    # each mode's decode step, each under CUDA events
    ph, ph_f, ph_m = {}, {}, {}
    with cplx.exact_fp32():
        out = {}

        def acquire():
            out["acq"] = rx.acquire_many(caps, device=dev)
        ph["acquire"] = ph_f["acquire"] = cuda_ms(acquire)
        _res, x_dev, acqs = out["acq"]
        n_sym_b = max(geometry.sym_bucket(a.n_sym) for _i, a in acqs)
        padded = pad_lanes(acqs)
        lanes = [a for _i, a in padded]

        def gather():
            out["segs"] = rx.gather_segments_many(x_dev, lanes, n_sym_b)
        ph["gather"] = ph_f["gather"] = cuda_ms(gather)
        ridx = [RATE_INDEX[a.rate_mbps] for a in lanes]
        nbits = [a.n_sym * RATES[a.rate_mbps].n_dbps for a in lanes]
        T = n_sym_b * MAX_DBPS
        npsdu = torch.tensor([8 * a.length_bytes for a in lanes],
                             device=dev)

        def front():
            out["llr"] = vc.pad_trellis(
                rx.mixed_front(out["segs"], ridx, nbits, n_sym_b))
        ph["front"] = cuda_ms(front)
        llr = out["llr"]

        def acs():
            out["acs"] = vc.acs(llr)
        ph["acs"] = cuda_ms(acs)

        def front_symbols():
            out["sym"] = rx._front_symbols(out["segs"], n_sym_b)
        ph_f["front_symbols"] = cuda_ms(front_symbols)
        sym, gain = out["sym"]

        def fused_acs():
            out["fused"] = vf.fused_acs_mixed(sym, gain, ridx, nbits)
        ph_f["fused_acs"] = cuda_ms(fused_acs)

        for steps, key in ((ph, "acs"), (ph_f, "fused")):
            def tb(key=key):
                out["bits"] = vc.traceback(*out[key])
            steps["traceback"] = cuda_ms(tb)

            def tail():
                bits = out["bits"][:, :T]
                clear = scramble.descramble_bits(
                    bits, scramble.recover_seed(bits[:, :7]))
                out["crc"] = rx.crc_psdu_many_graph(clear, npsdu)
            steps["descramble_crc"] = cuda_ms(tail)
            check(bool(out["crc"][:B].all()),
                  f"step-by-step walk ({key}) lost an FCS")
        del out["bits"], out["crc"]

        # each mode's decode step on the main path's own soft pairs
        q = {}
        for md in ("int16", "int8"):
            q[md], ph_m[f"quantize_{md}"] = cuda_timed(
                lambda md=md: vc._quantize_for(md, llr))
        for key, (md, radix) in MODES.items():
            x = llr if md == "float32" else q[md]
            ph_m[key] = cuda_ms(lambda x=x, md=md, radix=radix:
                                vc.acs(x, md, radix))
        ph_m["fused_mixed_r4"] = cuda_ms(
            lambda: vf.fused_acs_mixed(sym, gain, ridx, nbits, 4))
        # the windowed decode's steps: cut the windows (as
        # viterbi_decode_batch_windowed, with its _decode hook), the ACS
        # and traceback over the window lanes
        cut = {}

        def hook(x):
            cut["x"] = x
            return torch.zeros(x.shape[:2], dtype=torch.uint8, device=dev)
        _bits, ph_m["window_cut"] = cuda_timed(
            lambda: vc.viterbi_decode_batch_windowed(
                llr[:, :T], window=WINDOW, _decode=hook))
        wllr = vc.pad_trellis(cut.pop("x"))
        wres, ph_m["window_acs"] = cuda_timed(lambda: vc.acs(wllr))
        ph_m["window_traceback"] = cuda_ms(lambda: vc.traceback(*wres))
    emit({"phase": "timing", "card": card, "batch": B,
          "trellis_steps": int(llr.shape[1]), "reps": reps,
          "window": {"window": WINDOW,
                     "overlap": vc.DEFAULT_WINDOW_OVERLAP,
                     "lanes": int(wllr.shape[0]),
                     "steps": int(wllr.shape[1])},
          "capture_samples": n_samples, "receive_many": batch,
          "step_ms": {"unfused": ph, "fused": ph_f, "modes": ph_m},
          "receive_ms_per_rate": per_capture_ms})

    # each kernel at the main path's inputs, against its plain version:
    # the plain version runs once, under CUDA events, and its output is
    # held against the kernel's
    Bk, Tp = int(llr.shape[0]), int(llr.shape[1])
    stats = {}

    def measure(key, fn, plain, compare, nbytes, nops, shape, reps=5):
        stats[key] = held_to_plain(torch, f"{key} at the main path's inputs",
                                   fn, plain, compare, nbytes, nops, shape,
                                   reps)

    def stopped(key, st, nbytes, nops, chain_steps):
        """Record a kernel's stop steps `st` (max, mean), ns per step of
        its chain (`chain_steps` long) and the bound of the work it
        needed: `nbytes` read and written (every word written), `nops`
        operations up to each lane's stop."""
        b_ms, b_by = bound(nbytes, nops)
        stats[key].update(stop_step=st, bound_needed_ms=b_ms,
                          bound_needed_by=b_by,
                          ns_per_step=stats[key]["ms"] * 1e6 / chain_steps)

    def acs_stopped(key, x, nbytes, **mode):
        """stopped() for the ACS kernel, from its own run on `x`."""
        _dec, _met, stops = vc.acs_with_stops(x, **mode)
        st = check_stops(torch, stops, x, f"{key} at its path's inputs")
        stopped(key, st, nbytes, acs_ops_to(stops, vc.RENORM), st["max"])

    for key, (md, radix) in MODES.items():
        x = llr if md == "float32" else q[md]
        nbytes = acs_bytes(Bk, Tp, 4 if md == "float32" else 2)
        measure(key, lambda x=x, md=md, radix=radix: vc.acs(x, md, radix),
                lambda x=x, md=md, radix=radix: vc.acs_plain(
                    x, metric_dtype=md, radix=radix),
                same_acs, nbytes, acs_ops(Bk, Tp, vc.RENORM), [Bk, Tp])
        acs_stopped(key, x, nbytes, metric_dtype=md, radix=radix)
    # traceback (traceback_work): float32 metrics (the default path) and
    # int32 metrics (the int16 path's), timed
    dec, met = out["acs"]
    measure("traceback", lambda: vc.traceback(dec, met),
            lambda: vc.traceback_plain(dec, met), same_bits,
            *traceback_work(Bk, Tp), [Bk, Tp])
    dec_i, met_i = vc.acs(q["int16"], "int16", 2)
    stats["traceback"]["int32_metrics_ms"] = cuda_ms(
        lambda: vc.traceback(dec_i, met_i), reps=5)
    # the traceback must read every decision word, so the work it needs
    # is the whole bound; and on the fused path's words, which the fused
    # kernel writes as zeros past each frame's stop
    stats["traceback"].update(bound_needed_ms=stats["traceback"]["bound_ms"],
                              bound_needed_by=stats["traceback"]["bound_by"])
    dec_f, met_f = out["fused"]
    measure("traceback_fused", lambda: vc.traceback(dec_f, met_f),
            lambda: vc.traceback_plain(dec_f, met_f), same_bits,
            *traceback_work(Bk, Tp), [Bk, Tp])
    stats["traceback"]["fused_dec_zero_tail"] = stats.pop("traceback_fused")
    del dec_f, met_f
    del out["llr"], out["acs"], llr, dec, met, dec_i, met_i, q

    # the window path's ACS at its own inputs (13,824 lanes of 1,216
    # steps, most of them all erasures): the acs kernel again, reported
    # beside the kernels line
    w_b, w_t = int(wllr.shape[0]), int(wllr.shape[1])
    measure("window_acs", lambda: vc.acs(wllr), lambda: vc.acs_plain(wllr),
            same_acs, acs_bytes(w_b, w_t, 4), acs_ops(w_b, w_t, vc.RENORM),
            [w_b, w_t])
    acs_stopped("window_acs", wllr, acs_bytes(w_b, w_t, 4))
    del wllr, wres

    # the rate-switched fused kernel at receive_many(fused_demap=True)'s
    # inputs (mixed_fused_work). The work it needed: operations up to
    # each frame's stop, symbols up to its bits, every other input and
    # every word. Every frame must stop at the first boundary it can
    n_sym = int(sym.shape[1])
    mixed_bytes, mixed_ops, mixed_rest = mixed_fused_work(Bk, n_sym, Tp)
    mixed_ndbps = [RATES[RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    for radix, key in ((2, "fused_mixed"), (4, "fused_mixed_r4")):
        measure(key,
                lambda r=radix: vf.fused_acs_mixed(sym, gain, ridx, nbits, r),
                lambda r=radix: vf.fused_acs_mixed_plain(sym, gain, ridx,
                                                         nbits, r),
                same_acs, mixed_bytes, mixed_ops, [Bk, n_sym, Tp])
        *_got, stops = vf.fused_acs_mixed_with_stops(sym, gain, ridx, nbits,
                                                     radix)
        st = check_fused_stops(stops, nbits, vf.MIXED_UNROLL, Tp,
                               f"{key} at its path's inputs", every)
        stopped(key, st, symbol_bytes_to(stops, nbits, mixed_ndbps)
                + mixed_rest, acs_ops_to(stops, vf.MIXED_UNROLL)
                + int(stops.long().sum()) * 2 * FRONT_OPS_PER_SLOT,
                st["max"])
    del out["fused"], sym, gain, _got, stops

    # the known-rate fused kernel at each of rx.receive(fused_demap=True)'s
    # 8 launches (one lane, so one chain, each): times and bounds summed
    # over them, ns per step over the 8 chains' steps
    with cplx.exact_fp32():
        for radix, key in ((2, "fused_rate"), (4, "fused_rate_r4")):
            total_k = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            nbytes = nbytes_needed = nops = nops_needed = 0
            shapes, chain = [], []
            for k in one_per_rate:
                _r, acq = rx._acquire_frame(caps[k], device=dev)
                rate = RATES[acq.rate_mbps]
                nsb = geometry.sym_bucket(acq.n_sym)
                seg = rx._padded_segment(acq, nsb, dev)
                s1, g1 = rx._front_symbols(seg[None], nsb)
                x1 = vf.pad_symbols(s1, rate)
                nb1 = [acq.n_sym * rate.n_dbps]
                tp1 = int(x1.shape[1]) * rate.n_dbps
                cadence = vf.symbols_per_block(rate) * rate.n_dbps
                rest1 = 48 * 4 + 4 + 2 * rate.n_dbps * 16 + tp1 * 8 + 64 * 4
                b1 = int(x1.shape[1]) * SYMBOL_BYTES + rest1
                o1 = acs_ops(1, tp1, cadence) + tp1 * 2 * FRONT_OPS_PER_SLOT
                measure(key, lambda: vf.fused_acs_rate(x1, g1, rate, nb1,
                                                       radix),
                        lambda: vf.fused_acs_rate_plain(x1, g1, rate, nb1,
                                                        radix),
                        same_acs, b1, o1, [1, int(x1.shape[1]), tp1])
                *_got, st1 = vf.fused_acs_rate_with_stops(x1, g1, rate, nb1,
                                                          radix)
                check_fused_stops(st1, nb1, cadence, tp1,
                                  f"{key} at {rate.mbps} Mbps", [0])
                for f in total_k:
                    total_k[f] = (max if f == "max_abs_err" else
                                  sum)((total_k[f], stats[key][f]))
                nbytes += b1
                nbytes_needed += symbol_bytes_to(st1, nb1, [rate.n_dbps]) \
                    + rest1
                nops += o1
                nops_needed += acs_ops_to(st1, cadence) + \
                    int(st1[0]) * 2 * FRONT_OPS_PER_SLOT
                shapes.append(stats[key]["shape"])
                chain.append(int(st1[0]))
            b_ms, b_by = bound(nbytes, nops)
            stats[key] = dict(total_k, bound_ms=b_ms, bound_by=b_by,
                              shape=shapes)
            stopped(key, {"max": max(chain), "mean": float(np.mean(chain)),
                          "each": chain}, nbytes_needed, nops_needed,
                    sum(chain))
        del _got, st1

    launch_path = {"acs": "receive_many", "traceback": "receive_many",
                   "fused_mixed": "receive_many_fused",
                   "fused_rate": "receive_fused",
                   "acs_r4": "receive_many_radix4",
                   "acs_i16": "receive_many_int16",
                   "acs_i16_r4": "receive_many_int16_radix4",
                   "acs_i8": "receive_many_int8",
                   "acs_i8_r4": "receive_many_int8_radix4",
                   "fused_mixed_r4": "receive_many_fused_radix4",
                   "fused_rate_r4": "receive_fused_radix4"}
    kernels = []
    for name, (instance, replaces) in KERNELS.items():
        p = launch_path[name]
        kernels.append({
            "name": name, "kernel": instance, "route": "cuda",
            "source": "ziria_tpu_torch/csrc/viterbi.cu",
            "replaces": replaces, "path": p,
            "launches": paths[p]["launches"][name],
            "stream_launches": {sn: sl[name]
                                for sn, sl in stream_launches.items()},
            "stream_shapes": {sn: sc[name] for sn, sc in stream_checks.items()
                              if name in sc},
            "fleet_launches": {fn: fl[name]
                               for fn, fl in fleet_launches.items()},
            "fleet_shapes": {fn: fc[name] for fn, fc in fleet_checks.items()
                             if name in fc},
            "link_launches": {ln: ll[name]
                              for ln, ll in link_launches.items()},
            "link_shapes": {ln: lc[name] for ln, lc in link_checks.items()
                            if name in lc},
            "sweep_launches": sweep_launches[name],
            "synth_launches": synth_launches[name],
            "compiler_launches": {cn: cl.get(name, 0)
                                  for cn, cl in compiler_launches.items()},
            "compiler_shapes": {cn: cc[name] for cn, cc in
                                compiler_checks.items() if name in cc},
            "fxp_launches": {xn: xl.get(name, 0)
                             for xn, xl in fxp_launches.items()},
            "fxp_shapes": {xn: xc[name] for xn, xc in fxp_checks.items()
                           if name in xc},
            "observe_launches": {on: ol.get(name, 0)
                                 for on, ol in observe_launches.items()},
            "mesh_launches": {mn: ml.get(name, 0)
                              for mn, ml in mesh_launches.items()},
            "soak_launches": {sn: sl.get(name, 0)
                              for sn, sl in soak_launches.items()},
            "soak_shapes": ({"soak_warm": soak_checks[name]}
                            if name in soak_checks else {}),
            "parity": "bitwise equal to plain", **stats[name],
            "parity_max_abs_err": parity[name], "library_ms": None,
            "card": card})
    emit({"window_acs": dict(stats["window_acs"], path="receive_many_window",
                             launches=paths["receive_many_window"]
                             ["launches"]["acs"], card=card)})
    emit({"kernels": kernels})
    emit({"wall_s": time.perf_counter() - wall0})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
