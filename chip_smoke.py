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
5. timing: ``receive_many`` in every decode mode, the modes in turns
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

Then a ``{"kernels": [...]}`` line, the script's wall time, the
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
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores (integer adds are
# counted at the same rate)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
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
    HBM rate and the operations over the float32 rate."""
    tb_, to = nbytes / HBM_BYTES_S * 1e3, nops / F32_OPS_S * 1e3
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


def acs_bytes(b, tp, in_bytes):
    """ACS bytes: soft pairs in (`in_bytes` per value), one 8-byte
    decision word per step and 64 4-byte metrics out."""
    return b * tp * 2 * in_bytes + b * tp * 8 + b * 64 * 4


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

    # ---- 5. timing
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
        got = fn()
        want, plain_ms = cuda_timed(plain)
        err = compare(torch, got, want, f"{key} at the main path's inputs")
        del got, want
        b_ms, b_by = bound(nbytes, nops)
        stats[key] = dict(max_abs_err=err, ms=cuda_ms(fn, reps=reps),
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          shape=shape)

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
    # traceback: 4 integer operations per step, plus the 63-compare
    # argmax, counted at the float32 rate; float32 metrics (the default
    # path) and int32 metrics (the int16 path's), timed
    dec, met = out["acs"]
    measure("traceback", lambda: vc.traceback(dec, met),
            lambda: vc.traceback_plain(dec, met), same_bits,
            Bk * Tp * 8 + Bk * 64 * 4 + Bk * Tp, Bk * (Tp * 4 + 63),
            [Bk, Tp])
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
            Bk * Tp * 8 + Bk * 64 * 4 + Bk * Tp, Bk * (Tp * 4 + 63),
            [Bk, Tp])
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
    # inputs: symbols, gains, bit counts and rate rows in (ridx and the
    # 8-rate bank of (2 * 216) 16-byte slot rows, n_dbps and norms);
    # decisions and metrics out; the ACS plus the front's per-slot work.
    # The work it needed: operations up to each frame's stop, symbols up
    # to its bits, every other input and every word. Every frame must
    # stop at the first boundary it can
    n_sym = int(sym.shape[1])
    mixed_rest = (Bk * 48 * 4 + Bk * 4 * 2 + 8 * 2 * MAX_DBPS * 16
                  + 8 * 4 * 2 + Bk * Tp * 8 + Bk * 64 * 4)
    mixed_bytes = Bk * n_sym * SYMBOL_BYTES + mixed_rest
    mixed_ndbps = [RATES[RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    mixed_ops = acs_ops(Bk, Tp, vf.MIXED_UNROLL) + \
        Bk * Tp * 2 * FRONT_OPS_PER_SLOT
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
