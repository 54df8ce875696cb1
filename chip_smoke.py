#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ziria_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. device: requires CUDA (exits non-zero without it), turns TF32 off for
   matmuls and convolutions, reports the card;
2. build: compiles every CUDA source under ziria_tpu_torch/csrc/ with
   nvcc for sm_90a, one nvcc per source, all started together;
3. kernel_parity: every kernel against its plain PyTorch version on the
   card: the ACS and traceback kernels at B=128, T=8192 on random soft
   inputs with an all-erasure lane and erasure tails; the rate-switched
   fused kernel at B=128, 64 symbols, all 8 rates, random bit counts
   with an all-erasure lane and a lane ending inside a symbol; the
   known-rate fused kernel at each rate, B=128, the same. Decisions,
   final metrics (as int32 bit patterns) and traceback bits bitwise
   equal;
4. end_to_end: 128 captures, 16 at each of the 8 rates, each a
   1000-byte PSDU (996 random bytes + FCS) behind a random offset, with
   a random CFO and AWGN at 25 dB, made by the port's TX and a seeded
   numpy channel. Five paths, each with every launch count zeroed just
   before it and read just after:
   a. ``receive_many(check_fcs=True)``: ACS and traceback kernels;
   b. ``receive_many(check_fcs=True, fused_demap=True)``: one
      rate-switched fused launch, no ACS launch, one traceback; field
      for field equal to (a);
   c. ``receive_many(check_fcs=True, batched_acquire=False,
      sco_track=True)``;
   d. one capture per rate through ``rx.receive(check_fcs=True,
      fused_demap=True)``: 8 known-rate fused launches, equal to (a);
   e. the same 8 through the default ``rx.receive`` (the scan decoder,
      no kernel), equal again.
   Every lane must come back ok with its rate, length, payload bits
   and a good FCS;
5. timing: ``receive_many`` unfused and fused in turns (batch ms,
   frames/s, samples/s, peak device memory); CUDA-event times of each
   step of both decode paths; per-capture ``receive`` ms per rate,
   fused and default; then each kernel at the main path's own inputs
   beside its plain version (held bitwise equal there too) and its
   bound.

Then a ``{"kernels": [...]}`` line, the nvidia-smi name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any
failed check raises, and the script exits non-zero without that line.
It imports nothing of JAX or of the JAX package.
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
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float operations per depunctured slot of the fused front: x * norm,
# |x|, up to three for the level formula, * gain, * valid, the mask
FRONT_OPS_PER_SLOT = 8


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
    """Random soft pairs with an all-erasure lane and erasure tails."""
    llr = (rng.normal(size=(b, t, 2)) * 2.0).astype(np.float32)
    llr[3] = 0.0
    for k in range(8, b, 8):
        llr[k, int(rng.integers(t // 4, t)):] = 0.0
    return llr


def fused_parity_inputs(rng, ndbps, n_sym):
    """Random equalized symbols (len(ndbps), n_sym, 48, 2) and gains
    (one nulled subcarrier), and bit counts: random, with lane 0 all
    erasures and lane 1 ending inside a symbol."""
    b = len(ndbps)
    data = rng.normal(0, 0.7, (b, n_sym, 48, 2)).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, (b, 48)).astype(np.float32)
    gain[:, 7] = 0.0
    nbits = rng.integers(0, n_sym * np.asarray(ndbps) + 1).astype(np.int32)
    nbits[0] = 0
    nbits[1] = (n_sym // 2) * ndbps[1] + ndbps[1] // 3
    return data, gain, nbits


def run_both(torch, vc, llr):
    """Kernels and plain versions on the same card inputs, held bitwise
    equal; returns the largest absolute difference of the ACS outputs
    (decisions, metrics) and of the traceback bits."""
    dec, met = vc.acs(llr)
    bits = vc.traceback(dec, met)
    dec_p, met_p = vc.acs_plain(llr)
    bits_p = vc.traceback_plain(dec, met)
    torch.cuda.synchronize()
    check(torch.equal(dec, dec_p), "ACS decisions differ from plain")
    check(torch.equal(met.view(torch.int32), met_p.view(torch.int32)),
          "ACS final metrics are not bitwise equal to plain")
    check(torch.equal(bits, bits_p), "traceback bits differ from plain")
    err_acs = max(float((met - met_p).abs().max()),
                  float((dec.int() - dec_p.int()).abs().max()))
    err_tb = float((bits.int() - bits_p.int()).abs().max())
    return err_acs, err_tb


def same_acs(torch, got, want, what: str) -> float:
    """Fused kernel outputs against their plain version's: decisions and
    final metrics bitwise equal. Returns the largest absolute
    difference."""
    (dec, met), (dec_p, met_p) = got, want
    torch.cuda.synchronize()
    check(torch.equal(dec, dec_p), f"{what}: decisions differ from plain")
    check(torch.equal(met.view(torch.int32), met_p.view(torch.int32)),
          f"{what}: final metrics are not bitwise equal to plain")
    return max(float((met - met_p).abs().max()),
               float((dec.int() - dec_p.int()).abs().max()))


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    tb_, to = nbytes / HBM_BYTES_S * 1e3, nops / F32_OPS_S * 1e3
    return (tb_, "bytes") if tb_ >= to else (to, "operations")


def acs_ops(b, tp, cadence):
    """ACS operations: per state and step 4 adds, 1 compare, 1 select,
    plus the renorm's max and subtract every `cadence` steps."""
    return b * tp * 64 * 6 + b * (tp // cadence) * 64 * 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)

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
    err_acs, err_tb = run_both(torch, vc, llr)
    del llr

    def fused_parity(got, want, what):
        err = same_acs(torch, got, want, what)
        bits, bits_p = vc.traceback(*got), vc.traceback_plain(*want)
        torch.cuda.synchronize()
        check(torch.equal(bits, bits_p), f"{what}: bits differ from plain")
        return err

    ridx = np.arange(B) % 8
    ndbps = [RATES[RATE_MBPS_ORDER[r]].n_dbps for r in ridx]
    d, g, nb = (torch.from_numpy(a).to(dev)
                for a in fused_parity_inputs(rng, ndbps, PARITY_SYM))
    err_mixed = fused_parity(vf.fused_acs_mixed(d, g, ridx, nb),
                             vf.fused_acs_mixed_plain(d, g, ridx, nb),
                             "fused_acs_mixed_kernel")
    err_rate = {}
    for m in RATE_MBPS_ORDER:
        rate = RATES[m]
        n_sym = -(-PARITY_SYM // vf.symbols_per_block(rate)) * \
            vf.symbols_per_block(rate)
        d, g, nb = (torch.from_numpy(a).to(dev) for a in
                    fused_parity_inputs(rng, [rate.n_dbps] * B, n_sym))
        err_rate[m] = fused_parity(vf.fused_acs_rate(d, g, rate, nb),
                                   vf.fused_acs_rate_plain(d, g, rate, nb),
                                   f"fused_acs_rate_kernel at {m} Mbps")
    del d, g, nb
    emit({"phase": "kernel_parity", "B": B, "T": PARITY_T,
          "fused_symbols": PARITY_SYM, "acs_equal": True,
          "traceback_equal": True, "fused_mixed_equal": True,
          "fused_rate_equal": True,
          "max_abs_err": {"acs": err_acs, "traceback": err_tb,
                          "fused_mixed": err_mixed,
                          "fused_rate": max(err_rate.values())}})

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
        launches = {"acs_f32_kernel": vc.LAUNCHES["acs"],
                    "traceback_kernel": vc.LAUNCHES["traceback"],
                    "fused_acs_mixed_kernel": vf.LAUNCHES["fused_mixed"],
                    "fused_acs_rate_kernel": vf.LAUNCHES["fused_rate"]}
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

    paths = {}
    every = list(range(B))
    one_per_rate = list(range(8))            # capture k is at rate k % 8
    res, launches, ms, peak = counted(
        lambda: framebatch.receive_many(caps, check_fcs=True, device=dev))
    paths["receive_many"] = dict(launches=launches, first_call_ms=ms,
                                 peak_mem_bytes=peak, failed=wrong(res, every))
    check(launches["acs_f32_kernel"] > 0 and launches["traceback_kernel"] > 0,
          f"receive_many: a kernel of the path was not launched: {launches}")
    res_f, launches, ms, peak = counted(
        lambda: framebatch.receive_many(caps, check_fcs=True, device=dev,
                                        fused_demap=True))
    paths["receive_many_fused"] = dict(
        launches=launches, first_call_ms=ms, peak_mem_bytes=peak,
        failed=wrong(res_f, every), equal_to_unfused=same_fields(res_f, res))
    check(launches["fused_acs_mixed_kernel"] == 1
          and launches["acs_f32_kernel"] == 0
          and launches["traceback_kernel"] == 1,
          f"receive_many(fused_demap=True) launches: {launches}")
    check(paths["receive_many_fused"]["equal_to_unfused"],
          "receive_many(fused_demap=True) differs from the unfused run")
    res_p, launches, ms, peak = counted(
        lambda: framebatch.receive_many(caps, check_fcs=True, device=dev,
                                        batched_acquire=False,
                                        sco_track=True))
    paths["receive_many_percapture_sco"] = dict(
        launches=launches, first_call_ms=ms, peak_mem_bytes=peak,
        failed=wrong(res_p, every))
    check(launches["acs_f32_kernel"] > 0 and launches["traceback_kernel"] > 0,
          f"receive_many(batched_acquire=False, sco_track=True): {launches}")
    per_capture_ms = {}
    for fused in (True, False):
        name = "receive_fused" if fused else "receive"
        times = {}

        def each():
            out = []
            for k in one_per_rate:
                r, times[rates[k]] = host_ms(
                    lambda k=k: rx.receive(caps[k], check_fcs=True,
                                           fused_demap=fused, device=dev))
                out.append(r)
            return out
        res_r, launches, ms, peak = counted(each)
        per_capture_ms[name] = times
        paths[name] = dict(
            launches=launches, peak_mem_bytes=peak,
            failed=wrong(res_r, one_per_rate),
            equal_to_receive_many=same_fields(
                res_r, [res[k] for k in one_per_rate]))
        check(paths[name]["equal_to_receive_many"],
              f"{name} differs from receive_many")
        if fused:
            check(launches["fused_acs_rate_kernel"] == len(one_per_rate)
                  and launches["traceback_kernel"] == len(one_per_rate)
                  and launches["acs_f32_kernel"] == 0,
                  f"receive(fused_demap=True) launches: {launches}")
        else:
            check(not any(launches.values()),
                  f"the default receive launched a kernel: {launches}")
    correct = {p: (B if p.startswith("receive_many") else len(one_per_rate))
               - len(v["failed"]) for p, v in paths.items()}
    emit({"phase": "end_to_end", "frames": B, "psdu_bytes": PSDU_BYTES,
          "snr_db": SNR_DB, "correct": correct, "paths": paths})
    for p, v in paths.items():
        check(not v["failed"], f"{p}: lanes decoded wrongly: {v['failed']}")

    # ---- 5. timing
    # receive_many unfused and fused in turns on the same card
    reps = 3
    total = {"unfused": 0.0, "fused": 0.0}
    for _ in range(reps):
        for name, fused in (("unfused", False), ("fused", True)):
            _out, ms = host_ms(lambda: framebatch.receive_many(
                caps, check_fcs=True, device=dev, fused_demap=fused))
            total[name] += ms / reps
    batch = {name: {"receive_many_ms": ms, "frames_per_s": B / ms * 1e3,
                    "samples_per_s": n_samples / ms * 1e3,
                    "peak_mem_bytes": paths["receive_many_fused" if
                                            name == "fused" else
                                            "receive_many"]["peak_mem_bytes"]}
             for name, ms in total.items()}

    # the steps of both decode paths one by one, each under CUDA events
    ph, ph_f = {}, {}
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
    emit({"phase": "timing", "card": card, "batch": B,
          "trellis_steps": int(llr.shape[1]), "reps": reps,
          "capture_samples": n_samples, "receive_many": batch,
          "step_ms": {"unfused": ph, "fused": ph_f},
          "receive_ms_per_rate": per_capture_ms})

    # each kernel at the main path's inputs, against its plain version
    Bk, Tp = int(llr.shape[0]), int(llr.shape[1])
    dec, met = out["acs"]
    err_acs, err_tb = run_both(torch, vc, llr)
    acs_ms = cuda_ms(lambda: vc.acs(llr), reps=5)
    tb_ms = cuda_ms(lambda: vc.traceback(dec, met), reps=5)
    acs_plain_ms = cuda_ms(lambda: vc.acs_plain(llr))
    tb_plain_ms = cuda_ms(lambda: vc.traceback_plain(dec, met))
    del out["llr"], out["acs"], llr, dec, met
    # bounds: each input read once and each output written once over the
    # HBM rate, against the operations over the float32 rate (traceback:
    # 4 integer operations per step, plus the 63-compare argmax, counted
    # at the float32 rate)
    acs_bytes = Bk * Tp * 2 * 4 + Bk * Tp * 8 + Bk * 64 * 4
    tb_bytes = Bk * Tp * 8 + Bk * 64 * 4 + Bk * Tp
    tb_ops = Bk * (Tp * 4 + 63)

    # the rate-switched fused kernel at receive_many(fused_demap=True)'s
    # inputs: symbols, gains, bit counts and rate rows in (ridx and the
    # 8-rate bank of (2 * 216) 16-byte slot rows, n_dbps and norms);
    # decisions and metrics out; the ACS plus the front's per-slot work
    n_sym = int(sym.shape[1])
    got = vf.fused_acs_mixed(sym, gain, ridx, nbits)
    want = vf.fused_acs_mixed_plain(sym, gain, ridx, nbits)
    err_mixed = same_acs(torch, got, want, "fused_acs_mixed_kernel")
    del got, want
    mixed_ms = cuda_ms(lambda: vf.fused_acs_mixed(sym, gain, ridx, nbits),
                       reps=5)
    mixed_plain_ms = cuda_ms(
        lambda: vf.fused_acs_mixed_plain(sym, gain, ridx, nbits))
    mixed_bytes = (Bk * n_sym * 96 * 4 + Bk * 48 * 4 + Bk * 4 * 2
                   + 8 * 2 * MAX_DBPS * 16 + 8 * 4 * 2
                   + Bk * Tp * 8 + Bk * 64 * 4)
    mixed_ops = acs_ops(Bk, Tp, vf.MIXED_UNROLL) + \
        Bk * Tp * 2 * FRONT_OPS_PER_SLOT
    del out["fused"], sym, gain

    # the known-rate fused kernel at each of rx.receive(fused_demap=True)'s
    # 8 launches (one lane each): times and bounds summed over them
    rate_ms = rate_plain_ms = rate_bytes = rate_ops = 0.0
    rate_shapes, err_rate = [], 0.0
    with cplx.exact_fp32():
        for k in one_per_rate:
            _r, acq = rx._acquire_frame(caps[k], device=dev)
            rate = RATES[acq.rate_mbps]
            nsb = geometry.sym_bucket(acq.n_sym)
            seg = rx._padded_segment(acq, nsb, dev)
            s1, g1 = rx._front_symbols(seg[None], nsb)
            x1 = vf.pad_symbols(s1, rate)
            nb1 = [acq.n_sym * rate.n_dbps]
            err_rate = max(err_rate, same_acs(
                torch, vf.fused_acs_rate(x1, g1, rate, nb1),
                vf.fused_acs_rate_plain(x1, g1, rate, nb1),
                f"fused_acs_rate_kernel at {rate.mbps} Mbps"))
            rate_ms += cuda_ms(lambda: vf.fused_acs_rate(x1, g1, rate, nb1),
                               reps=5)
            rate_plain_ms += cuda_ms(
                lambda: vf.fused_acs_rate_plain(x1, g1, rate, nb1))
            tp1 = int(x1.shape[1]) * rate.n_dbps
            cadence = vf.symbols_per_block(rate) * rate.n_dbps
            rate_bytes += (int(x1.shape[1]) * 96 * 4 + 48 * 4 + 4
                           + 2 * rate.n_dbps * 16 + tp1 * 8 + 64 * 4)
            rate_ops += acs_ops(1, tp1, cadence) + \
                tp1 * 2 * FRONT_OPS_PER_SLOT
            rate_shapes.append([1, int(x1.shape[1]), tp1])

    kernels = []
    for (name, replaces, path, err, ms, plain, nbytes, nops, shape) in (
            ("acs_f32_kernel", "ziria_tpu/ops/viterbi_pallas.py:332",
             "receive_many", err_acs, acs_ms, acs_plain_ms, acs_bytes,
             acs_ops(Bk, Tp, vc.RENORM), [Bk, Tp]),
            ("traceback_kernel", "ziria_tpu/ops/viterbi_pallas.py:517",
             "receive_many", err_tb, tb_ms, tb_plain_ms, tb_bytes, tb_ops,
             [Bk, Tp]),
            ("fused_acs_mixed_kernel", "ziria_tpu/ops/viterbi_pallas.py:1174",
             "receive_many_fused", err_mixed, mixed_ms, mixed_plain_ms,
             mixed_bytes, mixed_ops, [Bk, n_sym, Tp]),
            ("fused_acs_rate_kernel", "ziria_tpu/ops/viterbi_pallas.py:893",
             "receive_fused", err_rate, rate_ms, rate_plain_ms, rate_bytes,
             rate_ops, rate_shapes)):
        b_ms, b_by = bound(nbytes, nops)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ziria_tpu_torch/csrc/viterbi.cu",
            "replaces": replaces, "path": path,
            "launches": paths[path]["launches"][name],
            "max_abs_err": err, "parity": "bitwise equal to plain",
            "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shape, "card": card})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
