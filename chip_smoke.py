#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ziria_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. device: requires CUDA (exits non-zero without it), turns TF32 off for
   matmuls and convolutions, reports the card;
2. build: compiles every CUDA source under ziria_tpu_torch/csrc/ with
   nvcc for sm_90a, one nvcc per source, all started together;
3. kernel_parity: the ACS and traceback kernels against their plain
   PyTorch versions at B=128, T=8192 on random soft inputs with an
   all-erasure lane and erasure tails: decisions, final metrics and
   bits bitwise equal;
4. end_to_end: 128 captures, 16 at each of the 8 rates, each a
   1000-byte PSDU (996 random bytes + FCS) behind a random offset, with
   a random CFO and AWGN at 25 dB, made by the port's TX and a seeded
   numpy channel, through ``receive_many(..., check_fcs=True)`` on the
   card. Every lane must come back ok with its rate, length, payload
   bits and a good FCS, and both kernels must have been launched
   during this run (their launch counts are zeroed just before it);
5. timing: CUDA-event times of the acquire, gather, front, ACS,
   traceback and descramble+CRC steps; receive_many's total, frames/s,
   samples/s and peak device memory; then each kernel at the main
   path's own inputs beside its plain version (held bitwise equal
   there too) and its bound.

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
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


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
    from ziria_tpu_torch.ops import cplx, scramble, viterbi_cuda as vc
    from ziria_tpu_torch.phy.wifi import rx
    from ziria_tpu_torch.utils import geometry
    from ziria_tpu_torch.utils.dispatch import pad_lanes
    from ziria_tpu_torch.phy.wifi.params import MAX_DBPS, RATE_INDEX, \
        RATES

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

    # ---- 3. kernel parity at B=128, T=8192
    rng = np.random.default_rng(args.seed)
    llr = torch.from_numpy(parity_inputs(rng, B, PARITY_T)).to(dev)
    err_acs, err_tb = run_both(torch, vc, llr)
    emit({"phase": "kernel_parity", "B": B, "T": PARITY_T,
          "acs_equal": True, "traceback_equal": True,
          "max_abs_err": {"acs": err_acs, "traceback": err_tb}})

    # ---- 4. end to end, the counted main-path run
    caps, sent, rates = make_captures(rng, dev)
    n_samples = sum(c.shape[0] for c in caps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vc.reset_launches()
    t0 = time.perf_counter()
    res = framebatch.receive_many(caps, check_fcs=True, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(vc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    bad = [i for i, (r, want, m) in enumerate(zip(res, sent, rates))
           if not (r.ok and r.rate_mbps == m
                   and r.length_bytes == PSDU_BYTES and r.crc_ok is True
                   and np.array_equal(r.psdu_bits, want))]
    emit({"phase": "end_to_end", "frames": B, "psdu_bytes": PSDU_BYTES,
          "snr_db": SNR_DB, "correct": B - len(bad), "failed_lanes": bad,
          "launches": launches, "first_call_s": first_s})
    check(not bad, f"{len(bad)} of {B} lanes decoded wrongly: {bad[:8]}")

    # ---- 5. timing
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        framebatch.receive_many(caps, check_fcs=True, device=dev)
    torch.cuda.synchronize()
    total_s = (time.perf_counter() - t0) / reps

    # the same steps one by one, each under CUDA events
    ph = {}
    with cplx.exact_fp32():
        out = {}

        def acquire():
            out["acq"] = rx.acquire_many(caps, device=dev)
        ph["acquire"] = cuda_ms(acquire)
        _res, x_dev, acqs = out["acq"]
        n_sym_b = max(geometry.sym_bucket(a.n_sym) for _i, a in acqs)
        padded = pad_lanes(acqs)
        lanes = [a for _i, a in padded]

        def gather():
            out["segs"] = rx.gather_segments_many(x_dev, lanes, n_sym_b)
        ph["gather"] = cuda_ms(gather)
        ridx = [RATE_INDEX[a.rate_mbps] for a in lanes]
        nbits = [a.n_sym * RATES[a.rate_mbps].n_dbps for a in lanes]

        def front():
            out["llr"] = vc.pad_trellis(
                rx.mixed_front(out["segs"], ridx, nbits, n_sym_b))
        ph["front"] = cuda_ms(front)
        llr = out["llr"]

        def acs():
            out["acs"] = vc.acs(llr)
        ph["acs"] = cuda_ms(acs)

        def tb():
            out["bits"] = vc.traceback(*out["acs"])
        ph["traceback"] = cuda_ms(tb)
        T = n_sym_b * MAX_DBPS
        npsdu = torch.tensor([8 * a.length_bytes for a in lanes],
                             device=dev)

        def tail():
            bits = out["bits"][:, :T]
            clear = scramble.descramble_bits(
                bits, scramble.recover_seed(bits[:, :7]))
            out["crc"] = rx.crc_psdu_many_graph(clear, npsdu)
        ph["descramble_crc"] = cuda_ms(tail)
    check(bool(out["crc"][:B].all()), "step-by-step walk lost an FCS")
    emit({"phase": "timing", "card": card, "batch": B,
          "trellis_steps": int(llr.shape[1]), "step_ms": ph,
          "receive_many_ms": total_s * 1e3, "reps": reps,
          "frames_per_s": B / total_s, "samples_per_s": n_samples / total_s,
          "capture_samples": n_samples, "peak_mem_bytes": peak})

    # each kernel at the main path's inputs, against its plain version
    Bk, Tp = int(llr.shape[0]), int(llr.shape[1])
    dec, met = out["acs"]
    err_acs, err_tb = run_both(torch, vc, llr)
    acs_ms = cuda_ms(lambda: vc.acs(llr), reps=5)
    tb_ms = cuda_ms(lambda: vc.traceback(dec, met), reps=5)
    acs_plain_ms = cuda_ms(lambda: vc.acs_plain(llr))
    tb_plain_ms = cuda_ms(lambda: vc.traceback_plain(dec, met))
    # bounds: each input read once and each output written once over the
    # HBM rate, against the operations over the float32 rate (ACS: per
    # state and step 4 adds, 1 compare, 1 select, plus the renorm's max
    # and subtract every 64 steps; traceback: 4 integer operations per
    # step, plus the 63-compare argmax, counted at the float32 rate)
    acs_bytes = Bk * Tp * 2 * 4 + Bk * Tp * 8 + Bk * 64 * 4
    acs_ops = Bk * Tp * 64 * 6 + Bk * (Tp // 64) * 64 * 2
    tb_bytes = Bk * Tp * 8 + Bk * 64 * 4 + Bk * Tp
    tb_ops = Bk * (Tp * 4 + 63)

    def bound(nbytes, nops):
        tb_, to = nbytes / HBM_BYTES_S * 1e3, nops / F32_OPS_S * 1e3
        return (tb_, "bytes") if tb_ >= to else (to, "operations")

    kernels = []
    for name, replaces, err, ms, plain, nb, no in (
            ("acs_f32_kernel", "ziria_tpu/ops/viterbi_pallas.py:332",
             err_acs, acs_ms, acs_plain_ms, acs_bytes, acs_ops),
            ("traceback_kernel", "ziria_tpu/ops/viterbi_pallas.py:517",
             err_tb, tb_ms, tb_plain_ms, tb_bytes, tb_ops)):
        b_ms, b_by = bound(nb, no)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ziria_tpu_torch/csrc/viterbi.cu",
            "replaces": replaces,
            "launches": launches["acs" if name.startswith("acs")
                                 else "traceback"],
            "max_abs_err": err, "parity": "bitwise equal to plain",
            "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [Bk, Tp], "card": card})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
