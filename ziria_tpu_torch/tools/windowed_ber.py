"""BER study: the windowed Viterbi decode against the exact one
(counterpart of the repo's ``tools/windowed_ber.py``).

The windowed decoder's accuracy rests on the truncated-traceback
argument (the survivors of the K=7 code merge within ~5-10 constraint
lengths). The study measures that claim where it could fail, at low
SNR: it decodes the same noisy terminated frames exactly and windowed
(window 512, overlaps 32, 64 and 96) at LLR amplitudes 0.5-1.2, and
reports the BER of each and how often the windowed decode disagrees
with the exact one.

The exact decode is the scan decoder (``ops/viterbi.viterbi_decode``).
The windowed decode is ``viterbi_cuda.viterbi_decode_batch_windowed``:
on the card through the ACS and traceback kernels, on the CPU with the
scan decoder in its ``_decode`` hook, as the reference runs it.

    python -m ziria_tpu_torch.tools.windowed_ber [--device cpu]

prints one JSON object.
"""

from __future__ import annotations

import json
import sys

import numpy as np

SEED = 2026
N_FRAMES, N_BITS = 16, 4096
WINDOW = 512
OVERLAPS = (32, 64, 96)
AMPS = (0.5, 0.7, 0.9, 1.2)


def make_coded_frames(rng, n_frames, n_bits, amp):
    """Terminated K=7 frames and AWGN LLRs at amplitude ``amp``: the
    study's signal. Returns (msgs (F, n) uint8, llrs (F, n, 2)
    float32), the reference's for the same generator."""
    import torch

    from ziria_tpu_torch.ops import coding

    msgs, llrs = [], []
    for _ in range(n_frames):
        bits = rng.integers(0, 2, n_bits).astype(np.uint8)
        bits[-coding.K + 1:] = 0          # zero-tail termination
        coded = coding.conv_encode(torch.from_numpy(bits)).numpy() \
            .astype(np.float32)
        llr = (2.0 * coded - 1.0) * amp + rng.normal(0, 1.0, coded.size)
        msgs.append(bits)
        llrs.append(llr.astype(np.float32).reshape(-1, 2))
    return np.stack(msgs), np.stack(llrs)


def points(n_frames: int = N_FRAMES, n_bits: int = N_BITS):
    """The study's frames, amplitude by amplitude from one generator
    seeded with SEED: yields (amp, msgs, llrs)."""
    rng = np.random.default_rng(SEED)
    for amp in AMPS:
        yield (amp, *make_coded_frames(rng, n_frames, n_bits, amp))


def scan_engine(x):
    """The exact decode of a (B, T, 2) batch: the scan decoder."""
    from ziria_tpu_torch.ops import viterbi
    return viterbi.viterbi_decode(x)


def plain_engine(x):
    """The batch decode of a (B, T, 2) batch through the kernels' plain
    versions (``acs_plain``, ``traceback_plain``)."""
    from ziria_tpu_torch.ops import viterbi_cuda as vc
    return vc.traceback_plain(*vc.acs_plain(vc.pad_trellis(x)))[
        :, :x.shape[1]]


def windowed(llrs, overlap: int, window: int = WINDOW, _decode=None):
    """The windowed decode of a (B, T, 2) batch; `_decode` None takes
    the batch decode (the kernels on the card, their plain versions on
    the CPU)."""
    from ziria_tpu_torch.ops import viterbi_cuda

    # ziria: lint-ignore[R3] a study harness, not a serving site: its caller times the study whole, and a site here would join the program observatory's discovered sites
    return viterbi_cuda.viterbi_decode_batch_windowed(
        llrs, window=window, overlap=overlap, _decode=_decode)


def main(device="cuda", n_frames: int = N_FRAMES,
         n_bits: int = N_BITS) -> dict:
    """Run the study on `device` and return its table: the windowed
    decodes through the kernels on the card, with the scan decoder in
    their ``_decode`` hook on the CPU."""
    import torch

    dev = torch.device(device)
    cpu = dev.type == "cpu"
    _decode = scan_engine if cpu else None
    out = {"n_bits": n_bits, "n_frames": n_frames, "window": WINDOW,
           "device": str(dev),
           "engine": ("scan decoder via _decode" if cpu
                      else "ACS and traceback kernels"),
           "points": []}
    for amp, msgs, llrs in points(n_frames, n_bits):
        x = torch.from_numpy(llrs).to(dev)
        exact = scan_engine(x).cpu().numpy()
        total = msgs.size
        point = {"llr_amp": amp,
                 "ber_exact": int((exact != msgs).sum()) / total,
                 "overlaps": {}}
        for overlap in OVERLAPS:
            win = windowed(x, overlap, _decode=_decode).cpu().numpy()
            point["overlaps"][str(overlap)] = {
                "ber": int((win != msgs).sum()) / total,
                "disagree_vs_exact": int((win != exact).sum()) / total}
        out["points"].append(point)
        print(f"[ber] amp={amp}: exact {point['ber_exact']:.2e}, "
              + ", ".join(f"ov{o}: {v['ber']:.2e} "
                          f"(diff {v['disagree_vs_exact']:.2e})"
                          for o, v in point["overlaps"].items()),
              file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ziria_tpu_torch.tools.windowed_ber",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(main(device=ap.parse_args().device), indent=2))
