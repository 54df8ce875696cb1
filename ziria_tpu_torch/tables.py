"""The constant tables of the receive path, under their JAX names.

Ziria has no learned parameters: what a model would carry as weights,
this system carries as constant tables (trellis edges and generator
taps, DFT matrices, preamble and training symbols, pilots, interleaver
permutations, puncturing patterns, demap scales, the CRC table, the
scrambler seed table). The port builds its own copies with numpy and
imports nothing from the JAX package, so nothing carries them across
at run time. ``tests/test_torch_tables.py`` instead pins every table
here equal to the JAX package's array of the same name: that test
stands where a model port's "load the reference weights" check would.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ziria_tpu_torch.ops import coding, cplx, crc, demap, interleave, \
    modulate, ofdm, scramble, viterbi
from ziria_tpu_torch.phy.wifi.params import RATES


def reference_tables() -> Dict[str, np.ndarray]:
    """{JAX name: numpy array} for every table the port rebuilt. Keys
    name the reference's module under ``ziria_tpu`` and the attribute,
    or the call, that yields the same array there."""
    t = {
        "ops.coding.G0": coding.G0,
        "ops.coding.G1": coding.G1,
        "ops.viterbi._PRED": viterbi._PRED,
        "ops.viterbi._OUT_A": viterbi._OUT_A,
        "ops.viterbi._OUT_B": viterbi._OUT_B,
        "ops.crc._TABLE": crc._TABLE,
        "ops.scramble._SEED_TABLE": scramble._SEED_TABLE,
        "ops.modulate._GRAY2": modulate._GRAY2,
        "ops.modulate._GRAY3": modulate._GRAY3,
    }
    for rate, keep in coding.PUNCTURE_KEEP.items():
        t[f"ops.coding.PUNCTURE_KEEP[{rate!r}]"] = keep
    for inverse in (False, True):
        c, s = cplx._dft_mats(64, inverse)
        t[f"ops.cplx._dft_mats(64, {inverse})[0]"] = c
        t[f"ops.cplx._dft_mats(64, {inverse})[1]"] = s
    for name in ("DATA_SC", "PILOT_SC", "PILOT_VALS", "DATA_BINS",
                 "PILOT_BINS", "PILOT_POLARITY", "LTS_FREQ", "STS_SC",
                 "STS_VALS", "_PREAMBLE", "_LTS_TIME"):
        t[f"ops.ofdm.{name}"] = getattr(ofdm, name)
    for n_cbps, n_bpsc in sorted({(p.n_cbps, p.n_bpsc)
                                  for p in RATES.values()}):
        t[f"ops.interleave.interleave_perm({n_cbps}, {n_bpsc})"] = \
            interleave.interleave_perm(n_cbps, n_bpsc)
    for n_bpsc in (1, 2, 4, 6):
        t[f"ops.demap._NORM[{n_bpsc}]"] = np.asarray(demap._NORM[n_bpsc])
        t[f"ops.modulate._KMOD[{n_bpsc}]"] = np.asarray(
            modulate._KMOD[n_bpsc])
    return t
