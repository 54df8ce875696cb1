"""The constant tables of the receive path, under their JAX names.

Ziria has no learned parameters: what a model would carry as weights,
this system carries as constant tables (trellis edges and generator
taps, DFT matrices, preamble and training symbols, pilots, interleaver
permutations, puncturing patterns, demap scales, the CRC table, the
scrambler seed table, and the fused front end's tables: the per-bit
demap layout, the deinterleaver's slot sources, each rate's slot table
and the stacked 8-rate bank, with the mixed decode's sub-block
constants). The port builds its own copies with numpy and
imports nothing from the JAX package, so nothing carries them across
at run time. ``tests/test_torch_tables.py`` instead pins every table
here equal to the JAX package's array of the same name: that test
stands where a model port's "load the reference weights" check would.
The fused front's slot tables are compact index rows in the port
(ops/viterbi_fused) and one-hot matrices in the reference; they are
expanded here to the reference's form for that comparison.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ziria_tpu_torch.ops import coding, cplx, crc, demap, interleave, \
    modulate, ofdm, scramble, viterbi, viterbi_fused
from ziria_tpu_torch.phy.wifi.params import RATES


def one_hot_slots(rows: np.ndarray):
    """Compact slot rows (..., 4) of (src, lev, amp, valid) -> the
    reference's one-hot form: sel_x (..., 96) picking component src,
    sel_g (..., 48) picking subcarrier src >> 1, and lcols (..., 8)
    with the level one-hot in cols 0-2, amp in col 3 and validity in
    col 4; punctured slots stay all zero."""
    flat = rows.reshape(-1, 4)
    sel_x = np.zeros((flat.shape[0], 96), np.float32)
    sel_g = np.zeros((flat.shape[0], 48), np.float32)
    lcols = np.zeros((flat.shape[0], 8), np.float32)
    for p, (src, lev, amp, valid) in enumerate(flat):
        if valid:
            sel_x[p, src] = 1.0
            sel_g[p, src >> 1] = 1.0
            lcols[p, lev] = 1.0
            lcols[p, 3] = amp
            lcols[p, 4] = 1.0
    lead = rows.shape[:-1]
    return (sel_x.reshape(lead + (96,)), sel_g.reshape(lead + (48,)),
            lcols.reshape(lead + (8,)))


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
        for i, a in enumerate(demap.demap_bit_layout(n_bpsc)):
            t[f"ops.demap.demap_bit_layout({n_bpsc})[{i}]"] = a
    # the fused front end (ops/viterbi_fused)
    for n_cbps, n_bpsc in sorted({(p.n_cbps, p.n_bpsc)
                                  for p in RATES.values()}):
        for i, a in enumerate(interleave.deinterleave_slots(n_cbps, n_bpsc)):
            t[f"ops.interleave.deinterleave_slots({n_cbps}, {n_bpsc})"
              f"[{i}]"] = a
    for p in RATES.values():
        args = f"{p.n_bpsc}, {p.n_cbps}, {p.n_dbps}, {p.coding!r}"
        onehot = one_hot_slots(viterbi_fused.front_tables(
            p.n_bpsc, p.n_cbps, p.n_dbps, p.coding))
        for i, a in enumerate(onehot):
            t[f"ops.viterbi_pallas._front_tables({args})[{i}]"] = a
    sel_x, _sel_g, lcols = one_hot_slots(viterbi_fused.mixed_front_tables())
    t["ops.viterbi_pallas.mixed_front_tables()[0]"] = sel_x
    t["ops.viterbi_pallas.mixed_front_tables()[1]"] = lcols
    for i, a in enumerate(viterbi_fused._mixed_rate_geometry()):
        t[f"ops.viterbi_pallas._mixed_rate_geometry()[{i}]"] = np.asarray(a)
    for name in ("MIXED_SUB", "MIXED_UNROLL", "MIXED_CHUNKS"):
        t[f"ops.viterbi_pallas.{name}"] = np.asarray(
            getattr(viterbi_fused, name))
    return t
