"""Max-log soft demapper (counterpart of ziria_tpu/ops/demap.py).

Positive LLR = bit more likely 1. Level-domain formulas, y the
equalized amplitude in integer level units:

    axis bit 0 (sign):        y
    axis bit 1 (16/64-QAM):   2 - |y|  (16-QAM)  /  4 - |y|  (64-QAM)
    axis bit 2 (64-QAM):      2 - ||y| - 4|
"""

from __future__ import annotations

import numpy as np
import torch

_NORM = {1: 1.0, 2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0)}


def demap(syms: torch.Tensor, n_bpsc: int, gain=None) -> torch.Tensor:
    """(..., m, 2) equalized pair symbols -> (..., m*n_bpsc) LLRs,
    each weighted by `gain` (..., m) (|H|^2) when given."""
    norm = float(_NORM[n_bpsc])
    i = syms[..., 0] * norm
    q = syms[..., 1] * norm
    if n_bpsc == 1:
        bits = i[..., None]
    elif n_bpsc == 2:
        bits = torch.stack([i, q], dim=-1)
    elif n_bpsc == 4:
        bits = torch.stack([i, 2.0 - i.abs(), q, 2.0 - q.abs()], dim=-1)
    elif n_bpsc == 6:
        bits = torch.stack([i, 4.0 - i.abs(), 2.0 - (i.abs() - 4.0).abs(),
                            q, 4.0 - q.abs(), 2.0 - (q.abs() - 4.0).abs()],
                           dim=-1)
    else:
        raise ValueError(f"unsupported n_bpsc {n_bpsc}")
    if gain is not None:
        bits = bits * gain[..., None]
    return bits.reshape(syms.shape[:-2] + (syms.shape[-2] * n_bpsc,))


def demap_bit_layout(n_bpsc: int):
    """Per-bit descriptors of :func:`demap` for the fused front end:
    for bit b of one subcarrier's n_bpsc LLRs, ``comp[b]`` is its
    component (0 = I, 1 = Q), ``lev[b]`` its level formula (0: x;
    1: amp - |x|; 2: 2 - ||x| - 4|) and ``amp[b]`` the level-1
    amplitude. Returns (comp, lev, amp) as int32, int32, float32."""
    if n_bpsc == 1:
        comp, lev, amp = [0], [0], [0.0]
    elif n_bpsc == 2:
        comp, lev, amp = [0, 1], [0, 0], [0.0, 0.0]
    elif n_bpsc == 4:
        comp, lev, amp = [0, 0, 1, 1], [0, 1, 0, 1], [0.0, 2.0, 0.0, 2.0]
    elif n_bpsc == 6:
        comp = [0, 0, 0, 1, 1, 1]
        lev = [0, 1, 2, 0, 1, 2]
        amp = [0.0, 4.0, 2.0, 0.0, 4.0, 2.0]
    else:
        raise ValueError(f"unsupported n_bpsc {n_bpsc}")
    return (np.asarray(comp, np.int32), np.asarray(lev, np.int32),
            np.asarray(amp, np.float32))
