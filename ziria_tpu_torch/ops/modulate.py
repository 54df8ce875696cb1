"""Constellation mapping, BPSK/QPSK/16-QAM/64-QAM with the 802.11 Gray
labels (counterpart of ziria_tpu/ops/modulate.py). Used by the
transmitter that makes test and smoke captures."""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.utils.bits import bits_to_uint

# per-axis Gray maps: bits (most significant first) -> amplitude level
_GRAY2 = np.array([-3.0, -1.0, 3.0, 1.0])
_GRAY3 = np.zeros(8)
for _bits, _lvl in [((0, 0, 0), -7), ((0, 0, 1), -5), ((0, 1, 1), -3),
                    ((0, 1, 0), -1), ((1, 1, 0), 1), ((1, 1, 1), 3),
                    ((1, 0, 1), 5), ((1, 0, 0), 7)]:
    _GRAY3[(_bits[0] << 2) | (_bits[1] << 1) | _bits[2]] = _lvl

_KMOD = {1: 1.0, 2: 1.0 / np.sqrt(2.0), 4: 1.0 / np.sqrt(10.0),
         6: 1.0 / np.sqrt(42.0)}


def modulate(bits: torch.Tensor, n_bpsc: int) -> torch.Tensor:
    """bits (..., m*n_bpsc) -> pair symbols (..., m, 2) float32. The
    first bits of a symbol map to I, the rest to Q, most significant
    first."""
    n = bits.shape[-1]
    if n % n_bpsc:
        raise ValueError(f"bit count {n} not a multiple of n_bpsc={n_bpsc}")
    g = bits.reshape(bits.shape[:-1] + (n // n_bpsc, n_bpsc))
    dev = bits.device
    if n_bpsc in (1, 2):
        i = 2.0 * g[..., 0].to(torch.float32) - 1.0
        q = torch.zeros_like(i) if n_bpsc == 1 else \
            2.0 * g[..., 1].to(torch.float32) - 1.0
    elif n_bpsc in (4, 6):
        h = n_bpsc // 2
        lut = torch.from_numpy(
            (_GRAY2 if n_bpsc == 4 else _GRAY3).astype(np.float32)).to(dev)
        i = lut[bits_to_uint(g[..., :h], msb_first=True)]
        q = lut[bits_to_uint(g[..., h:], msb_first=True)]
    else:
        raise ValueError(f"unsupported n_bpsc {n_bpsc}")
    return torch.stack([i, q], dim=-1) * float(_KMOD[n_bpsc])
