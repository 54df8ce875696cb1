"""Convolutional encoding (K=7, g0=133o, g1=171o), puncturing and
depuncturing (counterpart of ziria_tpu/ops/coding.py)."""

from __future__ import annotations

import numpy as np
import torch

# generator taps, delay order (tap[d] multiplies x_{k-d})
G0 = np.array([1, 0, 1, 1, 0, 1, 1], np.int32)  # 133 octal
G1 = np.array([1, 1, 1, 1, 0, 0, 1], np.int32)  # 171 octal
K = 7

# puncturing patterns over one period of coded (A,B) pairs
PUNCTURE_KEEP = {
    "1/2": np.array([1, 1], bool),
    "2/3": np.array([1, 1, 1, 0], bool),
    "3/4": np.array([1, 1, 1, 0, 0, 1], bool),
}


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 encode along the last axis: (..., n) bits -> (..., 2n)
    coded bits A0 B0 A1 B1 ... (encoder starts in the all-zero
    state). Each output is the XOR of the tapped delayed inputs."""
    x = bits.to(torch.int64)
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (K - 1, 0))
    a = torch.zeros_like(x)
    b = torch.zeros_like(x)
    for d in range(K):
        delayed = xp[..., K - 1 - d: K - 1 - d + n]
        if G0[d]:
            a = a ^ delayed
        if G1[d]:
            b = b ^ delayed
    return torch.stack([a, b], dim=-1).reshape(
        x.shape[:-1] + (2 * n,)).to(torch.uint8)


def puncture(coded: torch.Tensor, rate: str) -> torch.Tensor:
    """Drop coded bits (last axis) per the standard's pattern."""
    keep = PUNCTURE_KEEP[rate]
    if rate == "1/2":
        return coded
    p = keep.size
    n = coded.shape[-1]
    if n % p:
        raise ValueError(f"punctured block length {n} not a multiple of "
                         f"pattern period {p}")
    blocks = coded.reshape(coded.shape[:-1] + (n // p, p))
    idx = torch.from_numpy(np.flatnonzero(keep)).to(coded.device)
    return blocks[..., idx].reshape(coded.shape[:-1] + (-1,))


def depuncture(vals: torch.Tensor, rate: str, fill: float = 0.0):
    """Inverse of puncture for soft values along the last axis:
    re-insert `fill` (an erasure, 0 LLR) at the dropped positions."""
    keep = PUNCTURE_KEEP[rate]
    if rate == "1/2":
        return vals
    p = keep.size
    kept = int(keep.sum())
    n = vals.shape[-1]
    if n % kept:
        raise ValueError(f"depuncture input length {n} not a multiple of "
                         f"kept-count {kept}")
    lead = vals.shape[:-1]
    out = torch.full(lead + (n // kept, p), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = torch.from_numpy(np.flatnonzero(keep)).to(vals.device)
    out[..., idx] = vals.reshape(lead + (n // kept, kept))
    return out.reshape(lead + (-1,))
