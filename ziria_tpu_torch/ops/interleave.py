"""802.11a block interleaver / deinterleaver (counterpart of
ziria_tpu/ops/interleave.py): one precomputed gather index per
(n_cbps, n_bpsc), applied per symbol block along the last axis."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def interleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    """perm[j] = k: output position j carries input bit k (one symbol),
    from the standard's two index maps k -> i -> j, inverted."""
    s = max(n_bpsc // 2, 1)
    k = np.arange(n_cbps)
    i = (n_cbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
    perm = np.zeros(n_cbps, np.int32)
    perm[j] = k
    return perm


@lru_cache(maxsize=None)
def deinterleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    p = interleave_perm(n_cbps, n_bpsc)
    inv = np.zeros_like(p)
    inv[p] = np.arange(n_cbps, dtype=np.int32)
    return inv


def interleave(bits: torch.Tensor, n_cbps: int, n_bpsc: int):
    """Interleave whole symbols: (..., m*n_cbps) -> same shape."""
    return _permute(bits, interleave_perm(n_cbps, n_bpsc), n_cbps)


def deinterleave(vals: torch.Tensor, n_cbps: int, n_bpsc: int):
    """Inverse permutation; used on soft values in the receiver."""
    return _permute(vals, deinterleave_perm(n_cbps, n_bpsc), n_cbps)


def _permute(vals: torch.Tensor, perm: np.ndarray, n_cbps: int):
    n = vals.shape[-1]
    if n % n_cbps:
        raise ValueError(f"length {n} not a multiple of n_cbps={n_cbps}")
    blocks = vals.reshape(vals.shape[:-1] + (n // n_cbps, n_cbps))
    idx = torch.from_numpy(perm.astype(np.int64)).to(vals.device)
    return blocks[..., idx].reshape(vals.shape)
