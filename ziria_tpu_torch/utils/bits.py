"""Bit helpers (counterpart of ziria_tpu/utils/bits.py).

Bits are uint8 0/1 tensors; within a byte, bit 0 (LSB) is first on the
stream. Integers come back as int64 (torch has no full uint32
arithmetic; every value here fits in 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

BIT_DTYPE = torch.uint8


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes (..., N) -> bits (..., 8N), LSB-first per byte."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(data.shape[:-1] + (data.shape[-1] * 8,))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., 8N) -> uint8 bytes (..., N), LSB-first per byte."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError(f"bit count {n} not a multiple of 8")
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (n // 8, 8))
    weights = 1 << torch.arange(8, dtype=torch.int64, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def bits_to_uint(bits: torch.Tensor, msb_first: bool = False) -> torch.Tensor:
    """bits (..., K) -> integers (...,) as int64, K <= 32. LSB-first by
    default."""
    k = bits.shape[-1]
    idx = torch.arange(k, dtype=torch.int64, device=bits.device)
    if msb_first:
        idx = idx.flip(0)
    return (bits.to(torch.int64) << idx).sum(-1)


def uint_to_bits(vals, k: int, msb_first: bool = False,
                 device=None) -> torch.Tensor:
    """integers (...,) -> uint8 bits (..., k). LSB-first by default."""
    vals = torch.as_tensor(vals, dtype=torch.int64, device=device)
    idx = torch.arange(k, dtype=torch.int64, device=vals.device)
    if msb_first:
        idx = idx.flip(0)
    return ((vals[..., None] >> idx) & 1).to(torch.uint8)


def np_bytes_to_bits(data) -> np.ndarray:
    """uint8 bytes (..., N) -> numpy bits (..., 8N) on the host,
    LSB-first per byte."""
    return np.unpackbits(np.asarray(data, np.uint8), axis=-1,
                         bitorder="little")


def np_bits_to_bytes(bits) -> np.ndarray:
    """numpy bits (..., 8N) -> uint8 bytes (..., N) on the host,
    LSB-first per byte."""
    bits = np.asarray(bits, np.uint8)
    if bits.shape[-1] % 8:
        raise ValueError(f"bit count {bits.shape[-1]} not a multiple of 8")
    return np.packbits(bits, axis=-1, bitorder="little")
