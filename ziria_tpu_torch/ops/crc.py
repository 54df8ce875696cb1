"""CRC-32, the 802.11 FCS (counterpart of ziria_tpu/ops/crc.py):
polynomial 0x04C11DB7, init all-ones, LSB-first bit order, final
complement, driven byte by byte through a 256-entry table."""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.utils.bits import bits_to_bytes, uint_to_bits

_POLY = 0xEDB88320  # 0x04C11DB7 bit-reflected (LSB-first algorithm)


def _make_table() -> np.ndarray:
    tab = np.zeros(256, np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if (c & 1) else 0)
        tab[b] = c
    return tab


_TABLE = _make_table()


def _crc32_scan(data: torch.Tensor, n_bytes: torch.Tensor,
                n_steps: int) -> torch.Tensor:
    """CRC-32 of the first n_bytes[b] bytes of each row of (B, N)
    uint8 `data`, scanning `n_steps` >= max(n_bytes) bytes: steps at or
    past a row's count leave its register untouched. Returns (B,)
    int64 holding the uint32 CRC."""
    tab = torch.from_numpy(_TABLE.astype(np.int64)).to(data.device)
    crc = torch.full((data.shape[0],), 0xFFFFFFFF, dtype=torch.int64,
                     device=data.device)
    d = data.to(torch.int64)
    for j in range(n_steps):
        nxt = (crc >> 8) ^ tab[(crc ^ d[:, j]) & 0xFF]
        crc = torch.where(j < n_bytes, nxt, crc)
    return crc ^ 0xFFFFFFFF


def crc32_bits(bits: torch.Tensor) -> torch.Tensor:
    """CRC-32 of a bit stream (n,), n a multiple of 8 (LSB-first per
    byte): its 32 FCS bits in transmission order."""
    data = bits_to_bytes(bits)[None]
    n = data.shape[1]
    crc = _crc32_scan(data, torch.full((1,), n, device=bits.device), n)
    return uint_to_bits(crc[0], 32)


def append_crc32(bits: torch.Tensor) -> torch.Tensor:
    """Append the 32-bit FCS to a bit stream (n,) (the TX crc block)."""
    return torch.cat([bits.to(torch.uint8), crc32_bits(bits)])


def check_crc32(bits: torch.Tensor) -> torch.Tensor:
    """True (a 0-d bool tensor) iff the trailing 32 bits of a bit
    stream are the FCS of the rest."""
    bits = bits.to(torch.uint8)
    return (crc32_bits(bits[:-32]) == bits[-32:]).all()


def check_crc32_masked(bits: torch.Tensor, n_bits: torch.Tensor):
    """Per lane of padded bit streams (B, N): True iff
    bits[n_bits-32 : n_bits] is the FCS of bits[: n_bits-32]. n_bits
    (B,) are multiples of 8; a lane with n_bits < 32 reports False.

    The byte scan runs only up to the longest lane's count (one host
    read of that maximum), where the reference scans the whole padded
    array: masked steps past a lane's count never change its
    register, so the results are the same."""
    dev = bits.device
    n_bits = n_bits.to(device=dev, dtype=torch.int64)
    n_body = (n_bits - 32).clamp(min=0)
    n_bytes = n_body // 8
    n_steps = int(n_bytes.max()) if n_bytes.numel() else 0
    crc = _crc32_scan(bits_to_bytes(bits), n_bytes, n_steps)
    # the reference's dynamic_slice clamps the FCS start into range
    start = n_body.clamp(max=bits.shape[1] - 32)
    idx = start[:, None] + torch.arange(32, device=dev)
    fcs = torch.gather(bits.to(torch.uint8), 1, idx)
    return (n_bits >= 32) & (uint_to_bits(crc, 32) == fcs).all(-1)
