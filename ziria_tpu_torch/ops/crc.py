"""CRC-32, the 802.11 FCS (counterpart of ziria_tpu/ops/crc.py):
polynomial 0x04C11DB7, init all-ones, LSB-first bit order, final
complement.

The reference drives a 256-entry table byte by byte in a ``lax.scan``.
Here the register is computed in one step from the fact that it is
affine over GF(2): after n body bits b_0 .. b_{n-1} from the all-ones
start,

    reg = XOR_k b_k * A^(n-1-k) P  XOR  A^n 0xFFFFFFFF

where A is one shift of the register and P the polynomial. With each
lane's body right-aligned to the end of the padded width W, the first
term is one 0/1 matrix product, (aligned bits) @ C mod 2, where row p
of C holds A^(W-1-p) P (what a 1 bit W-1-p places before the end
leaves in a zero register), and the second is a row of I, the all-ones
register pushed through n/8 zero bytes. Both tables are built once per
power-of-two width with numpy, by doubling (no loop over bits), and
cached on the device per padded width. Every operand is 0 or 1 and
every sum stays below 2^24, so the float32 product is exact (TF32 too;
it runs under ``cplx.exact_fp32`` all the same). The step takes a
fixed number of launches whatever the lengths, and no host read.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.utils.bits import bits_to_bytes, bytes_to_bits
from ziria_tpu_torch.utils.dispatch import pow2_ceil

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


def _reg_bits(vals) -> np.ndarray:
    """uint32 register values (n,) -> their bits (n, 32), LSB first."""
    v = np.asarray(vals, np.uint64)
    return ((v[:, None] >> np.arange(32, dtype=np.uint64)) & 1) \
        .astype(np.uint8)


#: A, one shift of the register as a 0/1 matrix on its bits (LSB
#: first): bit i takes bit i + 1, and bit 0 feeds the polynomial back
_SHIFT = np.eye(32, k=1, dtype=np.uint8)
_SHIFT[:, 0] ^= _reg_bits([_POLY])[0]


def _orbit(v: np.ndarray, step: np.ndarray, count: int) -> np.ndarray:
    """Bits (count, 32) of step^j v for j < count over GF(2), by
    doubling: rows [L, 2L) are rows [0, L) pushed through step^L."""
    out = v[None, :]
    while out.shape[0] < count:
        out = np.concatenate([out, out @ step.T % 2]).astype(np.uint8)
        step = (step @ step % 2).astype(np.uint8)
    return out[:count]


@lru_cache(maxsize=None)
def _tables_np(width: int):
    """(C (width, 32) float32, I (width // 8 + 1, 32) uint8) for a
    power-of-two body width: row p of C is A^(width-1-p) P; row n of I
    is the all-ones register after n zero bytes (A^8n applied to it).
    A narrower width w takes the last w rows of C and the first
    w // 8 + 1 of I."""
    c = _orbit(_reg_bits([_POLY])[0], _SHIFT, width)[::-1]
    a8 = np.linalg.matrix_power(_SHIFT.astype(np.int64), 8) % 2
    init = _orbit(np.ones(32, np.uint8), a8.astype(np.uint8),
                  width // 8 + 1)
    return np.ascontiguousarray(c, dtype=np.float32), init


@lru_cache(maxsize=32)
def _tables(n_bits: int, device: torch.device):
    """The tables of a padded body width of n_bits bits, on `device`."""
    c, init = _tables_np(pow2_ceil(n_bits))
    return (torch.from_numpy(c[c.shape[0] - n_bits:]).to(device),
            torch.from_numpy(init[:n_bits // 8 + 1]).to(device))


def _crc_bits(data: torch.Tensor, n_bytes: torch.Tensor) -> torch.Tensor:
    """CRC-32 of the first n_bytes[b] bytes of each row of (B, M) uint8
    `data` (0 <= n_bytes <= M), as its 32 bits (B, 32) uint8 in
    transmission order."""
    dev = data.device
    m = data.shape[1]
    c, init = _tables(8 * m, dev)
    # right-align each lane's body bytes to the end of the width
    src = n_bytes[:, None] - m + torch.arange(m, device=dev)[None, :]
    aligned = torch.where(src >= 0, torch.gather(data, 1, src.clamp(min=0)),
                          torch.zeros((), dtype=data.dtype, device=dev))
    with cplx.exact_fp32():
        lin = bytes_to_bits(aligned).to(torch.float32) @ c
    lin = (lin.to(torch.int64) & 1).to(torch.uint8)
    return lin ^ init[n_bytes] ^ 1


def crc32_bits(bits: torch.Tensor) -> torch.Tensor:
    """CRC-32 of a bit stream (n,), n a multiple of 8 (LSB-first per
    byte): its 32 FCS bits in transmission order."""
    data = bits_to_bytes(bits)[None]
    n = torch.full((1,), data.shape[1], dtype=torch.int64,
                   device=bits.device)
    return _crc_bits(data, n)[0]


def append_crc32(bits: torch.Tensor) -> torch.Tensor:
    """Append the 32-bit FCS to a bit stream (n,) (the TX crc block)."""
    return torch.cat([bits.to(torch.uint8), crc32_bits(bits)])


def check_crc32(bits: torch.Tensor) -> torch.Tensor:
    """True (a 0-d bool tensor) iff the trailing 32 bits of a bit
    stream are the FCS of the rest."""
    bits = bits.to(torch.uint8)
    return (crc32_bits(bits[:-32]) == bits[-32:]).all()


def check_crc32_masked(bits: torch.Tensor, n_bits: torch.Tensor):
    """Per lane of padded bit streams (B, N), N a multiple of 8: True
    iff bits[n_bits-32 : n_bits] is the FCS of bits[: n_bits-32].
    n_bits (B,) are multiples of 8; as in the reference, a lane with
    n_bits < 32 reports False, a body past the width covers the whole
    width and the FCS start clamps into range."""
    dev = bits.device
    bits = bits.to(torch.uint8)
    n_bits = n_bits.to(device=dev, dtype=torch.int64)
    n_body = (n_bits - 32).clamp(min=0)
    n_bytes = (n_body // 8).clamp(max=bits.shape[1] // 8)
    crc = _crc_bits(bits_to_bytes(bits), n_bytes)
    # the reference's dynamic_slice clamps the FCS start into range
    start = n_body.clamp(max=bits.shape[1] - 32)
    idx = start[:, None] + torch.arange(32, device=dev)
    fcs = torch.gather(bits, 1, idx)
    return (n_bits >= 32) & (crc == fcs).all(-1)
