"""The port's CRC-32 (ops/crc: one GF(2) matrix product a step) against
``zlib.crc32``, the byte loop it replaced (kept here as the plain
version the card test also holds it against) and, once, the JAX
package's ``check_crc32_masked``. Bits and booleans compare exactly.
"""

import zlib

import numpy as np
import pytest
import torch

from ziria_tpu_torch.ops import crc
from ziria_tpu_torch.phy.wifi.params import MAX_DBPS, N_SERVICE_BITS
from ziria_tpu_torch.utils.bits import bits_to_bytes, bytes_to_bits, \
    uint_to_bits

#: the body width of a 512-symbol bucket's descrambled stream past the
#: SERVICE field: receive_many's full-width CRC input
FULL_BITS = 512 * MAX_DBPS - N_SERVICE_BITS


def crc32_loop(data: torch.Tensor, n_bytes: torch.Tensor) -> torch.Tensor:
    """The plain version: CRC-32 (B,) int64 of the first n_bytes[b]
    bytes of each row of (B, N) uint8 `data`, the 256-entry table
    driven byte by byte over the whole width, steps at or past a row's
    count leaving its register untouched (the reference's masked
    scan)."""
    tab = torch.from_numpy(crc._TABLE.astype(np.int64)).to(data.device)
    reg = torch.full((data.shape[0],), 0xFFFFFFFF, dtype=torch.int64,
                     device=data.device)
    d = data.to(torch.int64)
    for j in range(data.shape[1]):
        nxt = (reg >> 8) ^ tab[(reg ^ d[:, j]) & 0xFF]
        reg = torch.where(j < n_bytes, nxt, reg)
    return reg ^ 0xFFFFFFFF


def masked_loop(bits: torch.Tensor, n_bits: torch.Tensor) -> torch.Tensor:
    """check_crc32_masked through the plain loop."""
    n_body = (n_bits - 32).clamp(min=0)
    reg = crc32_loop(bits_to_bytes(bits), n_body // 8)
    start = n_body.clamp(max=bits.shape[1] - 32)
    fcs = torch.gather(bits, 1, start[:, None]
                       + torch.arange(32, device=bits.device))
    return (n_bits >= 32) & (uint_to_bits(reg, 32) == fcs).all(-1)


def zlib_bits(data: np.ndarray) -> np.ndarray:
    v = zlib.crc32(bytes(data))
    return np.array([(v >> i) & 1 for i in range(32)], np.uint8)


def edge_lanes(width: int, seed: int):
    """Padded bit streams (B, width) and bit counts (B,): the edge
    lengths 0, 8, 24, 32 and 40 bits, a lane of the full width, one
    past it (its FCS start clamps), a lane of all-ones bits (the
    product's largest sums), then random mixed lengths; a valid FCS in
    every other lane that can hold one."""
    rng = np.random.default_rng(seed)
    nb = [0, 8, 24, 32, 40, width, width + 64, width]
    nb += list(8 * rng.integers(0, width // 8 + 1, 24))
    bits = rng.integers(0, 2, (len(nb), width)).astype(np.uint8)
    bits[7] = 1
    for b in range(3, len(nb), 2):
        n = min(nb[b], width)
        if n >= 32:
            body = np.packbits(bits[b, :n - 32], bitorder="little")
            bits[b, n - 32:n] = zlib_bits(body)
    return torch.from_numpy(bits), torch.tensor(nb, dtype=torch.int64)


def test_masked_crc_equals_reference_on_edge_lanes():
    import jax
    import jax.numpy as jnp

    from ziria_tpu.ops import crc as jcrc

    bits, nb = edge_lanes(8 * 70, 1)
    got = crc.check_crc32_masked(bits, nb).numpy()
    want = np.asarray(jax.vmap(jcrc.check_crc32_masked)(
        jnp.asarray(bits.numpy()), jnp.asarray(nb.numpy(), jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert got[3::2].sum() >= 10 and not got[:3].any()


@pytest.mark.parametrize("width", [8 * 5, 8 * 64, 8 * 1000])
def test_masked_crc_equals_plain_loop(width):
    bits, nb = edge_lanes(width, width)
    np.testing.assert_array_equal(crc.check_crc32_masked(bits, nb).numpy(),
                                  masked_loop(bits, nb).numpy())


def test_crc_register_equals_zlib_at_mixed_lengths():
    rng = np.random.default_rng(3)
    for m in (1, 7, 64, 129):
        data = rng.integers(0, 256, (40, m)).astype(np.uint8)
        n = rng.integers(0, m + 1, 40)
        n[:2] = 0, m
        got = crc._crc_bits(torch.from_numpy(data), torch.from_numpy(n))
        for b in range(40):
            np.testing.assert_array_equal(got[b].numpy(),
                                          zlib_bits(data[b, :n[b]]))


def test_full_width_lanes_equal_zlib():
    # receive_many's full width: the all-ones lane's column sums reach
    # up to 110,576, far below 2^24
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (4, FULL_BITS)).astype(np.uint8)
    bits[0] = 1
    nb = np.array([FULL_BITS, FULL_BITS, 8000, 32])
    for b in range(3):
        n = nb[b]
        body = np.packbits(bits[b, :n - 32], bitorder="little")
        bits[b, n - 32:n] = zlib_bits(body) ^ (b == 1)
    got = crc.check_crc32_masked(torch.from_numpy(bits),
                                 torch.from_numpy(nb)).numpy()
    want = [True, False, True,
            bool((bits[3, :32] == zlib_bits(np.zeros(0, np.uint8))).all())]
    np.testing.assert_array_equal(got, want)


def test_check_crc32_on_one_frame():
    rng = np.random.default_rng(5)
    body = rng.integers(0, 256, 996).astype(np.uint8)
    bits = bytes_to_bits(torch.from_numpy(body))
    np.testing.assert_array_equal(crc.crc32_bits(bits).numpy(),
                                  zlib_bits(body))
    frame = crc.append_crc32(bits)
    assert frame.shape == (8 * 1000,) and bool(crc.check_crc32(frame))
    frame[5] ^= 1
    assert not bool(crc.check_crc32(frame))
