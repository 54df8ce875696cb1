"""802.11 data scrambler / descrambler (counterpart of
ziria_tpu/ops/scramble.py).

The scrambler is the 7-bit LFSR x^7 + x^4 + 1, whose 127-bit output
sequence is XORed onto the data bits. Every per-seed sequence is a
numpy constant here, so scrambling a batch is one table gather, one
tile and one XOR; seed recovery matches the first 7 received bits
against the 128-row seed table, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch


def np_lfsr_sequence_127(seed_bits) -> np.ndarray:
    """One period (127 bits) of the scrambler sequence from a 7-bit
    seed (seed_bits[k] = x_{k+1}; output bit t = x7 XOR x4)."""
    s = [int(b) for b in np.asarray(seed_bits, np.uint8)]
    out = []
    for _ in range(127):
        fb = s[6] ^ s[3]
        out.append(fb)
        s = [fb] + s[:6]
    return np.array(out, np.uint8)


def _seed_bits(seed: int) -> np.ndarray:
    return np.array([(seed >> k) & 1 for k in range(7)], np.uint8)


def _seed_table() -> np.ndarray:
    """First 7 sequence bits for every 7-bit seed (row = seed value,
    seed bits LSB-first)."""
    return np.stack([np_lfsr_sequence_127(_seed_bits(s))[:7]
                     for s in range(128)])


_SEED_TABLE = _seed_table()
# the full period for every seed: row 0 (the all-zero seed, which the
# reference's argmax falls back to when no row matches) is all zeros
_SEQ_TABLE = np.stack([np_lfsr_sequence_127(_seed_bits(s))
                       for s in range(128)])


def _tiled(seq: torch.Tensor, n: int) -> torch.Tensor:
    reps = -(-n // 127)
    return seq.repeat((1,) * (seq.dim() - 1) + (reps,))[..., :n]


def scramble_bits(bits: torch.Tensor, seed_bits) -> torch.Tensor:
    """XOR bits (n,) with the sequence of one 7-bit seed (additive
    scrambling; descrambling is the same XOR)."""
    seq = torch.from_numpy(np_lfsr_sequence_127(seed_bits)).to(bits.device)
    return bits.to(torch.uint8) ^ _tiled(seq, bits.shape[-1])


def recover_seed(first7: torch.Tensor) -> torch.Tensor:
    """Seed VALUE per lane from the first 7 received bits (B, 7): the
    first row of the seed table they match, 0 when none does (the
    reference's argmax over an all-False match). Returns (B,) int64;
    the reference returns the same seed as bits,
    ``uint_to_bits(seed, 7)``."""
    tab = torch.from_numpy(_SEED_TABLE).to(first7.device)
    match = (tab[None, :, :] == first7[:, None, :].to(torch.uint8)).all(-1)
    return torch.argmax(match.to(torch.uint8), dim=1)


def descramble_bits(bits: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Descramble each lane of (B, n) bits with the sequence of its seed
    value (B,) from :func:`recover_seed`: one table gather, one tile,
    one XOR."""
    seq = torch.from_numpy(_SEQ_TABLE).to(bits.device)[seed]   # (B, 127)
    return bits.to(torch.uint8) ^ _tiled(seq, bits.shape[-1])
