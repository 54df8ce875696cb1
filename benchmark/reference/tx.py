"""The frozen 802.11a transmitter of the benchmark, in plain NumPy.

Frozen from the port at commit 33779fc: ``ziria_tpu_torch/phy/wifi/tx.py``
(``encode_frame``, ``signal_field_bits``, ``encode_signal_symbol``,
``data_field_bits``), ``ops/coding.py`` (``conv_encode``, ``puncture``),
``ops/interleave.py`` (``interleave_perm``), ``ops/modulate.py``
(``modulate``), ``ops/ofdm.py`` (``map_subcarriers``, ``ofdm_modulate``,
``preamble``), ``ops/scramble.py`` (``np_lfsr_sequence_127``) and
``ops/crc.py`` (``append_crc32``: the IEEE CRC-32 that zlib computes). It
imports nothing of the port, so a later change to the port cannot move
the benchmark's traffic. ``encode_frames`` encodes many frames of one rate
and one length at once; frame i's samples equal ``encode_frame``'s.
"""

from __future__ import annotations

import zlib

import numpy as np

# rate -> (n_bpsc, n_cbps, n_dbps, coding, SIGNAL RATE bits, R1 the MSB)
RATES = {
    6: (1, 48, 24, "1/2", 0b1101),
    9: (1, 48, 36, "3/4", 0b1111),
    12: (2, 96, 48, "1/2", 0b0101),
    18: (2, 96, 72, "3/4", 0b0111),
    24: (4, 192, 96, "1/2", 0b1001),
    36: (4, 192, 144, "3/4", 0b1011),
    48: (6, 288, 192, "2/3", 0b0001),
    54: (6, 288, 216, "3/4", 0b0011),
}
RATE_ORDER = tuple(sorted(RATES))
SIGNAL_TO_MBPS = {v[4]: m for m, v in RATES.items()}
N_SERVICE = 16
N_TAIL = 6
PREAMBLE_LEN = 320
HEADER_LEN = 400          # preamble + SIGNAL

G0 = np.array([1, 0, 1, 1, 0, 1, 1], np.uint8)   # 133 octal, tap d: x[k-d]
G1 = np.array([1, 1, 1, 1, 0, 0, 1], np.uint8)   # 171 octal
PUNCTURE_KEEP = {"1/2": np.array([1, 1], bool),
                 "2/3": np.array([1, 1, 1, 0], bool),
                 "3/4": np.array([1, 1, 1, 0, 0, 1], bool)}
SCRAMBLER_SEED = 0b1011101

N_FFT = 64
PILOT_SC = np.array([-21, -7, 7, 21])
PILOT_VALS = np.array([1.0, 1.0, 1.0, -1.0])
_USED = [k for k in range(-26, 27) if k != 0]
DATA_SC = np.array([k for k in _USED if k not in set(PILOT_SC.tolist())])
DATA_BINS = np.where(DATA_SC < 0, DATA_SC + N_FFT, DATA_SC)
PILOT_BINS = np.where(PILOT_SC < 0, PILOT_SC + N_FFT, PILOT_SC)
LTS_FREQ = np.array(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
     1, -1, 1, 1, 1, 1, 0,
     1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1,
     -1, 1, -1, 1, 1, 1, 1], np.float64)
STS_SC = np.array([-24, -20, -16, -12, -8, -4, 4, 8, 12, 16, 20, 24])
STS_VALS = np.sqrt(13.0 / 6.0) * np.array(
    [1 + 1j, -1 - 1j, 1 + 1j, -1 - 1j, -1 - 1j, 1 + 1j,
     -1 - 1j, -1 - 1j, 1 + 1j, 1 + 1j, 1 + 1j, 1 + 1j])
TIME_SCALE = N_FFT / np.sqrt(52.0)
KMOD = {1: 1.0, 2: 1.0 / np.sqrt(2.0), 4: 1.0 / np.sqrt(10.0),
        6: 1.0 / np.sqrt(42.0)}
# per-axis Gray levels, index = the axis bits read MSB first
GRAY = {1: np.array([-1.0, 1.0]), 2: np.array([-3.0, -1.0, 3.0, 1.0]),
        3: np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0])}


def lfsr_127(seed_bits) -> np.ndarray:
    """One period of the scrambler x^7 + x^4 + 1 from a 7-bit state
    (seed_bits[k] = x_{k+1}): output bit t = x7 XOR x4."""
    s = [int(b) for b in seed_bits]
    out = []
    for _ in range(127):
        fb = s[6] ^ s[3]
        out.append(fb)
        s = [fb] + s[:6]
    return np.array(out, np.uint8)


PILOT_POLARITY = 1.0 - 2.0 * lfsr_127(np.ones(7, np.uint8)).astype(float)
SCRAMBLE_SEQ = lfsr_127([(SCRAMBLER_SEED >> k) & 1 for k in range(7)])


def interleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    """perm[j] = k: interleaved position j carries coded bit k."""
    s = max(n_bpsc // 2, 1)
    k = np.arange(n_cbps)
    i = (n_cbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
    perm = np.zeros(n_cbps, np.int64)
    perm[j] = k
    return perm


def n_symbols(length_bytes: int, mbps: int) -> int:
    return -(-(N_SERVICE + 8 * length_bytes + N_TAIL) // RATES[mbps][2])


def frame_samples(length_bytes: int, mbps: int) -> int:
    return HEADER_LEN + 80 * n_symbols(length_bytes, mbps)


def bits_of(data: np.ndarray) -> np.ndarray:
    """uint8 bytes (..., N) -> bits (..., 8N), LSB first per byte."""
    return np.unpackbits(np.asarray(data, np.uint8), axis=-1,
                         bitorder="little")


def with_fcs(body: np.ndarray) -> np.ndarray:
    """Bodies (F, N) uint8 -> PSDUs (F, N + 4): each body and its FCS
    (zlib's CRC-32, least significant byte first)."""
    fcs = np.array([list(zlib.crc32(bytes(b)).to_bytes(4, "little"))
                    for b in np.asarray(body, np.uint8)], np.uint8)
    return np.concatenate([np.asarray(body, np.uint8),
                           fcs.reshape(len(body), 4)], axis=1)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """(F, n) bits -> (F, 2n) coded bits A0 B0 A1 B1 ..., from state 0."""
    f, n = bits.shape
    xp = np.concatenate([np.zeros((f, 6), np.uint8), bits], axis=1)
    a = np.zeros((f, n), np.uint8)
    b = np.zeros((f, n), np.uint8)
    for d in range(7):
        delayed = xp[:, 6 - d:6 - d + n]
        if G0[d]:
            a ^= delayed
        if G1[d]:
            b ^= delayed
    return np.stack([a, b], -1).reshape(f, 2 * n)


def puncture(coded: np.ndarray, coding: str) -> np.ndarray:
    keep = PUNCTURE_KEEP[coding]
    f, n = coded.shape
    return coded.reshape(f, n // keep.size, keep.size)[:, :, keep] \
        .reshape(f, -1)


def modulate(bits: np.ndarray, n_bpsc: int) -> np.ndarray:
    """(F, m * n_bpsc) bits -> (F, m) complex symbols."""
    f = bits.shape[0]
    g = bits.reshape(f, -1, n_bpsc).astype(np.int64)
    if n_bpsc == 1:
        return (2.0 * g[..., 0] - 1.0).astype(np.complex128)
    h = n_bpsc // 2
    w = 1 << np.arange(h - 1, -1, -1)
    i = GRAY[h][(g[..., :h] * w).sum(-1)]
    q = GRAY[h][(g[..., h:] * w).sum(-1)]
    return (i + 1j * q) * KMOD[n_bpsc]


def ofdm_symbols(data: np.ndarray, index0: int) -> np.ndarray:
    """(F, n_sym, 48) data symbols -> (F, n_sym * 80) samples: pilots
    (polarity from `index0`), IFFT, cyclic prefix."""
    f, n_sym, _ = data.shape
    bins = np.zeros((f, n_sym, N_FFT), np.complex128)
    bins[:, :, DATA_BINS] = data
    pol = PILOT_POLARITY[(np.arange(n_sym) + index0) % 127]
    bins[:, :, PILOT_BINS] = PILOT_VALS[None, None, :] * pol[None, :, None]
    t = np.fft.ifft(bins, axis=-1) * TIME_SCALE
    return np.concatenate([t[..., 48:], t], axis=-1).reshape(f, -1)


def _freq_to_bins(sc, vals) -> np.ndarray:
    bins = np.zeros(N_FFT, np.complex128)
    bins[np.where(sc < 0, sc + N_FFT, sc)] = vals
    return bins


def lts_time() -> np.ndarray:
    """One 64-sample long training symbol."""
    return np.fft.ifft(_freq_to_bins(np.arange(-26, 27), LTS_FREQ)) \
        * N_FFT / np.sqrt(52.0)


def preamble() -> np.ndarray:
    """The 320-sample PLCP preamble: ten short symbols, GI2, two long."""
    sts = (np.fft.ifft(_freq_to_bins(STS_SC, STS_VALS)) * N_FFT
           / np.sqrt(12.0) / np.sqrt(13.0 / 6.0))
    lts = lts_time()
    return np.concatenate([np.tile(sts[:16], 10), lts[-32:], lts, lts])


def signal_bits(mbps: int, length_bytes: int) -> np.ndarray:
    """The 24 SIGNAL bits: RATE (R1 first), reserved, LENGTH LSB first,
    even parity, six tail zeros."""
    rate = [(RATES[mbps][4] >> (3 - k)) & 1 for k in range(4)]
    length = [(length_bytes >> k) & 1 for k in range(12)]
    head = rate + [0] + length
    return np.array(head + [sum(head) % 2] + [0] * 6, np.uint8)


def encode_frames(psdus: np.ndarray, mbps: int) -> np.ndarray:
    """PSDUs (F, N) uint8 (FCS included), one rate -> (F, 400 + 80 *
    n_sym) complex128 frame samples."""
    n_bpsc, n_cbps, n_dbps, coding, _ = RATES[mbps]
    psdus = np.asarray(psdus, np.uint8)
    f, nbytes = psdus.shape
    n_sym = n_symbols(nbytes, mbps)
    n_bits = n_sym * n_dbps
    raw = np.zeros((f, n_bits), np.uint8)
    raw[:, N_SERVICE:N_SERVICE + 8 * nbytes] = bits_of(psdus)
    seq = np.tile(SCRAMBLE_SEQ, -(-n_bits // 127))[:n_bits]
    scrambled = raw ^ seq[None, :]
    tail = N_SERVICE + 8 * nbytes
    scrambled[:, tail:tail + N_TAIL] = 0
    coded = puncture(conv_encode(scrambled), coding)
    perm = interleave_perm(n_cbps, n_bpsc)
    inter = coded.reshape(f, n_sym, n_cbps)[:, :, perm].reshape(f, -1)
    data = ofdm_symbols(modulate(inter, n_bpsc).reshape(f, n_sym, 48), 1)
    sig_coded = conv_encode(signal_bits(mbps, nbytes)[None])
    sig = ofdm_symbols(modulate(sig_coded[:, interleave_perm(48, 1)], 1)
                       .reshape(1, 1, 48), 0)
    head = np.concatenate([preamble(), sig[0]])
    return np.concatenate([np.broadcast_to(head, (f, head.size)), data],
                          axis=1)
