"""OFDM symbol assembly: subcarrier mapping, pilots, DFT/IDFT, cyclic
prefix and the PLCP preamble (counterpart of ziria_tpu/ops/ofdm.py;
IEEE 802.11a-1999 §17.3). Tables are numpy constants; functions take
pair tensors with any leading batch axes."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ziria_tpu_torch.ops import cplx
from ziria_tpu_torch.ops.scramble import np_lfsr_sequence_127

N_FFT = 64
N_CP = 16
N_DATA = 48

# subcarrier indices (FFT bin, negative = N_FFT + k)
PILOT_SC = np.array([-21, -7, 7, 21])
PILOT_VALS = np.array([1.0, 1.0, 1.0, -1.0])
_used = [k for k in range(-26, 27) if k != 0]
DATA_SC = np.array([k for k in _used if k not in set(PILOT_SC.tolist())])

DATA_BINS = np.where(DATA_SC < 0, DATA_SC + N_FFT, DATA_SC)
PILOT_BINS = np.where(PILOT_SC < 0, PILOT_SC + N_FFT, PILOT_SC)

# pilot polarity p_0..p_126: scrambler sequence of the all-ones seed,
# 0 -> +1, 1 -> -1
PILOT_POLARITY = 1.0 - 2.0 * np_lfsr_sequence_127(
    np.ones(7, np.uint8)).astype(np.float64)

# long training symbol, subcarriers -26..26 (0 at DC)
LTS_FREQ = np.array(
    [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1,
     1, -1, 1, 1, 1, 1,
     0,
     1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1,
     -1, 1, -1, 1, 1, 1, 1], np.float64)

# short training symbol: nonzero every 4th subcarrier in -24..24
STS_SC = np.array([-24, -20, -16, -12, -8, -4, 4, 8, 12, 16, 20, 24])
STS_VALS = np.sqrt(13.0 / 6.0) * np.array(
    [1 + 1j, -1 - 1j, 1 + 1j, -1 - 1j, -1 - 1j, 1 + 1j,
     -1 - 1j, -1 - 1j, 1 + 1j, 1 + 1j, 1 + 1j, 1 + 1j])

# TX time-domain scaling: unit average sample power over 52 used tones
TIME_SCALE = N_FFT / np.sqrt(52.0)


def _freq_to_bins(sc: np.ndarray, vals: np.ndarray) -> np.ndarray:
    bins = np.zeros(N_FFT, np.complex128)
    bins[np.where(sc < 0, sc + N_FFT, sc)] = vals
    return bins


def _preamble_np() -> np.ndarray:
    sts_bins = _freq_to_bins(STS_SC, STS_VALS)
    sts_time = (np.fft.ifft(sts_bins) * N_FFT / np.sqrt(12.0)
                / np.sqrt(13.0 / 6.0))
    short = np.tile(sts_time[:16], 10)
    lts_bins = _freq_to_bins(np.arange(-26, 27), LTS_FREQ)
    lts_time = np.fft.ifft(lts_bins) * N_FFT / np.sqrt(52.0)
    long = np.concatenate([lts_time[-32:], lts_time, lts_time])
    return np.concatenate([short, long])


_PREAMBLE = cplx.from_complex(_preamble_np())
_LTS_TIME = cplx.from_complex(
    np.fft.ifft(_freq_to_bins(np.arange(-26, 27), LTS_FREQ))
    * N_FFT / np.sqrt(52.0))


@lru_cache(maxsize=None)
def _index(name: str, device: torch.device) -> torch.Tensor:
    """A bin-index table as an int64 tensor on `device`, built once."""
    return torch.from_numpy(
        {"data": DATA_BINS, "pilot": PILOT_BINS}[name].astype(np.int64)
    ).to(device)


def pilot_values(n_sym: int, symbol_index0: int,
                 device: torch.device) -> torch.Tensor:
    """(n_sym, 4) float32 expected pilot values (real; polarity index
    starts at symbol_index0)."""
    pol = torch.from_numpy(PILOT_POLARITY.astype(np.float32)).to(device)[
        (torch.arange(n_sym, device=device) + symbol_index0) % 127]
    vals = torch.from_numpy(PILOT_VALS.astype(np.float32)).to(device)
    return vals[None, :] * pol[:, None]


def map_subcarriers(data_syms: torch.Tensor,
                    symbol_index0: int = 1) -> torch.Tensor:
    """(..., n_sym, 48, 2) data symbols -> (..., n_sym, 64, 2) bins
    with pilots inserted (SIGNAL uses polarity index 0, DATA from 1)."""
    dev = data_syms.device
    n_sym = data_syms.shape[-3]
    bins = torch.zeros(data_syms.shape[:-2] + (N_FFT, 2),
                       dtype=torch.float32, device=dev)
    bins[..., _index("data", dev), :] = data_syms.to(torch.float32)
    p_re = pilot_values(n_sym, symbol_index0, dev)
    bins[..., _index("pilot", dev), :] = torch.stack(
        [p_re, torch.zeros_like(p_re)], dim=-1)
    return bins


def extract_subcarriers(bins: torch.Tensor):
    """(..., 64, 2) bins -> ((..., 48, 2) data, (..., 4, 2) pilots)."""
    dev = bins.device
    return bins[..., _index("data", dev), :], \
        bins[..., _index("pilot", dev), :]


def ofdm_modulate(bins: torch.Tensor) -> torch.Tensor:
    """(..., 64, 2) bins -> (..., 80, 2) time samples (CP + symbol),
    scaled for unit average power."""
    t = cplx.ifft_pair(bins.to(torch.float32)) * TIME_SCALE
    return torch.cat([t[..., N_FFT - N_CP:, :], t], dim=-2)


def ofdm_demodulate(samples: torch.Tensor) -> torch.Tensor:
    """(..., 80, 2) time samples (CP + symbol) -> (..., 64, 2) bins."""
    return cplx.fft_pair(samples[..., N_CP:, :]) / TIME_SCALE


def preamble(device=None) -> torch.Tensor:
    """The 320-sample PLCP preamble as pairs (320, 2)."""
    return torch.from_numpy(_PREAMBLE).to(device)


def lts_time_symbol() -> np.ndarray:
    """One 64-sample long training symbol as pairs (64, 2)."""
    return _LTS_TIME
