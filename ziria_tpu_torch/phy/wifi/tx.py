"""802.11a/g OFDM transmitter, per-frame form (counterpart of
ziria_tpu/phy/wifi/tx.py :58-119 and ``encode_frame``): crc >>>
scramble >>> convolutional encode + puncture >>> interleave >>> modulate
>>> map subcarriers >>> IFFT + CP, behind the preamble and the SIGNAL
symbol. The port's receiver tests and ``chip_smoke.py`` make their
captures with it."""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops import coding, cplx, interleave, modulate, ofdm, \
    scramble
from ziria_tpu_torch.ops.crc import append_crc32
from ziria_tpu_torch.phy.wifi.params import (N_SERVICE_BITS, N_TAIL_BITS,
                                             RATES, RateParams, n_symbols)
from ziria_tpu_torch.utils.bits import bytes_to_bits, uint_to_bits

# the standard's example frame seed
DEFAULT_SCRAMBLER_SEED = 0b1011101


def _seed_bits_np(seed_val: int) -> np.ndarray:
    return np.array([(seed_val >> k) & 1 for k in range(7)], np.uint8)


def signal_field_bits(rate: RateParams, length_bytes: int,
                      device=None) -> torch.Tensor:
    """The 24-bit SIGNAL field: RATE(4) R1-first, reserved(1),
    LENGTH(12) LSB-first, even parity(1), tail(6)."""
    head = torch.cat([
        uint_to_bits(rate.signal_bits, 4, msb_first=True, device=device),
        torch.zeros(1, dtype=torch.uint8, device=device),
        uint_to_bits(length_bytes, 12, device=device)])
    parity = (head.to(torch.int64).sum() % 2).to(torch.uint8)
    return torch.cat([head, parity[None],
                      torch.zeros(6, dtype=torch.uint8, device=device)])


def encode_signal_symbol(rate: RateParams, length_bytes: int,
                         device=None) -> torch.Tensor:
    """SIGNAL OFDM symbol (BPSK, rate 1/2, not scrambled): (80, 2)."""
    coded = coding.conv_encode(signal_field_bits(rate, length_bytes,
                                                 device))
    syms = modulate.modulate(interleave.interleave(coded, 48, 1), 1)
    bins = ofdm.map_subcarriers(syms[None], symbol_index0=0)
    return ofdm.ofdm_modulate(bins)[0]


def data_field_bits(psdu_bits: torch.Tensor, rate: RateParams,
                    n_sym: int) -> torch.Tensor:
    """SERVICE + PSDU + tail + pad, scrambled, tail re-zeroed after
    scrambling so the decoder ends in state 0."""
    dev = psdu_bits.device
    n_bits = n_sym * rate.n_dbps
    n_psdu = psdu_bits.shape[0]
    pad = n_bits - (N_SERVICE_BITS + n_psdu + N_TAIL_BITS)
    raw = torch.cat([
        torch.zeros(N_SERVICE_BITS, dtype=torch.uint8, device=dev),
        psdu_bits.to(torch.uint8),
        torch.zeros(N_TAIL_BITS + pad, dtype=torch.uint8, device=dev)])
    out = scramble.scramble_bits(raw, _seed_bits_np(DEFAULT_SCRAMBLER_SEED))
    tail_at = N_SERVICE_BITS + n_psdu
    out[tail_at: tail_at + N_TAIL_BITS] = 0
    return out


def encode_frame_bits(psdu_bits: torch.Tensor,
                      rate: RateParams) -> torch.Tensor:
    """PSDU bits -> frame samples (320 preamble + 80 SIGNAL +
    80*n_sym DATA, 2) float32, on the bits' device."""
    if psdu_bits.shape[0] % 8:
        raise ValueError(
            f"PSDU must be whole bytes; got {psdu_bits.shape[0]} bits")
    length_bytes = psdu_bits.shape[0] // 8
    n_sym = n_symbols(length_bytes, rate)
    bits = data_field_bits(psdu_bits, rate, n_sym)
    coded = coding.puncture(coding.conv_encode(bits), rate.coding)
    inter = interleave.interleave(coded, rate.n_cbps, rate.n_bpsc)
    syms = modulate.modulate(inter, rate.n_bpsc).reshape(n_sym, 48, 2)
    data_t = ofdm.ofdm_modulate(
        ofdm.map_subcarriers(syms, symbol_index0=1)).reshape(-1, 2)
    sig_t = encode_signal_symbol(rate, length_bytes, psdu_bits.device)
    return torch.cat([ofdm.preamble(psdu_bits.device), sig_t, data_t])


def encode_frame(psdu_bytes, rate_mbps: int, add_fcs: bool = False,
                 device="cuda") -> torch.Tensor:
    """Byte-level per-frame entry: PSDU bytes -> frame samples (n, 2)
    float32 on `device`. ``add_fcs`` appends the 32-bit CRC first."""
    data = torch.as_tensor(np.asarray(psdu_bytes, np.uint8), device=device)
    bits = bytes_to_bits(data)
    if add_fcs:
        bits = append_crc32(bits)
    with cplx.exact_fp32():
        return encode_frame_bits(bits, RATES[rate_mbps])
