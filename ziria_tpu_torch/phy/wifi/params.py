"""802.11a/g OFDM PHY rate parameters (counterpart of
ziria_tpu/phy/wifi/params.py; the standard's Table 78, §17.3.2.2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class RateParams:
    mbps: int
    n_bpsc: int        # coded bits per subcarrier
    n_cbps: int        # coded bits per OFDM symbol
    n_dbps: int        # data bits per OFDM symbol
    coding: str        # "1/2" | "2/3" | "3/4"
    signal_bits: int   # 4-bit RATE field, R1 (transmitted first) = MSB here


RATES: Dict[int, RateParams] = {
    6:  RateParams(6,  1, 48,  24,  "1/2", 0b1101),
    9:  RateParams(9,  1, 48,  36,  "3/4", 0b1111),
    12: RateParams(12, 2, 96,  48,  "1/2", 0b0101),
    18: RateParams(18, 2, 96,  72,  "3/4", 0b0111),
    24: RateParams(24, 4, 192, 96,  "1/2", 0b1001),
    36: RateParams(36, 4, 192, 144, "3/4", 0b1011),
    48: RateParams(48, 6, 288, 192, "2/3", 0b0001),
    54: RateParams(54, 6, 288, 216, "3/4", 0b0011),
}

SIGNAL_BITS_TO_MBPS = {p.signal_bits: m for m, p in RATES.items()}

# the one rate ordering of the mixed-rate decode (rate_idx indexes it)
RATE_MBPS_ORDER = tuple(sorted(RATES))
RATE_INDEX = {m: i for i, m in enumerate(RATE_MBPS_ORDER)}
MAX_DBPS = max(p.n_dbps for p in RATES.values())     # 216 (54 Mbps)

N_SERVICE_BITS = 16
N_TAIL_BITS = 6


def n_symbols(length_bytes: int, rate: RateParams) -> int:
    """Number of DATA OFDM symbols for a PSDU of `length_bytes`."""
    n_bits = N_SERVICE_BITS + 8 * length_bytes + N_TAIL_BITS
    return -(-n_bits // rate.n_dbps)
