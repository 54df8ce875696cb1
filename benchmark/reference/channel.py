"""The frozen channel of the benchmark: carrier frequency offset and
complex white Gaussian noise, in plain PyTorch on the device.

Frozen from the channel that the port's ``chip_smoke.make_captures`` and
``make_stream`` apply at commit 33779fc (``z *= exp(1j * eps * n)``, then
noise at an SNR referenced to the transmitter's unit sample power). The
phase is taken in float64, so a sample far into a stream carries the
same rotation as one near its start.
"""

from __future__ import annotations

import numpy as np
import torch


def noise_sigma(snr_db: float) -> float:
    """Per-axis noise deviation at `snr_db` over unit signal power."""
    return float(np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0))


def impair(z: torch.Tensor, eps: torch.Tensor, snr_db: float,
           gen: torch.Generator) -> torch.Tensor:
    """Rows of complex samples (R, n) -> (R, n, 2) float32 pairs: row r
    rotated by eps[r] rad/sample from its sample 0, plus noise."""
    n = torch.arange(z.shape[1], device=z.device, dtype=torch.float64)
    ph = eps.to(torch.float64)[:, None] * n[None, :]
    rot = torch.polar(torch.ones_like(ph), ph)
    out = torch.view_as_real((z.to(torch.complex128) * rot)
                             .to(torch.complex64)).contiguous()
    out += noise_sigma(snr_db) * torch.randn(
        out.shape, generator=gen, device=z.device, dtype=torch.float32)
    return out
