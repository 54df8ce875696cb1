"""Real-pair complex arithmetic and matmul DFTs (counterpart of
ziria_tpu/ops/cplx.py).

Samples are ``(..., 2)`` float32 pairs, ``p[..., 0]`` real and
``p[..., 1]`` imaginary, as in the reference. The 64-point DFT is a
pair of float32 matmuls against cached DFT matrices, as in the
reference (which runs them at ``Precision.HIGHEST``): on the card
those matmuls must not run in TF32, which :func:`exact_fp32` ensures.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch


@contextlib.contextmanager
def exact_fp32():
    """Run the body with TF32 off for cuBLAS matmuls and cuDNN
    convolutions, restoring both flags after. TF32 keeps ~3 decimal
    digits and would move the DFT outputs far past the reference's
    float32 agreement; the receive and transmit entry points run
    inside this."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def cpack(re, im):
    return torch.stack([re, im], dim=-1)


def cre(p):
    return p[..., 0]


def cim(p):
    return p[..., 1]


def conj(p):
    return torch.stack([p[..., 0], -p[..., 1]], dim=-1)


def cmul(a, b):
    """Elementwise complex multiply of pair tensors."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def cmul_conj(a, b):
    """a * conj(b)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ai * br - ar * bi], dim=-1)


def cscale(p, s):
    """Pairs scaled by real factors `s` (broadcast over the pair
    axis)."""
    return p * torch.as_tensor(s, dtype=p.dtype, device=p.device)[..., None]


def cabs2(p):
    return p[..., 0] ** 2 + p[..., 1] ** 2


def cdiv(a, b, eps: float = 1e-12):
    """a / b (pairwise); eps regularizes |b|^2 so a zero divisor yields
    0, not NaN."""
    num = cmul_conj(a, b)
    den = cabs2(b) + eps
    return num / den[..., None]


def cexp(theta):
    """Unit phasor pairs from angles."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def cangle(p):
    return torch.atan2(p[..., 1], p[..., 0])


# ----------------------------------------------------------------- dft

@lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool):
    """(cos, sin) DFT matrices as float32 numpy arrays, built in float64
    exactly as the reference builds them."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    sign = 1.0 if inverse else -1.0
    c = np.cos(ang).astype(np.float32)
    s = (sign * np.sin(ang)).astype(np.float32)
    if inverse:
        c /= n
        s /= n
    return c, s


@lru_cache(maxsize=None)
def _dft_mats_t(n: int, inverse: bool, device: torch.device):
    """The transposed matrices as tensors on `device`, built once."""
    c, s = _dft_mats(n, inverse)
    return (torch.from_numpy(np.ascontiguousarray(c.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(s.T)).to(device))


#: rows of each DFT matmul, by device type. Every product runs at this
#: one shape (the rows zero-padded to whole blocks), so each row is
#: summed in one order whatever the rows around it: a BLAS picks its
#: kernel by the row count (MKL's one-row path, cuBLAS's tiles and
#: split-K), and a fleet lane's soft values would otherwise differ in the
#: last bits from its lone receiver's.
DFT_BLOCK_ROWS = {"cpu": 64, "cuda": 16384}


def dft_pair(p, inverse: bool = False, axis: int = -2):
    """DFT along `axis` of a pair tensor (an axis of the whole tensor,
    as in the reference; default the one right before the re/im axis).
    numpy-fft convention: forward unscaled, inverse scaled by 1/n. A
    row's values do not depend on the batch (:data:`DFT_BLOCK_ROWS`):
    another axis is moved before the re/im axis and back around the
    same fixed row blocks."""
    if axis != -2:
        return dft_pair(torch.movedim(p, axis, -2), inverse).movedim(-2, axis)
    n = p.shape[-2]
    ct, st = _dft_mats_t(n, inverse, p.device)
    x = p.reshape(-1, n, 2)
    m = x.shape[0]
    blk = DFT_BLOCK_ROWS.get(p.device.type, DFT_BLOCK_ROWS["cpu"])
    pad = -m % blk
    if pad:
        x = torch.cat([x, x.new_zeros((pad, n, 2))])
    xr, xi = x[..., 0].contiguous(), x[..., 1].contiguous()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    for lo in range(0, m + pad, blk):
        a, b = xr[lo:lo + blk], xi[lo:lo + blk]
        # W = C + iS; y = W x
        torch.mm(a, ct, out=yr[lo:lo + blk]).sub_(b @ st)
        torch.mm(a, st, out=yi[lo:lo + blk]).add_(b @ ct)
    return torch.stack([yr[:m], yi[:m]], dim=-1).reshape(p.shape)


def fft_pair(p, axis: int = -2):
    return dft_pair(p, inverse=False, axis=axis)


def ifft_pair(p, axis: int = -2):
    return dft_pair(p, inverse=True, axis=axis)


def from_complex(c) -> np.ndarray:
    """complex numpy array -> float32 pair array (host constants)."""
    c = np.asarray(c)
    return np.stack([c.real, c.imag], axis=-1).astype(np.float32)


def to_complex(p):
    """Pair tensor (or array) -> complex64 tensor (or numpy array)."""
    if isinstance(p, torch.Tensor):
        return torch.complex(p[..., 0].float(), p[..., 1].float())
    p = np.asarray(p)
    return (p[..., 0] + 1j * p[..., 1]).astype(np.complex64)
