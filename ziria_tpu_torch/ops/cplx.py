"""Real-pair complex arithmetic and matmul DFTs (counterpart of
ziria_tpu/ops/cplx.py).

Samples are ``(..., 2)`` float32 pairs, ``p[..., 0]`` real and
``p[..., 1]`` imaginary, as in the reference. The 64-point DFT is a
pair of float32 matmuls against cached DFT matrices, as in the
reference. Those products run in IEEE float32 whatever precision the
caller has set for torch (:func:`exact_fp32`).
"""

from __future__ import annotations

import contextlib
import threading
from functools import lru_cache

import numpy as np
import torch

#: the per-backend float32 precision settings of torch's newer API
#: that :func:`exact_fp32` holds at ``"ieee"``: (backend, op)
FP32_FLAGS = (("cuda", "matmul"), ("cudnn", "conv"),
              ("mkldnn", "matmul"), ("mkldnn", "conv"))


@lru_cache(maxsize=None)
def precision_handles():
    """The objects whose ``fp32_precision`` is each of
    :data:`FP32_FLAGS`, or None where this torch has only the legacy
    ``allow_tf32`` flags."""
    hs = []
    for backend, op in FP32_FLAGS:
        h = getattr(getattr(torch.backends, backend), op, None)
        if h is None or not hasattr(h, "fp32_precision"):
            return None
        hs.append(h)
    return tuple(hs)


def _set_ieee():
    """Set every float32 product setting to IEEE; return the callable
    that puts the caller's settings back. Under the newer API it reads
    and writes only that API: once a caller has used it, a read of a
    legacy flag (or ``torch.get_float32_matmul_precision()``) raises."""
    hs = precision_handles()
    if hs is not None:
        saved = [h.fp32_precision for h in hs]
        for h in hs:
            h.fp32_precision = "ieee"

        def restore():
            for h, v in zip(hs, saved):
                h.fp32_precision = v
        return restore
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def restore():
        # the matmul precision sets cuBLAS's allow_tf32 with it
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn
    return restore


# The settings are process-wide, and guarded work runs nested
# (framebatch into rx) and on several threads at once (frame batching,
# the server): the first entry saves and sets, the last exit restores.
_guard = threading.Lock()
_depth = 0
_restore = None


@contextlib.contextmanager
def exact_fp32():
    """Run the body with every float32 matmul and convolution in IEEE
    float32: no TF32 on cuBLAS or cuDNN, no bf16 or TF32 in oneDNN on
    the CPU, whatever the caller set through either of torch's APIs
    (``torch.set_float32_matmul_precision``, the legacy ``allow_tf32``
    flags, the per-backend ``fp32_precision``). The caller's settings
    read the same after as before.

    The contract is the port's tests': float32 agreement with the
    reference run on the CPU (rtol = atol = 1e-5), bit for bit where
    the reference pins bits. The reference's DFT is a plain ``@`` at
    JAX's default precision, exact because it is held on the CPU; TF32
    keeps ~3 decimal digits and bf16 ~2, far outside that tolerance.
    The entry points and every float32 product site run inside this.

    Safe to nest and across threads: one process-wide depth count under
    a lock, so a thread that leaves while another is inside leaves the
    settings at IEEE."""
    global _depth, _restore
    with _guard:
        if _depth == 0:
            _restore = _set_ieee()
        _depth += 1
    try:
        yield
    finally:
        with _guard:
            _depth -= 1
            if _depth == 0:
                restore, _restore = _restore, None
                restore()


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
    with exact_fp32():
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
