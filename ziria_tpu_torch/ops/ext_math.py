"""Fixed-point math library: the reference's ext_math.c equivalents
(counterpart of ziria_tpu/ops/ext_math.py).

The reference binds C `ext` functions for fixed-point trig/math
(`csrc/ext_math.c` + `sora_ext_lib.c`, SURVEY.md §2.2): sine/cosine/
atan2 over int16 angles, sqrt, log, LUT-backed where the bit-width is
small, because the SDR pipelines do phase tracking and CFO correction
in int16 Q-format, not doubles.

- angles are int16 in the **Q15 turn format**: -32768..32767 maps to
  -pi..pi (wrap-around is phase wrap, so angle arithmetic is plain
  int16 add/sub);
- `sin_int16`/`cos_int16` return Q14 (-16384..16384 for -1..1) from a
  1024-entry LUT gather;
- `atan2_int16` returns the Q15 turn angle from int16 (y, x) by the
  pure-integer CORDIC of ops/fxp, bit-identical on every device;
- `usqrt`/`ulog2` integer helpers mirror the reference's integer math.

Every function follows the externals' convention: numpy in, numpy out
for host values; torch in, torch out for tensors (on their device),
batch-polymorphic under the lane-vector loop and ``torch.func.vmap``.
They are registered as frontend externals, so `.zir` sources can
declare e.g. `ext fun sin_int16(x: int16) : int16`.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.frontend.externals import (_on_device,
                                                register_external)
from ziria_tpu_torch.ops import fxp

_Q15_PI = 32768.0           # int16 angle units per pi radians
_Q14_ONE = 16384.0          # unit amplitude

_SIN_BITS = 10              # 1024-entry LUT: step = 2pi/65536*64 rad
_SIN_N = 1 << _SIN_BITS

_SIN_LUT = np.round(
    _Q14_ONE * np.sin(2.0 * np.pi * np.arange(_SIN_N) / _SIN_N)
).astype(np.int16)


def _tensors(args):
    """Host values of a device call as tensors beside its tensors, each
    in its own dtype (externals._targs casts all to a common dtype;
    these bodies cast each argument themselves)."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    return [a if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a), device=dev) for a in args]


def _host_or_device(fn):
    """Run the torch body `fn` on tensors as they are, and on host
    values through CPU tensors, handing numpy back."""
    def wrapper(*args):
        if _on_device(args):
            return fn(*_tensors(args))
        out = fn(*[torch.as_tensor(np.asarray(a)) for a in args])
        return out.numpy()
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


# --------------------------------------------------------------------------
# Q15 angle helpers
# --------------------------------------------------------------------------


def rad_to_q15(theta) -> np.ndarray:
    """Radians -> int16 turn angle (host-side helper for tests/config)."""
    t = np.asarray(theta, np.float64) / (2 * np.pi)
    t = t - np.round(t)
    return np.round(t * 65536.0).astype(np.int64).astype(np.int16)


def q15_to_rad(a):
    return np.asarray(a, np.float64) * (np.pi / _Q15_PI)


# --------------------------------------------------------------------------
# sine / cosine (LUT gather)
# --------------------------------------------------------------------------


def _sin_at(a: torch.Tensor, offset: int) -> torch.Tensor:
    """LUT sine of the int16 angle a + offset (mod 2^16): the index is
    the top 10 bits of the angle's 16-bit pattern."""
    idx = ((a.to(torch.int16).to(torch.int32) + offset) & 0xFFFF) \
        >> (16 - _SIN_BITS)
    lut = fxp._const("sin_lut", a.device,
                     lambda d: torch.from_numpy(_SIN_LUT).to(d))
    return lut[idx.to(torch.int64)]


@_host_or_device
def sin_int16(a):
    """Q14 sine of a Q15 turn angle (int16 -> int16).

    LUT index = top 10 bits of the 16-bit angle; max error vs the real
    sine is one LUT step (~0.4% of full scale), same order as the
    reference's table-based fixed-point sine.
    """
    return _sin_at(a, 0)


@_host_or_device
def cos_int16(a):
    # cos x = sin(x + pi/2); +16384 wraps naturally in int16
    return _sin_at(a, 16384)


def sincos_int16(a):
    return sin_int16(a), cos_int16(a)


# --------------------------------------------------------------------------
# atan2 (pure-integer CORDIC, Q15 result)
# --------------------------------------------------------------------------


@_host_or_device
def atan2_int16(y, x):
    """Q15 turn angle of (y, x): int16 in, int16 out.

    Pure-integer CORDIC vectoring (ops/fxp.cordic_atan2), so the result
    is bit-identical on every device. Inputs are pre-scaled by 2^12
    (angle-invariant; full int16 inputs stay inside the vectoring
    bound) so shift truncation stays below a couple of Q15 steps even
    for unit-magnitude vectors."""
    ang, _mag = fxp.cordic_atan2(y.to(torch.int32) << 12,
                                 x.to(torch.int32) << 12)
    return ang.to(torch.int16)


# --------------------------------------------------------------------------
# integer sqrt / log2 (reference integer-math helpers)
# --------------------------------------------------------------------------


@_host_or_device
def usqrt(x):
    """floor(sqrt(x)) for non-negative int32, exact (-1 for negative
    x, as the reference gives).

    The rounded float estimate is refined by +-1 with integer compares
    (truncating division, the reference's ``lax.div``), so the result
    does not depend on the float sqrt's last bit."""
    x = x.to(torch.int32)
    r = torch.sqrt(torch.clamp(x, min=0).to(torch.float64)).to(torch.int32)
    # r*r > x  <=>  r > x // r  (r^2 would overflow int32 at the top of
    # the range, x // r never does)
    rp = r + 1
    r = torch.where(rp <= torch.div(x, torch.clamp(rp, min=1),
                                    rounding_mode="trunc"), rp, r)
    r = torch.where(r > torch.div(x, torch.clamp(r, min=1),
                                  rounding_mode="trunc"), r - 1, r)
    return r


@_host_or_device
def ulog2(x):
    """floor(log2(x)) for positive int32 (0 for x <= 1)."""
    v = x.to(torch.int32)
    n = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):       # unrolled binary search
        big = v >= (1 << shift)
        n = torch.where(big, n + shift, n)
        v = torch.where(big, v >> shift, v)
    return n


# --------------------------------------------------------------------------
# frontend externals registration
# --------------------------------------------------------------------------


def _ext_c64_to_pair(x):
    """complex16 ext boundary -> exact int32 IQ pairs (values at the
    boundary are integer-valued complex64; see dft64_fxp)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.is_complex():
        return torch.stack([torch.round(t.real).to(torch.int32),
                            torch.round(t.imag).to(torch.int32)], dim=-1)
    return torch.round(t).to(torch.int32)     # pair layout (defensive)


def _ext_pair_to_c64(out):
    return torch.complex(out[..., 0].to(torch.float32),
                         out[..., 1].to(torch.float32))


@_host_or_device
def dft64_fxp(x):
    """Integer 64-pt DFT brick for fixed-point programs: the fxp
    counterpart of the `v_fft` ext (the reference's SORA FFT was
    itself fixed-point). Declared `ext fun dft64_fxp(x: arr[64]
    complex16) : arr[64] complex16`.

    At the ext boundary complex16 arrives as complex64 carrying exact
    int16 IQ; this converts back to integer pairs, runs
    ops/fxp.dft64_q14 (split-Q14 DFT, shift 10: output = DFT * 2^-3),
    and returns integer-valued complex so the requantize wrap at the
    boundary is exact."""
    return _ext_pair_to_c64(fxp.dft64_q14(_ext_c64_to_pair(x), shift=10))


@_host_or_device
def idft64_fxp(x):
    """Integer OFDM symbol synthesis brick for fixed-point programs:
    inverse DFT with the 802.11 TIME_SCALE/64 folded into the split
    Q14 twiddles (ops/fxp.idft64_wifi_q14): integer bins at wire scale
    in, integer time samples at the same wire scale out. Declared
    `ext fun idft64_fxp(x: arr[64] complex16) : arr[64] complex16`."""
    return _ext_pair_to_c64(fxp.idft64_wifi_q14(_ext_c64_to_pair(x)))


def register() -> None:
    for name, fn in (
        ("sin_int16", sin_int16),
        ("cos_int16", cos_int16),
        ("atan2_int16", atan2_int16),
        ("usqrt", usqrt),
        ("ulog2", ulog2),
        ("dft64_fxp", dft64_fxp),
        ("idft64_fxp", idft64_fxp),
    ):
        register_external(name, fn)


register()
