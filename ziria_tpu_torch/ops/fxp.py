"""Q15 fixed-point DSP primitives: the integer compute core of the
fixed-point RX interior (phy/wifi/rx_fxp.py); counterpart of
ziria_tpu/ops/fxp.py.

Counterpart of the reference's fixed-point SORA bricks (SURVEY.md §2.2:
`csrc/ext_math.c`, the SSE FFT, and the fixed-point demapper inside the
RX chain): the reference ran its whole PHY in int16 "complex16" math
with LUT trig. The rules kept from the JAX package:

- all arithmetic is int32 adds/muls/shifts on (..., 2) IQ pairs, so
  results are **bit-identical across devices, batch widths and
  backends**: shifts of negative int32 are arithmetic and products wrap
  at 32 bits, on the CPU and the card alike, as XLA's do;
- the DFT is a product against split Q14 twiddles (hi/lo factors). The
  reference takes it as int32 GEMMs; PyTorch has no int32 matmul on
  CUDA, so here the same products run in float64, where every partial
  sum is an integer below 2^53 and therefore exact, and come back to
  int32 before the rounding shift;
- trig is pure-integer CORDIC (vectoring for atan2/magnitude, rotation
  for derotation); ext_math.atan2_int16 delegates to the vectoring
  kernel here.

Number formats (documented per function): int16 at API boundaries,
int32 inside; shifts use round-half-up (`rsra`), the single rounding
rule of the whole module. Functions take tensors (numpy is accepted and
becomes a CPU tensor) and return tensors on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I16 = torch.int16

Q15_HALF_TURN = 32768          # int16 turn angle units per pi radians
CORDIC_ITERS = 16              # gain K = prod sqrt(1 + 2^-2i) ~ 1.64676

# atan(2^-i) in Q15 turn units (host-side table; exact integers)
_CORDIC_ANGLES = np.round(
    np.arctan(2.0 ** -np.arange(CORDIC_ITERS))
    * (Q15_HALF_TURN / np.pi)).astype(np.int32)
_ANGLES = [int(a) for a in _CORDIC_ANGLES]

_CONST_CACHE: dict = {}


def _const(key, device: torch.device, build):
    """Device-constant memo, one entry per (key, device). A constant
    built inside ``torch.func.vmap`` (the compiler's jit lowering) is an
    ordinary tensor, so caching it is always safe."""
    k = (key, str(device))
    v = _CONST_CACHE.get(k)
    if v is None:
        v = _CONST_CACHE[k] = build(device)
    return v


def _i32(x, device=None) -> torch.Tensor:
    """`x` as an int32 tensor (numpy and Python values land on `device`,
    the CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(I32)
    return torch.as_tensor(np.asarray(x), device=device).to(I32)


def rsra(x, s: int):
    """Rounding arithmetic right shift (round half up): the module's
    one rounding rule. s == 0 is the identity."""
    x = _i32(x)
    if s == 0:
        return x
    return (x + (1 << (s - 1))) >> s


def sat16(x):
    """Saturate int32 to the int16 range (stays int32 dtype)."""
    return torch.clamp(_i32(x), -32768, 32767)


def quantize_q(x, frac_bits: int):
    """Float -> int32 Q(frac_bits) with round-half-up + int16
    saturation. The fixed-point boundary for float-domain captures.
    NaN quantizes to 0 and +-inf saturates to the rails. The value is
    clamped in float before the cast (torch's cast of an out-of-range
    float differs between the CPU and the card); that equals the
    reference's cast-then-saturate wherever the cast is defined."""
    x = torch.as_tensor(x).to(torch.float32) \
        if not isinstance(x, torch.Tensor) else x.to(torch.float32)
    x = torch.nan_to_num(x, nan=0.0, posinf=32767.0, neginf=-32768.0)
    y = torch.floor(x * float(1 << frac_bits) + 0.5)
    return torch.clamp(y, -32768.0, 32767.0).to(I32)


# --------------------------------------------------------------- CORDIC

def cordic_atan2(y, x):
    """Pure-integer CORDIC vectoring: Q15 turn angle of (y, x).

    Inputs int32 with |x|,|y| <= 2^28 (the x1.6467*sqrt(2) growth must
    stay inside int32). Returns (angle_q15 int32 in [-32768, 32767],
    magnitude int32 ~= 1.6467 * sqrt(x^2 + y^2)).
    Angle error <= ~2 Q15 steps at large magnitudes; exactly
    reproducible everywhere.
    """
    dev = x.device if isinstance(x, torch.Tensor) else (
        y.device if isinstance(y, torch.Tensor) else None)
    x, y = torch.broadcast_tensors(_i32(x, dev), _i32(y, dev))
    # quadrant fold: CORDIC converges for |angle| <= ~0.55 half-turns
    neg_x = x < 0
    z = ((neg_x & (y >= 0)).to(I32) - (neg_x & (y < 0)).to(I32)) \
        * Q15_HALF_TURN
    xc = torch.where(neg_x, -x, x)
    yc = torch.where(neg_x, -y, y)
    for i in range(CORDIC_ITERS):
        d_pos = yc >= 0                       # rotate towards y == 0
        xs, ys = xc >> i, yc >> i
        a = _ANGLES[i]
        xc, yc, z = (torch.where(d_pos, xc + ys, xc - ys),
                     torch.where(d_pos, yc - xs, yc + xs),
                     torch.where(d_pos, z + a, z - a))
    # wrap into the int16 turn range (z can reach +-(32768 + eps));
    # the degenerate (0, 0) input has no angle: pin it to 0 (the
    # iterations above would otherwise sum the whole angle table)
    z = ((z + Q15_HALF_TURN) & 0xFFFF) - Q15_HALF_TURN
    z = torch.where((x == 0) & (y == 0), torch.zeros_like(z), z)
    return z, xc


def cordic_rotate(pair, angle_q15, kinv_bits: int = 15):
    """Pure-integer CORDIC rotation of IQ `pair` (..., 2) by a Q15 turn
    angle (broadcastable to pair[..., 0]).

    The x1.6467 CORDIC gain is compensated up front by the
    Q(kinv_bits) reciprocal; the compensation multiply is the input
    limit: |re|,|im| < 2^31 / ceil(2^kinv_bits / 1.6467). kinv_bits=15
    (default) allows ~2^16.7 inputs at ~3e-5 gain error; kinv_bits=10
    allows ~2^21.7 at ~8e-4. Result is the rotated input at unchanged
    scale; worst-case error ~1e-3 relative (angle-table rounding) + the
    gain-reciprocal error."""
    p = _i32(pair)
    a = _i32(angle_q15, p.device)
    kinv = int(round((1 << kinv_bits) / 1.646760258121))
    # pre-compensate the gain while magnitudes are smallest
    x = rsra(p[..., 0] * kinv, kinv_bits)
    y = rsra(p[..., 1] * kinv, kinv_bits)
    # quadrant fold to the convergence range
    big = a.abs() > (Q15_HALF_TURN // 2)
    x = torch.where(big, -x, x)
    y = torch.where(big, -y, y)
    z = torch.where(big, a - torch.sign(a) * Q15_HALF_TURN, a)
    for i in range(CORDIC_ITERS):
        d_pos = z >= 0                        # rotate residual to zero
        xs, ys = x >> i, y >> i
        ang = _ANGLES[i]
        x, y, z = (torch.where(d_pos, x - ys, x + ys),
                   torch.where(d_pos, y + xs, y - xs),
                   torch.where(d_pos, z - ang, z + ang))
    return torch.stack([x, y], dim=-1)


# ------------------------------------------------- integer DFT (matmul)

def _dft_twiddles_q14(n: int, inverse: bool = False,
                      scale: float = 1.0):
    """DFT matrix exp(-+2*pi*i*j*k/n) * scale in Q14, split into
    (hi, lo) int factors with W == hi * 128 + lo, |hi| <= 128 and
    lo in [0, 127] (hi reaches +128 for the unit twiddle). The split
    keeps every 64-term sum of the reference's int32 GEMMs inside
    int32 (64 * 2^15 * 2^14 would need 36 bits unsplit)."""
    jk = np.outer(np.arange(n), np.arange(n))
    w = np.exp((2j if inverse else -2j) * np.pi * jk / n) * scale
    wq = np.round(w.real * (1 << 14)).astype(np.int32), \
        np.round(w.imag * (1 << 14)).astype(np.int32)
    out = []
    for m in wq:
        hi = m >> 7                       # arithmetic: lo in [0, 127]
        lo = m - (hi << 7)
        out.append((hi.astype(np.int32), lo.astype(np.int32)))
    return out  # [(re_hi, re_lo), (im_hi, im_lo)]


_TW64 = _dft_twiddles_q14(64)
# inverse twiddles with the 802.11 OFDM time scale folded in:
# time = IDFT_sum(bins) * (TIME_SCALE / 64) = IDFT_sum / sqrt(52)
_ITW64_WIFI = _dft_twiddles_q14(64, inverse=True,
                                scale=1.0 / np.sqrt(52.0))


def _gemm_q14(x, hi, lo):
    """x (..., 64) int32 @ split-Q14 matrix -> int32, result scaled by
    2^-7 (the lo half is rounded in, then the hi half is added at its
    natural 2^7 weight): (x @ hi) + rsra(x @ lo, 7). The products run
    in float64: for |x| <= 2^15, |hi| <= 128 and lo <= 127 every
    partial sum over 64 terms stays below 2^28, an integer that float64
    holds exactly in any summation order."""
    x = _i32(x)
    hi = torch.as_tensor(hi, device=x.device).to(torch.float64)
    lo = torch.as_tensor(lo, device=x.device).to(torch.float64)
    xd = x.to(torch.float64)
    return (xd @ hi).to(I32) + rsra((xd @ lo).to(I32), 7)


def _split_table(table, device):
    """[(re_hi, re_lo), (im_hi, im_lo)] -> float64 (hi, lo) matrices
    (64, 128) on `device`, the real part's columns first."""
    (rh, rl), (ih, il) = table
    return tuple(torch.from_numpy(np.concatenate(m, axis=1)).to(
        device=device, dtype=torch.float64) for m in ((rh, ih), (rl, il)))


def _cdft_q14(pair, key: str, table, shift: int):
    """The one complex split-Q14 product shared by the forward and
    inverse DFTs. The real and imaginary inputs go through one product
    each with the real and imaginary twiddles side by side, the same
    four 64-term sums per bin as the reference's four GEMMs."""
    p = _i32(pair)
    hi, lo = _const(key, p.device, lambda d: _split_table(table, d))
    n = hi.shape[0]
    xr = _gemm_q14(p[..., 0], hi, lo)       # (..., 128): xr@W_re | xr@W_im
    xi = _gemm_q14(p[..., 1], hi, lo)
    re = xr[..., :n] - xi[..., n:]
    im = xr[..., n:] + xi[..., :n]
    return torch.stack([rsra(re, shift), rsra(im, shift)], dim=-1)


def dft64_q14(pair, shift: int = 7):
    """Integer 64-point DFT of int IQ pairs (..., 64, 2) against split
    Q14 twiddles.

    Input |values| <= 2^15 (int16-range). Output = DFT(x) * 2^(7-shift)
    (the twiddle Q14 scale minus the internal 2^-7, minus `shift` more
    rounding bits). shift=7 returns the unnormalized DFT at input
    scale: bins = sum_n x[n] w^(nk) exactly (to the documented
    rounding)."""
    return _cdft_q14(pair, "tw64", _TW64, shift)


def idft64_wifi_q14(pair):
    """Integer 64-point OFDM symbol synthesis: inverse DFT with the
    802.11 time scale folded into the twiddles:
    out = round-ish(IDFT_sum(bins) / sqrt(52)), i.e. integer bins at
    wire scale S produce time samples at the same wire scale the f32
    chain's ifft * TIME_SCALE * S produces. Same split-Q14 machinery
    (and rounding rule) as the forward dft64_q14."""
    return _cdft_q14(pair, "itw64", _ITW64_WIFI, 7)


# ------------------------------------------------------ pair arithmetic

def cmul_conj_i32(a, b, shift: int):
    """a * conj(b) for int IQ pairs, each product rsra'd by `shift`
    BEFORE the add so intermediates stay in int32 when
    |a|*|b| <= 2^30."""
    a = _i32(a)
    b = _i32(b, a.device)
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    re = rsra(ar * br, shift) + rsra(ai * bi, shift)
    im = rsra(ai * br, shift) - rsra(ar * bi, shift)
    return torch.stack([re, im], dim=-1)


def cabs2_i32(p, shift: int):
    """|p|^2 for int IQ pairs with the same pre-add rounding shift."""
    p = _i32(p)
    return (rsra(p[..., 0] * p[..., 0], shift)
            + rsra(p[..., 1] * p[..., 1], shift))


def isqrt_u32(x):
    """Integer floor square root of non-negative int32 (bitwise
    restoring method, 16 fixed iterations: exact)."""
    rem = _i32(x)
    res = torch.zeros_like(rem)
    for i in range(16):
        bit = 1 << (30 - 2 * i)
        take = rem >= res + bit
        rem = torch.where(take, rem - (res + bit), rem)
        res = torch.where(take, (res >> 1) + bit, res >> 1)
    return res
