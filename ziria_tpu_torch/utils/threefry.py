"""Threefry-2x32 counter-based random numbers: the parts of
``jax.random`` the reference's channel calls, bit for bit.

The reference draws every noise sample from ``jax.random`` with the
threefry PRNG in its partitionable mode (``jax_threefry_partitionable``
on, the default of current jax): a key is two uint32 words, ``fold_in``
and ``split`` hash a counter under the key, and ``bits`` hashes each
element's row-major flat index. This module computes the same words
with integer tensor ops, so the port's channel draws the reference's
own noise, lane for lane, on any device.

A key is an int64 tensor ``(..., 2)`` holding two uint32 values; every
add is done in int64 and masked to 32 bits. ``bits``, ``uniform`` and
``normal`` take a batch of keys ``(R, 2)`` and return ``(R, *shape)``:
row r is what ``jax.random.<fn>(key[r], shape)`` returns. ``normal`` is
``erfinv(u) * sqrt(2)`` on the reference's uniform ``u`` in
``[nextafter(-1, 0), 1)``, with XLA's erfinv polynomial (:func:`erfinv`):
its logarithm may differ from XLA's in the last bit, so a normal may
differ by up to 2 ulp; the integer draws and the uniforms never do.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1)
    under key words (k0, k1); all int64 tensors of uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) = (seed >> 32, seed & M32)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an int
    tensor broadcast against the key's batch (a uint32 value) ->
    (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], i >> 32, i & M32)
    return torch.stack([y0, y1], -1)


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for each key of
    (R, 2): (R, *shape) int64. The counter is the row-major flat index
    split into its high and low words; the word is their hashes'
    XOR."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], i >> 32, i & M32)
    return (y0 ^ y1).reshape((keys.shape[0],) + shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) for each key of (R, 2):
    (R, *shape). The 23 high bits of each word become a float in
    [1, 2), less 1, scaled to [minval, maxval)."""
    b = bits(keys, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' single-precision erfinv, the approximation XLA lowers erf_inv
# to: a degree-8 polynomial in w = -log1p(-x^2) - 2.5 below w = 5, in
# sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p: a Cephes rational below |x| = sqrt(2) - 1, log(1 + x)
# above, with the Cephes/Eigen float32 log
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once (the float64 product is exact, and
    the sum rounded twice agrees with one rounding but for rare ties:
    XLA contracts these into FMAs). b and c: float32 tensors or
    floats that float32 holds exactly."""
    def d(v):
        return v.double() if torch.is_tensor(v) else v
    return (a.double() * d(b) + d(c)).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


def _log_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 log of positive x as the Cephes/Eigen polynomial XLA's
    CPU backend uses."""
    m, e = torch.frexp(x)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    y = m - 1.0
    e = e - small.float()
    y = y + torch.where(small, m, torch.zeros_like(m))
    y2 = y * y
    y3 = y2 * y
    p = [_fma(torch.full_like(y, _f32(_LOG_P[i])), y, _f32(_LOG_P[i + 1]))
         for i in (0, 3, 6)]
    p = [_fma(p[k], y, _f32(_LOG_P[3 * k + 2])) for k in range(3)]
    q = _fma(_fma(p[0], y3, p[1]), y3, p[2]) * y3
    q = q + e * _f32(-2.12194440e-4)
    y = (y - y2 * 0.5) + q
    return y + e * _f32(0.693359375)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA computes it."""
    x2 = x * x
    num = torch.full_like(x, _f32(_LOG1P_NUM[0]))
    den = torch.full_like(x, _f32(_LOG1P_DEN[0]))
    for a, b in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
        num = _fma(num, x, _f32(a))
        den = _fma(den, x, _f32(b))
    small = _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < 0.41421356237309504880, x + small,
                       _log_xla(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA's CPU backend computes it (within 2 ulp
    of ``jax.lax.erf_inv``): Giles' polynomial over XLA's log1p, each
    Horner step one fused multiply-add, +-inf at +-1."""
    w = -_log1p_xla(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device
    coef = [torch.where(lt, torch.tensor(_f32(a), device=dev),
                        torch.tensor(_f32(b), device=dev))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` (float32) for each key of (R, 2):
    (R, *shape)."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * _SQRT2


def randint(keys: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` (int32) for each key of (R, 2), with
    minval and maxval ints or (R,) tensors: (R, *shape) int64. Two
    words a value, from the key's two split halves, combined modulo
    the span in uint32 arithmetic as jax does (span 1 where maxval <=
    minval)."""
    r = keys.shape[0]
    halves = split(keys, 2)
    hi = bits(halves[:, 0], shape)
    lo = bits(halves[:, 1], shape)
    dev = keys.device
    lead = (r,) + (1,) * len(tuple(shape))
    minval = torch.as_tensor(minval, dtype=torch.int64,
                             device=dev).expand(r).reshape(lead)
    maxval = torch.as_tensor(maxval, dtype=torch.int64,
                             device=dev).expand(r).reshape(lead)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & M32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((hi % span) * mult) & M32
    off = ((off + lo % span) & M32) % span
    return minval + off

