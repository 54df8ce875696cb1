"""Externals registry: the frontend's `ext fun` binding surface
(counterpart of ziria_tpu/frontend/externals.py).

Counterpart of the reference's `lib/` ext declarations binding SORA C
functions into the language (SURVEY.md §2.3) — here each name binds to a
numpy implementation for host values and a torch one for tensors, so
`ext fun v_fft(...)` in a source program resolves to `np.fft.fft` or
`torch.fft.fft` instead of a SORA SSE brick. On the card the FFT is
cuFFT's: the golden cases hold its outputs to the interpreter's at
the comparator's tolerances. A program must still
*declare* the ext funs it uses (declarations are checked against this
registry), keeping source files self-describing like the reference's.

Builtins (`length`, `abs`, ...) are available without declaration.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ziria_tpu_torch.utils import dispatch

#: launches of viterbi_soft's device decode paths since the last reset:
#: "scan" (ops/viterbi.viterbi_decode) and "windowed"
#: (ops/viterbi_cuda.viterbi_decode_batch_windowed)
VITERBI_CALLS = {"scan": 0, "windowed": 0, "host": 0}


def _on_device(args) -> bool:
    """torch for any tensor argument, numpy otherwise: the interpreter
    evaluates ext calls on host scalars and arrays in tight per-sample
    loops, and a device block or the jit backend hands tensors in."""
    return any(isinstance(a, torch.Tensor) for a in args)


def _targs(args):
    from ziria_tpu_torch.frontend.eval import _ts
    return _ts(list(args))


def _length(x) -> int:
    shape = np.shape(x)
    if not shape:
        raise ValueError("length() of a scalar")
    return int(shape[0])


def _conj(x: torch.Tensor) -> torch.Tensor:
    """Materialized conjugate (vmap has a batching rule for this form,
    not for conj_physical)."""
    return torch.complex(x.real, -x.imag) if x.is_complex() else x


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt (numpy's): a float32 root through float64
    (torch's vectorized CPU float32 sqrt can be 1 ulp off)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x|; for complex64 numpy's own formula, bit for bit: with
    m = max(|re|, |im|) and r = min / m, m * sqrt(fma(r, r, 1)) (the
    fma through float64)."""
    if x.dtype != torch.complex64:
        return torch.abs(x)
    a, b = x.real.abs(), x.imag.abs()
    m, n = torch.maximum(a, b), torch.minimum(a, b)
    r = (n / m).double()
    out = m * _sqrt((r * r + 1.0).to(torch.float32))
    out = torch.where(m == 0, torch.zeros((), device=x.device), out)
    inf = torch.isinf(a) | torch.isinf(b)
    return torch.where(inf, torch.full((), float("inf"), device=x.device),
                       out)


# numpy names -> torch functions for the elementwise bricks
_TORCH_FN = {"abs": _abs, "minimum": torch.minimum,
             "maximum": torch.maximum, "sqrt": _sqrt,
             "log": torch.log, "exp": torch.exp, "sin": torch.sin,
             "cos": torch.cos, "tan": torch.tan, "arctan": torch.atan,
             "arctan2": torch.atan2, "floor": torch.floor,
             "ceil": torch.ceil,
             "conj": lambda x: _conj(x),
             "add": torch.add, "subtract": torch.sub,
             "multiply": torch.mul}
# numpy's float results for integer inputs; jnp gives float32
_FLOAT_FNS = {"sqrt", "log", "exp", "sin", "cos", "tan", "arctan",
              "arctan2"}


def _t_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.float32)


def _f(fn_name: str) -> Callable:
    def wrapper(*args):
        if _on_device(args):
            ts = _targs(args)
            if fn_name in _FLOAT_FNS:
                ts = [_t_float(t) for t in ts]
            return _TORCH_FN[fn_name](*ts)
        return getattr(np, fn_name)(*[np.asarray(a) for a in args])
    wrapper.__name__ = fn_name
    return wrapper


def _fft(x):
    if _on_device((x,)):
        t = _targs((x,))[0]
        return torch.fft.fft(t.to(torch.complex64)).to(torch.complex64)
    return np.fft.fft(np.asarray(x, np.complex64)).astype(np.complex64)


def _ifft(x):
    if _on_device((x,)):
        t = _targs((x,))[0]
        return torch.fft.ifft(t.to(torch.complex64)).to(torch.complex64)
    return np.fft.ifft(np.asarray(x, np.complex64)).astype(np.complex64)


def _sum(x):
    if _on_device((x,)):
        return torch.sum(_targs((x,))[0], dim=0)
    return np.sum(np.asarray(x), axis=0)


# always available, no declaration needed
BUILTINS: Dict[str, Callable] = {
    "length": _length,
    "abs": _f("abs"),
    "min": _f("minimum"),
    "max": _f("maximum"),
    "sum": _sum,
}

def _v_binop(op_name: str) -> Callable:
    def wrapper(a, b):
        if _on_device((a, b)):
            return _TORCH_FN[op_name](*_targs((a, b)))
        return getattr(np, op_name)(np.asarray(a), np.asarray(b))
    wrapper.__name__ = f"v_{op_name}"
    return wrapper


def _v_shift_right(x, n):
    """Arithmetic right shift of an integer vector — the reference
    `v_shift_right` brick's role (post-multiply renormalization in
    fixed-point chains)."""
    if _on_device((x, n)):
        return torch.bitwise_right_shift(*_targs((x, n)))
    return np.right_shift(np.asarray(x), np.asarray(n))


def _v_shift_left(x, n):
    if _on_device((x, n)):
        return torch.bitwise_left_shift(*_targs((x, n)))
    return np.left_shift(np.asarray(x), np.asarray(n))


def _v_conj_mul(a, b):
    """a * conj(b) elementwise on complex vectors — the correlation
    inner step (reference `v_conj_mul`/`v_mul` pair)."""
    if _on_device((a, b)):
        ta, tb = _targs((a, b))
        return ta * _conj(tb)
    return np.asarray(a) * np.conj(np.asarray(b))


def _v_correlate(x, ref):
    """Sliding cross-correlation of complex `x` against pattern `ref`
    at all full-overlap lags: out[k] = sum_j x[k+j] * conj(ref[j]).
    Reference's correlation brick; out length = len(x) - len(ref) + 1.
    On the device: one product of the (lags, len(ref)) windows of x
    with conj(ref), TF32 off."""
    if _on_device((x, ref)):
        from ziria_tpu_torch.ops.cplx import exact_fp32
        xa, ra = _targs((x, ref))
        ra = _conj(ra)
        with exact_fp32():
            return xa.unfold(0, ra.shape[0], 1) @ ra
    xa = np.asarray(x)
    ra = np.conj(np.asarray(ref))[::-1]
    return np.convolve(xa, ra, mode="valid")


def _v_downsample(x, k):
    if _on_device((x,)):
        return _targs((x,))[0][:: int(k)]
    return np.asarray(x)[:: int(k)]


def _v_sum_window(x, w):
    """Sliding window sum over `w` samples (moving average * w): the
    packet-detect energy window. out[k] = sum x[k:k+w]."""
    if _on_device((x,)):
        xa = _targs((x,))[0]
        c = torch.cumsum(torch.cat([torch.zeros(1, dtype=xa.dtype,
                                                device=xa.device), xa]),
                         0).to(xa.dtype)
    else:
        xa = np.asarray(x)
        c = np.cumsum(np.concatenate([np.zeros(1, xa.dtype), xa]))
    return c[int(w):] - c[: c.shape[0] - int(w)]


def _crc32(bits):
    """802.11 FCS over a bit stream -> 32 CRC bits (transmit order).
    Binds ops/crc.py (the reference's crc.blk role, SURVEY.md §2.3)."""
    from ziria_tpu_torch.ops.crc import crc32_bits
    if not _on_device((bits,)):
        return _np_crc32_bits(np.asarray(bits, np.uint8))
    return crc32_bits(_targs((bits,))[0].to(torch.uint8))


def _np_crc32_bits(bits: np.ndarray) -> np.ndarray:
    """The reference's numpy CRC-32 (ops/crc.np_crc32_bits_ref): the
    LSB-first bit-serial register, its 32 FCS bits in transmission
    order."""
    reg = 0xFFFFFFFF
    for b in bits.astype(np.int64):
        fb = (reg ^ int(b)) & 1
        reg >>= 1
        if fb:
            reg ^= 0xEDB88320
    reg ^= 0xFFFFFFFF
    return np.array([(reg >> i) & 1 for i in range(32)], np.uint8)


def _bits_to_int8(bits):
    """8 LSB-first bits -> one byte value (reference bit.c role)."""
    if not _on_device((bits,)):
        b = np.asarray(bits, np.uint8).reshape(-1, 8).astype(np.int64)
        return (b << np.arange(8)).sum(-1).astype(np.uint8) \
            .astype(np.int8)
    from ziria_tpu_torch.utils.bits import bits_to_bytes
    return bits_to_bytes(_targs((bits,))[0]).to(torch.int8)


def _int8_to_bits(v):
    if not _on_device((v,)):
        b = np.asarray(v, np.uint8).reshape(-1)
        return ((b[:, None] >> np.arange(8, dtype=np.uint8)) & 1) \
            .astype(np.uint8).reshape(-1)
    from ziria_tpu_torch.utils.bits import bytes_to_bits
    return bytes_to_bits(_targs((v,))[0].to(torch.uint8).reshape(-1))


def _round_int(x):
    if _on_device((x,)):
        return torch.round(_t_float(_targs((x,))[0])).to(torch.int32)
    return np.round(np.asarray(x)).astype(np.int32)


# available via `ext fun` declaration (names mirror the reference's lib/)
EXTERNALS: Dict[str, Callable] = {
    "sqrt": _f("sqrt"),
    "log": _f("log"),
    "exp": _f("exp"),
    "sin": _f("sin"),
    "cos": _f("cos"),
    "tan": _f("tan"),
    "atan": _f("arctan"),
    "atan2": _f("arctan2"),
    "round_int": _round_int,
    "floor": _f("floor"),
    "ceil": _f("ceil"),
    "conj": _f("conj"),
    # SORA-style vector DSP (SURVEY.md §2.2 sora_ext_lib.c equivalents)
    "v_fft": _fft,
    "v_ifft": _ifft,
    "fft": _fft,
    "ifft": _ifft,
    "v_add": _v_binop("add"),
    "v_sub": _v_binop("subtract"),
    "v_mul": _v_binop("multiply"),
    "v_conj_mul": _v_conj_mul,
    "v_shift_right": _v_shift_right,
    "v_shift_left": _v_shift_left,
    "v_correlate": _v_correlate,
    "v_downsample": _v_downsample,
    "v_sum_window": _v_sum_window,
    # bit/byte + CRC utilities (reference bit.c / crc.blk roles)
    "crc32": _crc32,
    "bits_to_int8": _bits_to_int8,
    "int8_to_bits": _int8_to_bits,
}


def viterbi_mode() -> tuple:
    """The process-wide decode mode of viterbi_soft: ``(window,
    metric_dtype, radix)`` from ZIRIA_VITERBI_WINDOW /
    ZIRIA_VITERBI_METRIC / ZIRIA_VITERBI_RADIX, read through the
    port's geometry readers (utils/geometry): an unparseable window
    degrades to 0 (off), an unknown metric or radix raises."""
    from ziria_tpu_torch.utils import geometry

    return (geometry.env_viterbi_window(), geometry.env_viterbi_metric(),
            geometry.env_viterbi_radix())


def _viterbi_soft(llrs, npairs, nbits):
    """Block soft-decision Viterbi (K=7, g0=133o/g1=171o) over the first
    `npairs` (A,B) LLR pairs of a padded buffer; returns a bit array of
    half the buffer's length with the `nbits` decoded bits in front.

    The language-level binding of the hot decode kernel — counterpart of
    the reference's `ext` declaration for the SORA Viterbi brick
    (SURVEY.md §2.2/§2.3 `decoding/viterbi.blk`): programs declare

        ext fun viterbi_soft(llrs: arr[N] double, npairs: int32,
                             nbits: int32) : arr[N/2] bit

    A tensor (a device block's frame buffer) decodes where it lies: by
    default with the scan decoder (ops/viterbi.viterbi_decode); under
    --viterbi-window (ZIRIA_VITERBI_WINDOW) a frame longer than the
    window plus both overlaps goes through
    ops/viterbi_cuda.viterbi_decode_batch_windowed, which on a CUDA
    tensor launches the ACS and traceback kernels (or raises). A host
    value decodes with the scan decoder on a CPU tensor, whose bits
    equal the reference's host decode."""
    from ziria_tpu_torch.frontend.eval import _to_host

    if isinstance(npairs, torch.Tensor) or isinstance(nbits, torch.Tensor):
        from ziria_tpu_torch.frontend.eval import _is_batched
        if _is_batched(npairs) or _is_batched(nbits):
            raise TypeError(
                "ext fun viterbi_soft needs lengths that do not differ "
                "per firing; the batch decode is "
                "ops/viterbi_cuda.viterbi_decode_batch")
    npairs = int(np.asarray(_to_host(npairs)))
    nbits = int(np.asarray(_to_host(nbits)))
    from ziria_tpu_torch.ops.viterbi import viterbi_decode
    if isinstance(llrs, torch.Tensor):
        arr = llrs.to(torch.float32)
        win, metric, radix = viterbi_mode()
        from ziria_tpu_torch.ops import viterbi_cuda as _vc
        if win > 0 and npairs > win + 2 * _vc.DEFAULT_WINDOW_OVERLAP:
            # only frames long enough to actually window: short
            # decodes (the 24-step SIGNAL field) keep the scan decoder
            VITERBI_CALLS["windowed"] += 1
            with dispatch.timed("externals.viterbi_windowed"):
                bits = _vc.viterbi_decode_batch_windowed(
                    arr[None, : 2 * npairs], n_bits=nbits, window=win,
                    metric_dtype=metric, radix=radix)[0]
        else:
            VITERBI_CALLS["scan"] += 1
            with dispatch.timed("externals.viterbi_scan"):
                bits = viterbi_decode(arr[None, : 2 * npairs],
                                      n_bits=nbits, metric_dtype=metric)[0]
        pad = torch.zeros(arr.shape[0] // 2 - nbits, dtype=torch.uint8,
                          device=arr.device)
        return torch.cat([bits.to(torch.uint8), pad])
    VITERBI_CALLS["host"] += 1
    arr = np.asarray(llrs, np.float32)
    bits = viterbi_decode(torch.from_numpy(arr[None, : 2 * npairs]),
                          n_bits=nbits)[0].numpy()
    out = np.zeros(arr.shape[0] // 2, np.uint8)
    out[:nbits] = bits
    return out


EXTERNALS["viterbi_soft"] = _viterbi_soft
# same brick under a second name: the ext declaration syntax pins ONE
# array size per name, and a program decoding both a 24-bit SIGNAL
# field and max-size DATA frames should not zero a 131072-double
# buffer on the sync hot path just to decode 24 bits
EXTERNALS["viterbi_soft_sig"] = _viterbi_soft


def register_external(name: str, fn: Callable) -> None:
    """Extend the registry (used by ops/ext_math and user code)."""
    EXTERNALS[name] = fn


def resolve_ext(name: str) -> Callable:
    fn = EXTERNALS.get(name)
    if fn is None:
        # the fixed-point math library self-registers on import
        import ziria_tpu_torch.ops.ext_math  # noqa: F401
        fn = EXTERNALS.get(name)
    if fn is None:
        known = ", ".join(sorted(EXTERNALS))
        raise KeyError(
            f"ext fun {name!r} is not in the externals registry "
            f"(known: {known}); register it with "
            f"ziria_tpu_torch.frontend.externals.register_external")
    return fn
