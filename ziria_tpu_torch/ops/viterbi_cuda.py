"""Batched Viterbi decode on the card (counterpart of
ziria_tpu/ops/viterbi_pallas.py: the batch decode :673, its mode
dispatch :719 and the windowed decode :738).

Two kernel wrappers, each with a plain PyTorch version of the same
function and launch counts:

- :func:`acs` runs ``acs_kernel<M, Radix>`` (csrc/viterbi.cu), one
  instance per decode mode, replacing the Pallas ACS kernels that
  ``_acs_tiles`` (viterbi_pallas.py:576) selects: float32 radix 2
  ``_acs_kernel`` :332 (key ``acs``), float32 radix 4 ``_acs_kernel_r4``
  :369 (``acs_r4``), int16 radix 2 ``_acs_kernel_i16`` :402
  (``acs_i16``) and the three instances of ``_make_acs_kernel_int_lut``
  :447 (``acs_i16_r4``, ``acs_i8``, ``acs_i8_r4``).
- :func:`traceback` runs ``traceback_kernel<float|int>``, replacing
  ``_make_traceback_kernel(UNROLL)`` (viterbi_pallas.py:517).

A wrapper runs the plain version only for a tensor that lies on the
CPU (the tests); on a CUDA tensor it launches the kernel or raises.

Bit identity with the Pallas decode depends on four details, which
the kernels and the plain versions both keep:

- the trellis is zero-padded to a multiple of 64 steps (the Pallas
  ``UNROLL``; zero LLRs are erasures), and the traceback starts from
  the metrics after the padded steps;
- metrics start at 0 for state 0 and -1e30 (float32) or the lower rail
  (int16, int8) elsewhere, and are renormalized (minus their max, then
  for the integer modes clamped to the rails) once every 64 steps, not
  every step;
- a decision takes predecessor-low-bit 1 only when its candidate is
  strictly larger;
- the traceback starts at the FIRST argmax of the final metrics.

Radix 4 takes two steps as one butterfly (``_acs_pair_r4_f32``,
``_acs_pair_lut_int``); it gives radix 2's decisions and metrics bit
for bit, at every metric type.

Decisions are (B, Tp, 8) uint8: byte i bit j holds the survivor bit
of state 8i+j, the Pallas kernel's packed planes per lane (the kernel
writes them as one little-endian uint64 word per step).

What bounds the kernels on the card: each frame is a chain of
dependent add-compare-select steps, and a batch of 128 frames gives
only 128 chains, whose latency lies far above the bytes roofline
(about 226 MB of LLRs and decisions at 3.35 TB/s is under 0.1 ms).
Two cures, both exact: the ACS kernel stops each chain where the
frame's erasure tail (the zero padding up to Tp: 93% of the 1000-byte
mixed batch's 110,592 steps) has left every later decision word 0 and
every metric +0, and writes those itself; the traceback composes
per-segment state maps, so its chain runs across segments in
parallel. The windowed decode turns the chain into B * ceil(T /
window) shorter ones.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ziria_tpu_torch.ops.viterbi import (INT8_QUANT_MAX, N_STATES, NEG,
                                         QUANT_MAX, _INT_RAILS, _OUT_A,
                                         _OUT_B, _check_metric_dtype,
                                         _check_radix, _pairs,
                                         quantize_llrs)

RENORM = 64          # steps between renorms, the Pallas UNROLL
DEFAULT_WINDOW_OVERLAP = 96   # windowed decode warm-up, ~14 constraint lengths

#: launch-count key of the ACS kernel of each (metric dtype, radix)
ACS_KEYS = {("float32", 2): "acs", ("float32", 4): "acs_r4",
            ("int16", 2): "acs_i16", ("int16", 4): "acs_i16_r4",
            ("int8", 2): "acs_i8", ("int8", 4): "acs_i8_r4"}
#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {k: 0 for k in (*ACS_KEYS.values(), "traceback")}
_METRIC_CODE = {"float32": 0, "int16": 1, "int8": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@lru_cache(maxsize=None)
def _lib():
    """The kernels' library, built on first use, its entry points
    typed (pointers and the stream as c_void_p, or ctypes would cut
    them to 32-bit ints)."""
    from ziria_tpu_torch import cuda_build

    lib = cuda_build.library("viterbi")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    sigs = (
        # llr, dec, metrics, stops, B, Tp, metric, radix, device, stream
        (lib.ziria_acs, [ptr] * 4 + [i32] * 5 + [ptr]),
        # dec, metrics, bits, B, Tp, int_metrics, device, stream
        (lib.ziria_traceback, [ptr] * 3 + [i32] * 4 + [ptr]),
        # sym, gain, nbits, ridx, bank, ndbps, norms, dec, metrics,
        # stops, B, n_sym, Tp, radix, device, stream (ops/viterbi_fused)
        (lib.ziria_fused_acs_mixed, [ptr] * 10 + [i32] * 5 + [ptr]),
        # sym, gain, nbits, table, dec, metrics, stops, n_dbps, norm, B,
        # n_sym, Tp, cadence, radix, device, stream
        (lib.ziria_fused_acs_rate,
         [ptr] * 7 + [i32, ctypes.c_float] + [i32] * 6 + [ptr]),
    )
    for fn, sig in sigs:
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU ones")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_mode(metric_dtype: str, radix: int):
    """(metric dtype, radix) of an explicit ACS mode, checked."""
    md = _check_metric_dtype(metric_dtype)
    if radix not in (2, 4):
        raise ValueError(f"acs: radix {radix!r} is not 2 or 4")
    return md, radix


# ------------------------------------------------------------------ ACS


@lru_cache(maxsize=None)
def _plain_tables(device: torch.device):
    """Per final state t (64,) index and coefficient columns of the
    plain ACS, on `device`: radix 2's predecessors 2(t%32) + d and the
    edge coefficients / sign patterns by d; radix 4's grand-predecessors
    4(t%16) + j and the step-1 edges (into u = 2(t%32) + (j>>1), low
    bit j&1) by j. A sign pattern (1 - acc_a) * 2 + (1 - acc_b) indexes
    the combo table [la+lb, la-lb, -la+lb, -la-lb]."""
    t = np.arange(N_STATES)
    pat = ((_OUT_A < 0) * 2 + (_OUT_B < 0)).astype(np.int64)   # (64, 2)
    u = [((t & 31) << 1) | (j >> 1) for j in range(4)]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "pred": [dev(2 * (t % 32) + d) for d in (0, 1)],
        "a": [dev(_OUT_A[:, d]) for d in (0, 1)],
        "b": [dev(_OUT_B[:, d]) for d in (0, 1)],
        "pat": [dev(pat[:, d]) for d in (0, 1)],
        "quad": [dev(4 * (t % 16) + j) for j in range(4)],
        "a1": [dev(_OUT_A[u[j], j & 1]) for j in range(4)],
        "b1": [dev(_OUT_B[u[j], j & 1]) for j in range(4)],
        "pat16": [dev(pat[u[j], j & 1] * 4 + pat[:, j >> 1])
                  for j in range(4)],
    }


def _combos4(la, lb):
    """(B, 4) combo table of one step: [la+lb, la-lb, -la+lb, -la-lb]
    (``_combos4``, viterbi_pallas.py:179)."""
    s, d = la + lb, la - lb
    return torch.cat([s, d, -d, -s], dim=1)


def _interleave(c_a, c_b):
    """Radix-4 step-1 decisions from final-state rows to intermediate
    state rows u = 2(t%32) + d2 (``_interleave_dec1``)."""
    return torch.stack([c_a[:, :32], c_b[:, :32]], dim=2).reshape(
        c_a.shape[0], N_STATES)


def _step_plain(m, x, tab, integer: bool):
    """One radix-2 step on pairs x (B, 1, 2): (metrics, decisions (B, 1,
    64)). float32: ``_acs_step_f32``; integer: ``_acs_step_lut_int``."""
    la, lb = x[:, 0, 0:1], x[:, 0, 1:2]
    if integer:
        s4 = _combos4(la, lb)
        c0 = m[:, tab["pred"][0]] + s4[:, tab["pat"][0]]
        c1 = m[:, tab["pred"][1]] + s4[:, tab["pat"][1]]
    else:
        c0 = m[:, tab["pred"][0]] + tab["a"][0] * la + tab["b"][0] * lb
        c1 = m[:, tab["pred"][1]] + tab["a"][1] * la + tab["b"][1] * lb
    d = c1 > c0
    return torch.where(d, c1, c0), d[:, None]


def _pair_plain(m, x, tab, integer: bool):
    """Two steps as one radix-4 butterfly on pairs x (B, 2, 2):
    (metrics, decisions (B, 2, 64)). float32: ``_acs_pair_r4_f32``
    (step-1 candidates p[j], then m01/m23, then step 2); integer:
    ``_acs_pair_lut_int`` (the 16-value two-step combo table)."""
    la1, lb1 = x[:, 0, 0:1], x[:, 0, 1:2]
    la2, lb2 = x[:, 1, 0:1], x[:, 1, 1:2]
    g = [m[:, q] for q in tab["quad"]]
    if integer:
        s16 = (_combos4(la1, lb1)[:, :, None]
               + _combos4(la2, lb2)[:, None, :]).reshape(-1, 16)
        c = [g[j] + s16[:, tab["pat16"][j]] for j in range(4)]
        d_a, d_b = c[1] > c[0], c[3] > c[2]
        m01, m23 = torch.where(d_a, c[1], c[0]), torch.where(d_b, c[3], c[2])
        d2 = m23 > m01
        m = torch.where(d2, m23, m01)
    else:
        p = [g[j] + tab["a1"][j] * la1 + tab["b1"][j] * lb1
             for j in range(4)]
        d_a, d_b = p[1] > p[0], p[3] > p[2]
        m01, m23 = torch.where(d_a, p[1], p[0]), torch.where(d_b, p[3], p[2])
        c0 = m01 + tab["a"][0] * la2 + tab["b"][0] * lb2
        c1 = m23 + tab["a"][1] * la2 + tab["b"][1] * lb2
        d2 = c1 > c0
        m = torch.where(d2, c1, c0)
    return m, torch.stack([_interleave(d_a, d_b), d2], dim=1)


def acs_plain(llr: torch.Tensor, renorm: int = RENORM,
              metric_dtype: str = "float32", radix: int = 2):
    """The ACS sweep in plain PyTorch: llr (B, Tp, 2), float32 or (for
    the int16 and int8 metrics) int16, Tp a multiple of `renorm` ->
    (decisions (B, Tp, 8) uint8, final metrics (B, 64) float32 or
    int32), renormalizing once every `renorm` steps. The same
    arithmetic, step for step, as the kernels (``acs_kernel`` at the
    default 64; the fused kernels at their own cadences)."""
    md, radix = _check_mode(metric_dtype, radix)
    B, Tp = llr.shape[0], llr.shape[1]
    step, k = (_step_plain, 1) if radix == 2 else (_pair_plain, 2)
    if Tp % renorm or renorm % k:
        raise ValueError(f"acs: Tp={Tp} is not a multiple of {renorm} "
                         f"(or {renorm} not of the {k} steps an iteration)")
    dev = llr.device
    tab = _plain_tables(dev)
    integer = md != "float32"
    if integer:
        lo, hi = _INT_RAILS[md]
        x = llr.to(torch.int32)
        m = torch.full((B, N_STATES), lo, dtype=torch.int32, device=dev)
    else:
        x = llr
        m = torch.full((B, N_STATES), NEG, dtype=torch.float32, device=dev)
    m[:, 0] = 0
    decs = torch.empty((B, Tp, N_STATES), dtype=torch.bool, device=dev)
    for t in range(0, Tp, k):
        m, decs[:, t:t + k] = step(m, x[:, t:t + k], tab, integer)
        if (t + k) % renorm == 0:
            m = m - m.amax(dim=1, keepdim=True)
            if integer:
                m = torch.clamp(m, lo, hi)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    packed = (decs.view(B, Tp, 8, 8).to(torch.int32) * weights).sum(-1)
    return packed.to(torch.uint8), m


def acs(llr: torch.Tensor, metric_dtype: str = "float32", radix: int = 2):
    """ACS sweep: llr (B, Tp, 2) -> (decisions (B, Tp, 8) uint8, final
    metrics (B, 64)). float32 metrics take float32 soft pairs and give
    float32 metrics; int16 and int8 take quantized int16 pairs (|q| <=
    127, resp. 15) and give int32 metrics. Launches the mode's
    ``acs_kernel`` instance on a CUDA tensor (one block per frame; the
    sweep stops, exactly, where the frame's erasure tail has made every
    later decision 0), runs :func:`acs_plain` on a CPU tensor."""
    return _acs(llr, metric_dtype, radix, False)[:2]


def acs_with_stops(llr: torch.Tensor, metric_dtype: str = "float32",
                   radix: int = 2):
    """:func:`acs`, and (B,) int32 the step at which each frame's sweep
    ended: a multiple of 64, Tp for a full sweep (always, for the plain
    version)."""
    return _acs(llr, metric_dtype, radix, True)


def _acs(llr: torch.Tensor, metric_dtype: str, radix: int, want_stops: bool):
    md, radix = _check_mode(metric_dtype, radix)
    want = torch.float32 if md == "float32" else torch.int16
    if llr.dim() != 3 or llr.shape[2] != 2 or llr.dtype != want:
        raise ValueError(f"acs({md}): want (B, Tp, 2) {want}, got "
                         f"{tuple(llr.shape)} {llr.dtype}")
    B, Tp = llr.shape[0], llr.shape[1]
    if llr.device.type == "cpu":
        dec, metrics = acs_plain(llr, RENORM, md, radix)
        return dec, metrics, (torch.full((B,), Tp, dtype=torch.int32)
                              if want_stops else None)
    _check_cuda("acs", llr)
    if B == 0 or Tp % RENORM:
        raise ValueError(f"acs: B={B}, Tp={Tp}; want B > 0 and Tp a "
                         f"multiple of {RENORM}")
    dec = torch.empty((B, Tp, 8), dtype=torch.uint8, device=llr.device)
    metrics = torch.empty((B, N_STATES), device=llr.device,
                          dtype=torch.float32 if md == "float32"
                          else torch.int32)
    stops = (torch.empty((B,), dtype=torch.int32, device=llr.device)
             if want_stops else None)
    err = _lib().ziria_acs(llr.data_ptr(), dec.data_ptr(),
                           metrics.data_ptr(),
                           None if stops is None else stops.data_ptr(),
                           B, Tp, _METRIC_CODE[md], radix, llr.device.index,
                           _stream(llr))
    key = ACS_KEYS[(md, radix)]
    _raise_on(err, f"acs_kernel ({key})")
    LAUNCHES[key] += 1
    return dec, metrics, stops


# ------------------------------------------------------------ traceback


def traceback_plain(dec: torch.Tensor, metrics: torch.Tensor):
    """The traceback in plain PyTorch: decisions (B, Tp, 8) uint8 and
    final metrics (B, 64), float32 or int32 -> decoded bits (B, Tp)
    uint8."""
    B, Tp = dec.shape[0], dec.shape[1]
    state = torch.argmax(metrics, dim=1)                 # first max
    bits = torch.empty((B, Tp), dtype=torch.uint8, device=dec.device)
    for t in reversed(range(Tp)):
        bits[:, t] = (state >> 5).to(torch.uint8)
        byte = dec[:, t].gather(1, (state >> 3)[:, None])[:, 0]
        d = (byte.to(torch.int64) >> (state & 7)) & 1
        state = ((state & 31) << 1) | d
    return bits


def traceback(dec: torch.Tensor, metrics: torch.Tensor):
    """Traceback: decisions (B, Tp, 8) uint8 + final metrics (B, 64)
    float32 or int32 -> bits (B, Tp) uint8. Launches
    ``traceback_kernel`` on CUDA tensors (one block per frame, the walk
    cut into segments; one instance per metric type), runs
    :func:`traceback_plain` on CPU tensors."""
    if dec.dim() != 3 or dec.shape[2] != 8 or dec.dtype != torch.uint8:
        raise ValueError(f"traceback: want (B, Tp, 8) uint8 decisions, "
                         f"got {tuple(dec.shape)} {dec.dtype}")
    if metrics.shape != (dec.shape[0], N_STATES) \
            or metrics.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"traceback: want ({dec.shape[0]}, 64) float32 "
                         f"or int32 metrics, got {tuple(metrics.shape)} "
                         f"{metrics.dtype}")
    if dec.device.type == "cpu" and metrics.device.type == "cpu":
        return traceback_plain(dec, metrics)
    _check_cuda("traceback", dec)
    _check_cuda("traceback", metrics)
    if metrics.device != dec.device:
        raise ValueError("traceback: decisions and metrics on different "
                         "devices")
    B, Tp = dec.shape[0], dec.shape[1]
    if B == 0 or Tp == 0:
        raise ValueError(f"traceback: empty batch ({B}, {Tp})")
    bits = torch.empty((B, Tp), dtype=torch.uint8, device=dec.device)
    err = _lib().ziria_traceback(dec.data_ptr(), metrics.data_ptr(),
                                 bits.data_ptr(), B, Tp,
                                 int(metrics.dtype == torch.int32),
                                 dec.device.index, _stream(dec))
    _raise_on(err, "traceback_kernel")
    LAUNCHES["traceback"] += 1
    return bits


# --------------------------------------------------------------- decode


def pad_trellis(llrs: torch.Tensor) -> torch.Tensor:
    """(B, T, 2) soft pairs -> contiguous (B, Tp, 2), zero-padded
    (erasures) to Tp, the next multiple of 64: the padding the
    reference's ``_decode_tiles`` applies. Quantized int16 pairs stay
    int16, anything else becomes float32. (Its lane padding to a
    multiple of 128, ``_to_tiles``, has no counterpart: each frame is
    its own warp here.)"""
    x = llrs if llrs.dtype == torch.int16 else llrs.to(torch.float32)
    T = x.shape[1]
    Tp = -(-T // RENORM) * RENORM
    if Tp != T:            # pad copies; a whole trellis needs no copy
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
    return x.contiguous()


def _quantize_for(md: str, llrs: torch.Tensor) -> torch.Tensor:
    """Quantize float soft pairs for an integer metric mode (per-frame
    scale, qmax 127 for int16 and 15 for int8, stored as int16); int16
    input passes through as already quantized (the windowed decode
    quantizes before it cuts windows)."""
    if llrs.dtype == torch.int16:
        return llrs
    qmax = QUANT_MAX if md == "int16" else INT8_QUANT_MAX
    return quantize_llrs(llrs, qmax)[0]


def viterbi_decode_batch(llrs: torch.Tensor, n_bits: int = None,
                         metric_dtype: str = None,
                         radix: int = None) -> torch.Tensor:
    """Batched soft decode: llrs (B, T, 2) or (B, 2T) -> (B, T) uint8
    bits (or the first `n_bits`), bit-identical to the reference's
    ``viterbi_decode_batch`` in every mode. ``metric_dtype`` "int16" or
    "int8" quantizes each frame at the kernel boundary (int16 input is
    taken as already quantized); ``radix`` None reads
    ZIRIA_VITERBI_RADIX."""
    md, rdx = _check_metric_dtype(metric_dtype), _check_radix(radix)
    x = _pairs(llrs)
    x = x.to(torch.float32) if md == "float32" else _quantize_for(md, x)
    T = x.shape[1]
    bits = traceback(*acs(pad_trellis(x), md, rdx))[:, :T]
    return bits if n_bits is None else bits[:, :n_bits]


def viterbi_decode_batch_opt(llrs: torch.Tensor, n_bits: int = None,
                             window: int = None, metric_dtype: str = None,
                             radix: int = None) -> torch.Tensor:
    """The batch decode's one mode dispatch: ``window`` None or 0 runs
    :func:`viterbi_decode_batch`, a window length
    :func:`viterbi_decode_batch_windowed`; the metric and radix go to
    either."""
    if window:
        return viterbi_decode_batch_windowed(
            llrs, n_bits=n_bits, window=window, metric_dtype=metric_dtype,
            radix=radix)
    return viterbi_decode_batch(llrs, n_bits=n_bits,
                                metric_dtype=metric_dtype, radix=radix)


def viterbi_decode_batch_windowed(llrs: torch.Tensor, n_bits: int = None,
                                  window: int = 1024,
                                  overlap: int = DEFAULT_WINDOW_OVERLAP,
                                  metric_dtype: str = None,
                                  radix: int = None, _decode=None):
    """Sliding-window decode: the T-step chain of each frame is cut into
    ceil(T / window) windows of window + 2 * overlap steps, decoded as
    extra lanes of one batch decode. Window 0 starts at step 0 (the
    known state-0 start) and keeps [0, window); window k > 0 starts at
    k * window - overlap and keeps [overlap, overlap + window). Steps
    outside the frame (before 0 or at T and past) are zero erasures. A
    frame with T <= window + 2 * overlap takes the exact decode. The
    integer modes quantize each whole frame before the windows are cut,
    so every window sees the full decode's integers. `_decode` (the
    batch decode by default) takes (lanes, steps, 2) pairs, float32 or
    quantized int16, and returns their bits."""
    md, rdx = _check_metric_dtype(metric_dtype), _check_radix(radix)
    if _decode is None:
        def _decode(x):
            return viterbi_decode_batch(x, metric_dtype=md, radix=rdx)
    x = _pairs(llrs)
    x = x.to(torch.float32) if md == "float32" else _quantize_for(md, x)
    B, T = x.shape[0], x.shape[1]
    ext = window + 2 * overlap
    if T <= ext:
        bits = _decode(x)
        return bits if n_bits is None else bits[:, :n_bits]
    dev = x.device
    nwin = -(-T // window)
    starts = np.arange(nwin) * window - overlap
    starts[0] = 0
    idx = (torch.from_numpy(starts).to(dev)[:, None]
           + torch.arange(ext, device=dev)[None, :])       # (nwin, ext)
    valid = (idx >= 0) & (idx < T)
    wins = torch.where(valid[None, :, :, None],
                       x[:, idx.clamp(0, T - 1)],
                       torch.zeros((), dtype=x.dtype, device=dev))
    bits = _decode(wins.reshape(B * nwin, ext, 2)).reshape(B, nwin, ext)
    keep = (torch.where(torch.arange(nwin, device=dev) == 0, 0, overlap)
            [:, None] + torch.arange(window, device=dev)[None, :])
    bits = torch.gather(bits, 2, keep[None].expand(B, nwin, window))
    bits = bits.reshape(B, nwin * window)[:, :T]
    return bits if n_bits is None else bits[:, :n_bits]
