"""Soft-decision Viterbi decoder for the 802.11 K=7 code: the trellis
tables, the quantization of the integer metric modes, the knob checks
and the per-step-renormalized scan decoders (counterpart of
ziria_tpu/ops/viterbi.py).

State = the 6 most recent input bits, newest in the MSB. Soft input is
LLR-like, positive = bit more likely 1; punctured positions carry 0.
The scan decoder here is what the SIGNAL field decode runs (24 steps,
a Python loop over batched ops, as the reference's ``lax.scan`` is not
a kernel), and the per-capture int16 DATA decode at radix 2, as in the
reference. The long DATA trellis goes through the CUDA kernels of
``ops/viterbi_cuda.py`` instead.

The quantized modes: soft values quantize per frame to integers in
[-qmax, qmax] (127 for int16, 15 for int8); the metrics are int32
arithmetic that saturates into the int16 or int8 rails at every
renorm -- every step here, once per 64-step block in the kernels,
which is the reference's own difference.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops.coding import G0, G1
from ziria_tpu_torch.utils import geometry

N_STATES = 64


def _edge_tables():
    """For each next-state t and decision d in {0,1}: predecessor state
    and the two coded output bits on that edge (as +-1 floats)."""
    pred = np.zeros((N_STATES, 2), np.int32)
    out_a = np.zeros((N_STATES, 2), np.float32)
    out_b = np.zeros((N_STATES, 2), np.float32)
    for t in range(N_STATES):
        b = t >> 5                     # input bit of any edge into t
        for d in range(2):             # d = low bit of the predecessor
            s = ((t & 31) << 1) | d
            pred[t, d] = s
            window = [b] + [(s >> (5 - i)) & 1 for i in range(6)]
            a = sum(g * w for g, w in zip(G0, window)) % 2
            bb = sum(g * w for g, w in zip(G1, window)) % 2
            out_a[t, d] = 2.0 * a - 1.0
            out_b[t, d] = 2.0 * bb - 1.0
    return pred, out_a, out_b


_PRED, _OUT_A, _OUT_B = _edge_tables()


NEG = -1e30

QUANT_MAX = 127                  # int16 mode: 8-bit soft values
I16_MIN, I16_MAX = -(1 << 15), (1 << 15) - 1
INT8_QUANT_MAX = 15              # int8 mode: 4-bit soft values
I8_MIN, I8_MAX = -(1 << 7), (1 << 7) - 1
METRIC_DTYPES = geometry.VITERBI_METRICS
RADIXES = geometry.VITERBI_RADIXES
#: (start metric of every state but 0, lower rail, upper rail)
_INT_RAILS = {"int16": (I16_MIN, I16_MAX), "int8": (I8_MIN, I8_MAX)}


def quantize_llrs(llrs: torch.Tensor, qmax: int = QUANT_MAX):
    """(..., 2) float soft values -> (int16 quantized values, float32
    scale). The scale maps the peak |llr| onto `qmax` per frame: shape
    (B, 1, 1) for a (B, T, 2) batch, a scalar for a lone (T, 2) or
    (2T,) frame. In the reference's float32 order: scale = qmax /
    max(peak, 1e-12), then round(llrs * scale) half to even, then
    clip."""
    x = llrs.to(torch.float32)
    if x.dim() == 3:
        peak = x.abs().amax(dim=(1, 2), keepdim=True)
    else:
        peak = x.abs().amax()
    scale = qmax / torch.clamp(peak, min=1e-12)
    q = torch.clamp(torch.round(x * scale), -qmax, qmax)
    return q.to(torch.int16), scale


def _check_metric_dtype(metric_dtype) -> str:
    md = metric_dtype or "float32"
    if md not in METRIC_DTYPES:
        raise ValueError(
            f"metric_dtype {metric_dtype!r} is not one of {METRIC_DTYPES}")
    return md


def _check_radix(radix) -> int:
    """The ACS radix knob: ``None`` reads ZIRIA_VITERBI_RADIX (2 when
    unset); anything else must be 2 or 4."""
    if radix is None:
        return geometry.env_viterbi_radix()
    radix = int(radix)
    if radix not in RADIXES:
        raise ValueError(f"viterbi radix {radix!r} is not one of {RADIXES}")
    return radix


def _scan(x: torch.Tensor, n_bits, rails=None) -> torch.Tensor:
    """The scan decoder over (B, T, 2) soft pairs: float32 metrics, or
    int32 metrics saturating into `rails` = (lo, hi) after every
    renorm (lo is also every state's start but state 0's)."""
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    pred = torch.from_numpy(_PRED.astype(np.int64)).to(dev)     # (64, 2)
    dtype = torch.float32 if rails is None else torch.int32
    out_a = torch.from_numpy(_OUT_A).to(device=dev, dtype=dtype)
    out_b = torch.from_numpy(_OUT_B).to(device=dev, dtype=dtype)
    x = x.to(dtype)
    m = torch.full((B, N_STATES), NEG if rails is None else rails[0],
                   dtype=dtype, device=dev)
    m[:, 0] = 0
    decisions = torch.empty((B, T, N_STATES), dtype=torch.int64,
                            device=dev)
    for t in range(T):
        la = x[:, t, 0][:, None, None]
        lb = x[:, t, 1][:, None, None]
        cand = m[:, pred] + out_a * la + out_b * lb              # (B, 64, 2)
        decisions[:, t] = torch.argmax(cand, dim=2)
        new = cand.amax(dim=2)
        m = new - new.amax(dim=1, keepdim=True)
        if rails is not None:
            m = torch.clamp(m, *rails)
    state = torch.argmax(m, dim=1)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    for t in reversed(range(T)):
        bits[:, t] = (state >> 5).to(torch.uint8)
        d = decisions[:, t].gather(1, state[:, None])[:, 0]
        state = ((state & 31) << 1) | d
    return bits if n_bits is None else bits[:, :n_bits]


def _pairs(llrs: torch.Tensor) -> torch.Tensor:
    """(B, T, 2) or (B, 2T) -> (B, T, 2)."""
    return llrs.reshape(llrs.shape[0], -1, 2) if llrs.dim() == 2 else llrs


def viterbi_decode_int16(qllrs: torch.Tensor, n_bits: int = None):
    """Decode pre-quantized integer pairs (B, T, 2) or (B, 2T) with
    int16 saturating metrics: int32 arithmetic, every renormalized
    metric clamped into [I16_MIN, I16_MAX] every step. (B, T) uint8
    bits, or the first `n_bits`."""
    return _scan(_pairs(qllrs), n_bits, _INT_RAILS["int16"])


def viterbi_decode_int8(qllrs: torch.Tensor, n_bits: int = None):
    """As :func:`viterbi_decode_int16` with the int8 rails
    [I8_MIN, I8_MAX] (inputs quantized to |q| <= INT8_QUANT_MAX)."""
    return _scan(_pairs(qllrs), n_bits, _INT_RAILS["int8"])


def viterbi_decode(llrs: torch.Tensor, n_bits: int = None,
                   metric_dtype: str = None) -> torch.Tensor:
    """Decode a batch of soft streams: llrs (B, T, 2) or (B, 2T) float
    -> (B, T) uint8 bits (or the first `n_bits`).

    Same semantics as the reference's scan: state 0 starts at metric 0
    and the rest at -1e30, a decision picks predecessor-low-bit 1 only
    when its candidate is strictly larger, metrics are renormalized
    every step, and the traceback starts at the first argmax.
    ``metric_dtype="int16"`` ("int8") quantizes each frame
    (:func:`quantize_llrs`, qmax 127 (15)) and runs the int16 (int8)
    scan."""
    md = _check_metric_dtype(metric_dtype)
    x = _pairs(llrs)
    if md == "int16":
        return viterbi_decode_int16(quantize_llrs(x)[0], n_bits)
    if md == "int8":
        return viterbi_decode_int8(quantize_llrs(x, INT8_QUANT_MAX)[0],
                                   n_bits)
    return _scan(x.to(torch.float32), n_bits)
