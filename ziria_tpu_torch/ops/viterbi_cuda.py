"""Batched Viterbi decode on the card (counterpart of
ziria_tpu/ops/viterbi_pallas.py, default mode: float32 metrics, radix
2).

Two kernels, each with a wrapper, a plain PyTorch version of the same
function and a launch count:

- :func:`acs` runs ``acs_f32_kernel`` (csrc/viterbi.cu), replacing
  ``_acs_kernel`` (ziria_tpu/ops/viterbi_pallas.py:332).
- :func:`traceback` runs ``traceback_kernel`` (csrc/viterbi.cu),
  replacing ``_make_traceback_kernel(UNROLL)`` (viterbi_pallas.py:517).

A wrapper runs the plain version only for a tensor that lies on the
CPU (the tests); on a CUDA tensor it launches the kernel or raises.

Bit identity with the Pallas decode depends on four details, which
the kernels and the plain versions both keep:

- the trellis is zero-padded to a multiple of 64 steps (the Pallas
  ``UNROLL``; zero LLRs are erasures), and the traceback starts from
  the metrics after the padded steps;
- metrics start at 0 for state 0 and -1e30 elsewhere, and are
  renormalized (minus their max) once every 64 steps, not every step;
- a decision takes predecessor-low-bit 1 only when its candidate is
  strictly larger;
- the traceback starts at the FIRST argmax of the final metrics.

Decisions are (B, Tp, 8) uint8: byte i bit j holds the survivor bit
of state 8i+j, the Pallas kernel's packed planes per lane (the kernel
writes them as one little-endian uint64 word per step).

What bounds the kernels on the card: each frame is a chain of Tp
dependent add-compare-select steps (110,592 in the 1000-byte mixed
batch) and a batch of 128 frames gives only 128 chains, one warp each.
That latency bound lies far above the bytes roofline (about 226 MB of
LLRs and decisions at 3.35 TB/s is under 0.1 ms). Several frames per
warp, windowing and staged decision stores are later work.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ziria_tpu_torch.ops.viterbi import N_STATES, NEG, _OUT_A, _OUT_B

RENORM = 64          # steps between renorms, the Pallas UNROLL

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"acs": 0, "traceback": 0}


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
        (lib.ziria_acs_f32, [ptr] * 3 + [i32] * 3 + [ptr]),
        (lib.ziria_traceback, [ptr] * 3 + [i32] * 3 + [ptr]),
        # sym, gain, nbits, ridx, bank, ndbps, norms, dec, metrics,
        # B, n_sym, Tp, device, stream (ops/viterbi_fused)
        (lib.ziria_fused_acs_mixed, [ptr] * 9 + [i32] * 4 + [ptr]),
        # sym, gain, nbits, table, dec, metrics, n_dbps, norm, B,
        # n_sym, Tp, cadence, device, stream
        (lib.ziria_fused_acs_rate,
         [ptr] * 6 + [i32, ctypes.c_float] + [i32] * 5 + [ptr]),
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


# ------------------------------------------------------------------ ACS


def _coeffs(device):
    a = torch.from_numpy(_OUT_A).to(device)
    b = torch.from_numpy(_OUT_B).to(device)
    return a[:, 0], a[:, 1], b[:, 0], b[:, 1]


def acs_plain(llr: torch.Tensor, renorm: int = RENORM):
    """The ACS sweep in plain PyTorch: llr (B, Tp, 2) float32, Tp a
    multiple of `renorm` -> (decisions (B, Tp, 8) uint8, metrics (B, 64)
    float32), renormalizing once every `renorm` steps. The same
    arithmetic, step for step, as the kernel (``acs_f32_kernel`` at
    the default 64; the fused kernels at their own cadences)."""
    B, Tp = llr.shape[0], llr.shape[1]
    if Tp % renorm:
        raise ValueError(f"acs: Tp={Tp} is not a multiple of {renorm}")
    dev = llr.device
    a0, a1, b0, b1 = _coeffs(dev)
    ev_idx = 2 * (torch.arange(N_STATES, device=dev) % 32)
    od_idx = ev_idx + 1
    m = torch.full((B, N_STATES), NEG, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    decs = torch.empty((B, Tp, N_STATES), dtype=torch.bool, device=dev)
    for t in range(Tp):
        la = llr[:, t, 0:1]
        lb = llr[:, t, 1:2]
        c0 = m[:, ev_idx] + a0 * la + b0 * lb
        c1 = m[:, od_idx] + a1 * la + b1 * lb
        d = c1 > c0
        m = torch.where(d, c1, c0)
        decs[:, t] = d
        if (t + 1) % renorm == 0:
            m = m - m.amax(dim=1, keepdim=True)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    packed = (decs.view(B, Tp, 8, 8).to(torch.int32) * weights).sum(-1)
    return packed.to(torch.uint8), m


def acs(llr: torch.Tensor):
    """ACS sweep: llr (B, Tp, 2) float32 -> (decisions (B, Tp, 8)
    uint8, final metrics (B, 64) float32). Launches ``acs_f32_kernel``
    on a CUDA tensor (one warp per frame), runs :func:`acs_plain` on a
    CPU tensor."""
    if llr.dim() != 3 or llr.shape[2] != 2 or llr.dtype != torch.float32:
        raise ValueError(f"acs: want (B, Tp, 2) float32, got "
                         f"{tuple(llr.shape)} {llr.dtype}")
    if llr.device.type == "cpu":
        return acs_plain(llr)
    _check_cuda("acs", llr)
    B, Tp = llr.shape[0], llr.shape[1]
    if B == 0 or Tp % RENORM:
        raise ValueError(f"acs: B={B}, Tp={Tp}; want B > 0 and Tp a "
                         f"multiple of {RENORM}")
    dec = torch.empty((B, Tp, 8), dtype=torch.uint8, device=llr.device)
    metrics = torch.empty((B, N_STATES), dtype=torch.float32,
                          device=llr.device)
    err = _lib().ziria_acs_f32(llr.data_ptr(), dec.data_ptr(),
                               metrics.data_ptr(), B, Tp,
                               llr.device.index, _stream(llr))
    _raise_on(err, "acs_f32_kernel")
    LAUNCHES["acs"] += 1
    return dec, metrics


# ------------------------------------------------------------ traceback


def traceback_plain(dec: torch.Tensor, metrics: torch.Tensor):
    """The traceback in plain PyTorch: decisions (B, Tp, 8) uint8 and
    final metrics (B, 64) -> decoded bits (B, Tp) uint8."""
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
    float32 -> bits (B, Tp) uint8. Launches ``traceback_kernel`` on
    CUDA tensors (one thread per frame), runs :func:`traceback_plain`
    on CPU tensors."""
    if dec.dim() != 3 or dec.shape[2] != 8 or dec.dtype != torch.uint8:
        raise ValueError(f"traceback: want (B, Tp, 8) uint8 decisions, "
                         f"got {tuple(dec.shape)} {dec.dtype}")
    if metrics.shape != (dec.shape[0], N_STATES) \
            or metrics.dtype != torch.float32:
        raise ValueError(f"traceback: want ({dec.shape[0]}, 64) float32 "
                         f"metrics, got {tuple(metrics.shape)} "
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
                                 dec.device.index, _stream(dec))
    _raise_on(err, "traceback_kernel")
    LAUNCHES["traceback"] += 1
    return bits


# --------------------------------------------------------------- decode


def pad_trellis(llrs: torch.Tensor) -> torch.Tensor:
    """(B, T, 2) soft pairs -> contiguous (B, Tp, 2) float32,
    zero-padded (erasures) to Tp, the next multiple of 64: the padding
    the reference's ``_decode_tiles`` applies. (Its lane padding to a
    multiple of 128, ``_to_tiles``, has no counterpart: each frame is
    its own warp here.)"""
    x = llrs.to(torch.float32)
    T = x.shape[1]
    Tp = -(-T // RENORM) * RENORM
    if Tp != T:            # pad copies; a whole trellis needs no copy
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
    return x.contiguous()


def viterbi_decode_batch(llrs: torch.Tensor) -> torch.Tensor:
    """Batched soft decode: llrs (B, T, 2) -> (B, T) uint8 bits,
    bit-identical to the reference's ``viterbi_decode_batch`` at float32
    metrics and radix 2."""
    dec, metrics = acs(pad_trellis(llrs))
    return traceback(dec, metrics)[:, :llrs.shape[1]]
