"""The benchmark's frozen work counts and the card's published peaks.

Copied from the port's ``chip_smoke.py`` (``acs_ops_to``,
``traceback_work``) and ``utils/programs.DEVICE_PEAKS`` at commit
33779fc, and frozen here so that a later change to the port cannot move
the yardstick. The counts take the port's renorm cadence at that commit
(``viterbi_cuda.RENORM``, 64 steps) as a constant.

The trellis work of a frame is counted from the frame itself: its steps
are its SERVICE, PSDU and tail bits (``16 + 8 * length + 6``), whatever
lanes, buckets or padding a kernel runs.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense: 67 TFLOP/s float32
# outside the tensor cores, 3.35 TB/s HBM3 (the port's DEVICE_PEAKS)
PEAK_FLOPS = 67.0e12
PEAK_BYTES_PER_S = 3.35e12

RENORM = 64                   # steps between renorms (viterbi_cuda.RENORM)
N_SERVICE, N_TAIL = 16, 6


def acs_ops_to(stops: Iterable[int], cadence: int = RENORM) -> int:
    """ACS operations of each lane's steps up to its stop: per state and
    step 4 adds, 1 compare, 1 select, plus the renorm's max and subtract
    every `cadence` steps."""
    s = [int(v) for v in stops]
    return sum(s) * 64 * 6 + sum(v // cadence for v in s) * 64 * 2


def traceback_work(b: int, tp: int) -> Tuple[int, int]:
    """Traceback (bytes, operations): decision words and metrics in,
    bits out; 4 integer operations per step plus the 63-compare argmax."""
    return b * tp * 8 + b * 64 * 4 + b * tp, b * (tp * 4 + 63)


def frame_steps(length_bytes: int) -> int:
    """Trellis steps a frame needs: SERVICE, PSDU and tail bits."""
    return N_SERVICE + 8 * int(length_bytes) + N_TAIL


def trellis_work(lengths: Iterable[int]) -> Tuple[int, int]:
    """(operations, bytes) of the Viterbi decode of frames of these PSDU
    lengths: the ACS and the traceback up to each frame's own stop; the
    bytes are the soft pairs read once (2 float32 a step) and the bits
    written once (a byte a step), the decisions between the two passes
    being the implementation's own."""
    steps = [frame_steps(n) for n in lengths]
    ops = acs_ops_to(steps) + sum(traceback_work(1, t)[1] for t in steps)
    nbytes = sum(t * (2 * 4 + 1) for t in steps)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of the work on the card, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
