"""``viterbi_roofline``: the least time of the trellis work that the
traced calls' frames need, as a share (%) of the device time of every
Viterbi kernel in their trace.

The work (``benchmark/roofline.trellis_work``) is counted from the
frames themselves: each frame's SERVICE, PSDU and tail steps, the ACS
and the traceback up to that stop, the soft pairs read once and the bits
written once; never from the kernels' padded lanes or buckets. Its least
time is the larger of the operations over 67 TFLOP/s (float32 outside
the tensor cores) and the bytes over 3.35 TB/s; at 9 bytes and ~390
operations a step it is the operations that bound it. The kernels are
those whose names match ``KERNELS``; the fused kernel's time includes
the demap it does."""

from benchmark import roofline

KERNELS = r"acs_kernel|traceback_kernel|fused_acs_"


def read(ctx):
    if ctx.trace is None:
        return None
    lengths = ctx.entry.frame_lengths(ctx.traced_calls)
    spent = ctx.trace.kernel_s(KERNELS)
    if not lengths or spent <= 0:
        return None
    least, _by = roofline.least_seconds(*roofline.trellis_work(lengths))
    return 100.0 * least / spent
