"""``receive_many.decode_device_ms``: device milliseconds a batch of the
work launched inside the port's ``rx.decode_mixed`` span (the front and
the Viterbi), from the traced calls' profiler trace."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    return ctx.trace.device_s_under("rx.decode_mixed") \
        / len(ctx.traced_calls) * 1e3
