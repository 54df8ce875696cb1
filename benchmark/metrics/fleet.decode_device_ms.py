"""``fleet.decode_device_ms``: device milliseconds a decode dispatch of
the work launched inside the port's ``rx.stream_decode_multi`` span
(``rx.stream_decode_multi_graph``: row select, the fused decode, the
masked CRC), from the traced calls' profiler trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.traced_counts.counts.get("rx.stream_decode_multi", 0)
    if not n:
        return None
    return ctx.trace.device_s_under("rx.stream_decode_multi") / n * 1e3
