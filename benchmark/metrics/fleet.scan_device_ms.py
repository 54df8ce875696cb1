"""``fleet.scan_device_ms``: device milliseconds a chunk-step of the work
launched inside the port's guarded scan span ``rx.stream_chunk_multi``
(``rx.multi_stream_chunk_graph``), from the traced calls' profiler
trace. The degraded twin ``rx.stream_chunk_multi.eager`` counts only
when the fleet degrades."""


def read(ctx):
    if ctx.trace is None:
        return None
    c = ctx.traced_counts.counts
    n = c.get("rx.stream_chunk_multi", 0) \
        + c.get("rx.stream_chunk_multi.eager", 0)
    if not n:
        return None
    return (ctx.trace.device_s_under("rx.stream_chunk_multi")
            + ctx.trace.device_s_under("rx.stream_chunk_multi.eager")) \
        / n * 1e3
