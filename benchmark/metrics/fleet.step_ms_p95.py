"""``fleet.step_ms_p95``: the 95th percentile of the host milliseconds of
each chunk-step's ``push_many`` call over the measured window (the call
ends in the drain of step t - 1, a host read)."""


def read(ctx):
    ms = [(c["t1"] - c["t0"]) * 1e3 for c in ctx.window_calls]
    if len(ms) < 20:
        return None
    from benchmark.run import percentile
    return percentile(ms, 95)
