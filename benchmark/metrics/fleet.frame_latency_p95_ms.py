"""``fleet.frame_latency_p95_ms``: the 95th percentile, over every frame
emitted in the measured window, of the time from the start of the
``push_many`` call that handed in the frame's last sample to the end of
the call that emitted it: the one-step pipeline lag, the host decision
tree and the decode. The card idles most of a fleet step, so the host
paces this tail; it stands here beside ``rx_samples_per_s``, not as an
end-to-end metric with a bound."""


def read(ctx):
    lat = ctx.entry.latencies_s(ctx.window_calls)
    if len(lat) < 20:
        return None
    from benchmark.run import percentile
    return percentile(lat, 95) * 1e3
