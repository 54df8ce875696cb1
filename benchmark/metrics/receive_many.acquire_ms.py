"""``receive_many.acquire_ms``: host milliseconds a batch of the port's
``rx.acquire_many`` timed site (pad, upload, sync, SIGNAL), over the
measured window. The site ends in its SIGNAL read, a host read, so its
wall time holds the device work it waits for."""


def read(ctx):
    n = ctx.window_counts.counts.get("rx.acquire_many", 0)
    if not n:
        return None
    return ctx.window_counts.times["rx.acquire_many"] / n * 1e3
