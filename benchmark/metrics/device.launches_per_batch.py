"""``device.launches_per_batch``: kernels, copies and memsets in the
traced calls' trace per ``receive_many`` call (an exact count)."""


def read(ctx):
    if ctx.trace is None or ctx.entry.unit != "batch":
        return None
    return ctx.trace.device_events() / len(ctx.traced_calls)
