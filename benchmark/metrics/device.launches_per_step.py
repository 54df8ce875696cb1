"""``device.launches_per_step``: kernels, copies and memsets in the
traced calls' trace per fleet chunk-step (an exact count)."""


def read(ctx):
    if ctx.trace is None or ctx.entry.unit != "step":
        return None
    return ctx.trace.device_events() / len(ctx.traced_calls)
