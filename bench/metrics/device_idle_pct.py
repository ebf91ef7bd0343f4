"""``device_idle_pct``: the share of the profiled slice, on the host clock
with the card synchronised at both ends, in which no kernel, copy or set
ran on the card (the union of their intervals from the trace)."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
