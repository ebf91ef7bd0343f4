"""``flash_fwd_roofline_pct``: the attention forward kernels' share of
their roofline in the profiled slice. The least time of every call the
slice's shapes make (``bench/counts.py::attention_bound_s``), summed, over
the summed device time of the kernels whose names follow. Nothing is read
unless the trace holds exactly as many such kernels as the shapes make
calls: a renamed or replaced kernel leaves the metric out."""
from bench.counts import attention_bound_s

KERNELS = ("flash_short_kernel", "flash_fwd_kernel", "flash_tc_kernel")


def read(ctx):
    calls = ctx.calls.get("flash_calls") or []
    if ctx.trace is None or ctx.device.type != "cuda" or not calls:
        return None
    spans = ctx.trace.kernels(KERNELS)
    if len(spans) != sum(c[-1] for c in calls):
        return None
    bound = sum(n * attention_bound_s(b, s, h, d) for b, s, h, d, n in calls)
    return 100.0 * bound / sum(e - s for s, e in spans)
