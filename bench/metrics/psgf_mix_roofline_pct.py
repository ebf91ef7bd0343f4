"""``psgf_mix_roofline_pct``: the downlink mix kernel's share of its
roofline in the profiled slice: the least time of every mix the slice's
rounds make (``bench/counts.py::mix_bound_s``, bound by HBM bytes), summed,
over the summed device time of the kernel named below. Nothing is read
unless the trace holds exactly one such kernel a mix."""
from bench.counts import mix_bound_s

KERNELS = ("psgf_mix_kernel",)


def read(ctx):
    calls = ctx.calls.get("mix_calls") or []
    if ctx.trace is None or ctx.device.type != "cuda" or not calls:
        return None
    spans = ctx.trace.kernels(KERNELS)
    if len(spans) != sum(c[-1] for c in calls):
        return None
    bound = sum(n * mix_bound_s(k, d) for k, d, n in calls)
    return 100.0 * bound / sum(e - s for s, e in spans)
