"""``fl_capture_s``: seconds a federated job spends before its first
replay on the card, the while driver's eager warm-up round plus the CUDA
graph capture and instantiation (``history["while_run"]``'s ``warmup_s`` +
``capture_s``), the mean over the window's jobs."""


def read(ctx):
    times = ctx.window.get("capture_s") or []
    if ctx.device.type != "cuda" or not times:
        return None
    return sum(times) / len(times)
