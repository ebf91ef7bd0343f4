"""``mfu_pct``: the model FLOPs of the window's work (every training window
three forwards' worth, every evaluation window one; recompute and the
while driver's discarded warm-up round not counted; ``bench/counts.py``)
over the window's time, as a share of the card's float32 peak, the
configuration's precision (TF32 off)."""
from bench.counts import FP32_FLOP_PER_S


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return 100.0 * ctx.window["flops"] / ctx.window["seconds"] / FP32_FLOP_PER_S
