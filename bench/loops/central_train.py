"""Centralized training steps of one forecaster through the program's
``Forecaster.loss_fn``, ``pytree_utils.value_and_grad`` and
``Adam.update_``, eager, as ``benchmarks/table1.py`` trains Table I.

Each step draws ``samples`` start times from the training part of every
channel on the device and takes all ``channels`` windows at each:
``samples * channels`` channel-independent windows, a multivariate batch
flattened as channel independence does. Steps run back to back on data
already on the card.

Set-up builds the parameters and the optimizer state once, drives them
through the first ``check.steps`` steps of the feed (which warms every
shape), keeps what the check reads (the weights before, the first
gradient as Adam's first moment holds it, the weights after), and hands
the same objects to the window.
"""
from __future__ import annotations

import math
import time

import torch

from bench import counts, datagen, weights
from bench.reference import compare
from bench.reference import model as RM
from bench.reference import train as ref_train
from bench.trace import profiled

# faults the reference can plant in the program's place (bench/control.py)
FAULTS = ("state_unchanged", "half_batch")


def setup(ctx):
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core.forecast import ForecastConfig
    from repro_torch.core.forecaster import Forecaster
    from repro_torch.optim.adam import Adam
    from repro_torch.optim.schedules import one_cycle

    m, o, tr, st = ctx.config["model"], ctx.config["optimizer"], ctx.traffic, ctx.st
    x, y, n = datagen.weather_windows(ctx.seed, tr["channels"], tr["length"],
                                      m["look_back"], m["horizon"])
    x, y = torch.from_numpy(x).to(ctx.device), torch.from_numpy(y).to(ctx.device)
    n_train = int(n * tr["train_frac"])
    offsets = torch.arange(tr["channels"], device=ctx.device)[:, None] * n
    gen = weights.generator(ctx.seed, 1, ctx.device)

    def batch():
        j = torch.randint(0, n_train, (tr["samples"],), generator=gen,
                          device=ctx.device)
        rows = (offsets + j[None, :]).reshape(-1)
        return x[rows], y[rows]

    fc = Forecaster(ForecastConfig(
        look_back=m["look_back"], horizon=m["horizon"],
        patch_len=m["patch_len"], stride=m["stride"], d_model=m["d_model"],
        num_heads=m["num_heads"], d_ff=m["d_ff"], mixers=tuple(m["mixers"]),
        dropout=m["dropout"], revin=m["revin"],
        use_flash_attn=m["use_flash_attn"]))
    opt = Adam(lr=one_cycle(o["max_lr"], o["cycle_steps"]), b1=o["b1"],
               b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"])
    start, tree = weights.draw(m, ctx.seed, 0, ctx.device)
    params = pt.tree_map(torch.clone, tree)
    state = opt.init(params)

    def loss_fn(p, a, b):
        return fc.loss_fn(p, a, b), None

    def step(xb, yb):
        (loss, _), grads = pt.value_and_grad(loss_fn, params, xb, yb)
        opt.update_(params, grads, state)
        return loss

    st.update(step=step, batch=batch, batches=[], losses=[])
    for i in range(ctx.config["check"]["steps"]):
        xb, yb = batch()
        st["batches"].append((xb, yb))
        st["losses"].append(float(step(xb, yb)))
        if i == 0:
            st["grad1"] = weights.flat_of(state["m"], m) / (1 - o["b1"])
    st["prog"] = {"loss": st["losses"], "grad1": st["grad1"], "start": start,
                  "params": weights.flat_of(params, m).clone()}


def window(ctx, seconds: float):
    st, tr = ctx.st, ctx.traffic
    steps = 0
    ctx.sync()
    t0 = time.perf_counter()
    ctx.window_started(t0)
    while time.perf_counter() - t0 < seconds or steps == 0:
        st["step"](*st["batch"]())
        steps += 1
    ctx.sync()
    elapsed = time.perf_counter() - t0
    windows = steps * tr["samples"] * tr["channels"]
    return {"seconds": elapsed, "windows": windows,
            "flops": windows * counts.train_flops(ctx.config["model"]),
            "attempted": steps, "failed": 0}


def profile(ctx):
    st, tr, m = ctx.st, ctx.traffic, ctx.config["model"]
    n = tr["profile_steps"]
    trace = profiled(lambda: [st["step"](*st["batch"]()) for _ in range(n)],
                     ctx.device.type)
    attn = sum(1 for x in m["mixers"] if x == "attn") if m["use_flash_attn"] else 0
    H = m["num_heads"]
    calls = [(tr["samples"] * tr["channels"], counts.num_tokens(m), H,
              m["d_model"] // H, n * attn)]
    return trace, {"flash_calls": [c for c in calls if c[-1]], "mix_calls": []}


def _reference(ctx, precision="fp32", faults=()):
    st = ctx.st
    ref = ref_train.train_steps(ctx.config["model"], ctx.config["optimizer"],
                                st["prog"]["start"], st["batches"], precision,
                                faults)
    return dict(ref, start=st["prog"]["start"])


def _sizes(model):
    return [math.prod(shape) for _, shape, _ in RM.leaf_specs(model)]


def check(ctx):
    ref = _reference(ctx)
    return compare.train_gaps(ctx.st["prog"], ref, _sizes(ctx.config["model"]))


def reference_readings(ctx, precision: str, faults=()):
    want, got = _reference(ctx), _reference(ctx, precision, faults)
    return compare.train_gaps(got, want, _sizes(ctx.config["model"]))
