"""Federated training jobs through the program's ``run_fl``.

A job is one ``repro_torch.core.fl.engine.run_fl`` call from fresh weights
with its own key, for a fixed number of rounds (patience above the round
count, so every job does the same work). Jobs run back to back, one in
flight; each job's weights and key come from ``--seed`` and the job's
index. A round trains ``cohort`` clients (the whole fleet without one) for
``local_steps`` Adam steps of ``batch_size`` windows each.

Set-up makes the fleet's series on the device and runs one warm job of one
evaluation chunk (the same chunk length, so the same shapes and kernels as
every timed job; a warm job of one round runs out of memory in its capture
at 2,048 stations). The check replays one whole timed job, drawn from the
seed, with the plain reference, from the same weights, key and data: every
round's loss and count, the first and the last evaluation, and the global
model's change over the job.
"""
from __future__ import annotations

import gc
import math
import random
import time

import torch

from bench import counts, datagen, weights
from bench.reference import compare
from bench.reference import fl as ref_fl
from bench.reference.model import leaf_specs, num_params
from bench.trace import profiled

MASK32 = 0xFFFFFFFF


def job_key(seed: int, job: int, device) -> torch.Tensor:
    s = int(seed)
    return torch.tensor([((s >> 32) * 7919 + job) & MASK32, s & MASK32],
                        dtype=torch.int64, device=device)


def _sizes(ctx):
    m, f, tr = ctx.config["model"], ctx.config["fl"], ctx.traffic
    K = tr["stations"]
    S = tr.get("cohort") or K
    W = m["look_back"] + m["horizon"]
    n_days_test = ctx.st["test"].shape[1]
    n_test = n_days_test - W + 1 if tr["streaming_windows"] else n_days_test
    evals = -(-tr["rounds"] // tr["eval_every"])
    return K, S, n_test, evals, f

# faults the reference can plant in the program's place (bench/control.py)
FAULTS = ("state_unchanged", "half_batch", "wrong_gates", "carry_dropped",
          "keys_repeat")


def setup(ctx):
    from repro_torch.core.fl.engine import FLConfig
    from repro_torch.core.forecast import ForecastConfig

    m, f, tr = ctx.config["model"], ctx.config["fl"], ctx.traffic
    train, test = datagen.ev_fleet(ctx.seed, tr["stations"], tr["days"],
                                   m["look_back"], m["horizon"],
                                   tr["streaming_windows"])
    st = ctx.st
    st["train"] = torch.from_numpy(train).to(ctx.device)
    st["test"] = torch.from_numpy(test).to(ctx.device)
    st["model_cfg"] = ForecastConfig(
        look_back=m["look_back"], horizon=m["horizon"],
        patch_len=m["patch_len"], stride=m["stride"], d_model=m["d_model"],
        num_heads=m["num_heads"], d_ff=m["d_ff"], mixers=tuple(m["mixers"]),
        dropout=m["dropout"], revin=m["revin"],
        use_flash_attn=m["use_flash_attn"])
    K, S = tr["stations"], tr.get("cohort") or tr["stations"]
    st["fl_cfg"] = FLConfig(
        policy=f["policy"], num_clients=K, select_ratio=f["select_ratio"],
        share_ratio=f["share_ratio"], forward_ratio=f["forward_ratio"],
        local_steps=f["local_steps"], batch_size=f["batch_size"], lr=f["lr"],
        adam_b1=f["adam_b1"], adam_b2=f["adam_b2"], adam_eps=f["adam_eps"],
        comm_bits=f["comm_bits"], use_pallas_mix=f["use_pallas_mix"],
        streaming_windows=tr["streaming_windows"],
        participation=S if S < K else None)
    run_job(ctx, -1, tr["eval_every"])


def run_job(ctx, job: int, rounds: int) -> dict:
    from repro_torch.core.fl.engine import run_fl

    st, tr = ctx.st, ctx.traffic
    _, tree = weights.draw(ctx.config["model"], ctx.seed, 1 + job, ctx.device)
    hist = run_fl(st["model_cfg"], st["fl_cfg"], st["train"], st["test"],
                  job_key(ctx.seed, job, ctx.device), max_rounds=rounds,
                  patience=rounds + 1, eval_every=tr["eval_every"],
                  driver=ctx.config["fl"]["driver"], init_params=tree,
                  device=ctx.device)
    wr = hist.get("while_run") or {}
    record = {"loss": list(hist["train_loss"]), "comm": list(hist["comm"]),
              "rmse": [r for _, r in hist["rmse"]],
              "final": hist["state"]["w_global"].detach().clone(),
              "capture_s": wr.get("warmup_s", 0.0) + wr.get("capture_s", 0.0)}
    # The first torch.func call of a process leaves that job's frames, and
    # with them its client state and graph pool, in a reference cycle; at
    # 2,048 stations the third or fourth job then runs out of memory unless
    # the cycle is collected before the next job allocates. The freed
    # blocks are handed back to the card too: the caching allocator frees
    # none of its cache while a graph is being captured, so a capture that
    # needs a new block runs out of memory with the last job's blocks cached.
    del hist
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def window(ctx, seconds: float):
    """Jobs back to back until ``seconds`` have passed; the last job runs
    to its end."""
    rounds = ctx.traffic["rounds"]
    jobs = []
    ctx.sync()
    t0 = time.perf_counter()
    ctx.window_started(t0)
    while True:
        jobs.append(run_job(ctx, len(jobs), rounds))
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
    K, S, n_test, evals, f = _sizes(ctx)
    per_job = rounds * S * f["local_steps"] * f["batch_size"]
    m = ctx.config["model"]
    flops = len(jobs) * (per_job * counts.train_flops(m)
                         + evals * K * n_test * counts.forward_flops(m))
    ctx.st["jobs"] = jobs
    return {"seconds": elapsed, "windows": len(jobs) * per_job,
            "flops": flops, "attempted": len(jobs), "failed": 0,
            "capture_s": [j["capture_s"] for j in jobs]}


def profile(ctx):
    """One more job under the profiler, and the kernel calls its shapes
    make: the warm-up round and its evaluation, then every round and
    evaluation of the chunks replayed."""
    rounds = ctx.traffic["rounds"]
    trace = profiled(lambda: run_job(ctx, 1 << 20, rounds), ctx.device.type)
    K, S, n_test, evals, f = _sizes(ctx)
    m = ctx.config["model"]
    attn = sum(1 for x in m["mixers"] if x == "attn") if m["use_flash_attn"] else 0
    N, H = counts.num_tokens(m), m["num_heads"]
    hd = m["d_model"] // H
    flash = [(S * f["batch_size"], N, H, hd, (rounds + 1) * f["local_steps"] * attn),
             (K * n_test, N, H, hd, (evals + 1) * attn)]
    mix = [(S, num_params(m), rounds + 1)] if f["use_pallas_mix"] else []
    return trace, {"flash_calls": [c for c in flash if c[-1]], "mix_calls": mix}


def _reference(ctx, precision="fp32", faults=()):
    """The reference over the job the check draws from the seed (the first
    where no window ran), from that job's weights and key."""
    tr, m = ctx.traffic, ctx.config["model"]
    j = random.Random(ctx.seed).randrange(max(len(ctx.st.get("jobs", [])), 1))
    start, _ = weights.draw(m, ctx.seed, 1 + j, ctx.device)
    ref = ref_fl.run_job(m, ctx.config["fl"], start,
                         job_key(ctx.seed, j, ctx.device), ctx.st["train"],
                         ctx.st["test"], tr.get("cohort") or tr["stations"],
                         tr["rounds"], tr["eval_every"], precision, faults)
    return j, dict(ref, start=start)


def _gaps(ctx, got, want):
    sizes = [math.prod(shape) for _, shape, _ in leaf_specs(ctx.config["model"])]
    return compare.fl_gaps(got, want, ctx.config["check"]["loss_steps"], sizes)


def check(ctx):
    """Gaps between one timed job, drawn from the seed, and the reference
    over that whole job."""
    j, ref = _reference(ctx)
    return _gaps(ctx, dict(ctx.st["jobs"][j], start=ref["start"]), ref)


def reference_readings(ctx, precision: str, faults=()):
    """The reference against itself in ``precision`` with ``faults``
    planted (the control, and the faults' readings), over the job the
    check would draw; the float32 reference is run once a process."""
    if "reference" not in ctx.st:
        ctx.st["reference"] = _reference(ctx)[1]
    return _gaps(ctx, _reference(ctx, precision, faults)[1], ctx.st["reference"])
