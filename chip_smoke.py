#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

  1. card: require CUDA, pin fp32 matmuls and convolutions to full fp32 (no
     TF32), print the card's name and power limit (``nvidia-smi``);
  2. build: compile every CUDA kernel of the port from ``src/repro_torch/csrc``
     (one ``nvcc`` per source, all at once) and print the build time and the
     compiler's register/spill report;
  3. kernels: call each kernel's wrapper on the card at the shapes the main
     paths give it and at the reference test classes, hold it against its
     plain PyTorch version (flash attention within its tolerance at the
     serving buckets, at training's K x 32 and evaluation's K x n_test rows
     of each cluster and past the grid's batch limit, one backward, and one
     vmap(grad) over 27 clients against dense attention; psgf_mix bitwise
     at K = 21 / 27 / 10 clients of D = 273,284, a ragged D, a non-binary
     mask and the K = 1 case), and time the kernel, the plain version and
     the closest PyTorch call;
  4. serving: the port's serving path at full width — two LoGTST cluster
     models (look_back 128, d_model 128, 16 heads, flash attention on,
     random weights from a seeded generator) saved as checkpoints with a
     routing manifest over the 58 stations of the ``ev`` task, restored by
     ``ForecastServer.from_manifest`` on the card and driven through the
     micro-batching queue; then a served bucket against the CPU forward,
     ``stream_evaluate``, and a generation hot-swap;
  5. training: the paper's pipeline (``examples/federated_ev.py``) through
     the port — ``run_experiment`` on the full ``ev`` task, DTW clustering
     into 3 clusters (21 / 27 / 10 stations), PSGF-Fed per cluster at full
     width with the fused psgf_mix downlink and flash attention on the card,
     a few rounds, checkpoints and the routing manifest; then the manifest
     served by ``ForecastServer.from_manifest``, one round of the 10-station
     cluster on the card against the same round on the CPU (selection, gates
     and comm counters bitwise), and a ``torch.profiler`` split of a round.

Then it prints ``{"training": ...}``, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. It imports ``torch``, ``numpy``, the
standard library and ``repro_torch`` (from ``src/`` beside this file) only.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 rate
# outside the tensor cores (the kernel does fp32 FMAs on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# served outputs (GPU) against the CPU forward of the same params: both fp32
# with no TF32, but cuBLAS and the CPU sum each matmul (K up to 1920 in the
# head) in other orders, and the flash kernel's online softmax differs from
# the CPU's dense one in rounding; 1e-4 abs/rel is ~100x the expected ulps
SERVE_TOL = 1e-4


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def timed_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    launch overhead between calls is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def attention_inputs(gen, B, Sq, Skv, H, KV, hd, dtype):
    q = torch.randn(B, Sq, H, hd, generator=gen).to("cuda", dtype)
    k = torch.randn(B, Skv, KV, hd, generator=gen).to("cuda", dtype)
    v = torch.randn(B, Skv, KV, hd, generator=gen).to("cuda", dtype)
    return q, k, v


def check_flash_attention(ops, ref, tol_f32: float) -> dict:
    """Kernel vs plain version on the card; returns the main-path record."""
    gen = torch.Generator().manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, Sq, Skv, H, KV, hd), causal, window, kv_len, dtype, tol
        ("main_path", (96, 15, 15, 16, 16, 8), False, None, None, f32, tol_f32),
        ("gqa_causal_hd64", (2, 256, 256, 4, 2, 64), True, None, None, f32, 2e-5),
        ("window64_hd128", (1, 200, 200, 4, 4, 128), True, 64, None, f32, 2e-5),
        ("sq_ne_skv_bidir", (2, 128, 384, 8, 2, 64), False, None, None, f32, 2e-5),
        ("bf16_hd128", (1, 256, 256, 2, 1, 128), True, None, None, bf16, 2e-2),
        ("window17_hd32", (1, 100, 100, 6, 3, 32), True, 17, None, f32, 2e-5),
        ("bidir_100_gqa", (1, 100, 100, 4, 2, 32), False, None, None, f32, 2e-5),
        ("bidir_130_hd16", (1, 130, 130, 8, 8, 16), False, None, None, f32, 2e-5),
        ("bidir_63_hd64", (3, 63, 63, 2, 1, 64), False, None, None, f32, 2e-5),
        ("kv_len_100", (1, 128, 256, 2, 2, 16), False, None, 100, f32, 2e-5),
    ]
    errs = {}
    for name, shape, causal, window, kv_len, dtype, tol in cases:
        q, k, v = attention_inputs(gen, *shape, dtype)
        before = ops.LAUNCHES
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len)
        torch.cuda.synchronize()
        if ops.LAUNCHES != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch the kernel")
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       kv_len=kv_len)
        err = float((got.float() - want.float()).abs().max())
        errs[name] = err
        if not err <= tol:
            raise RuntimeError(f"{name}: kernel vs plain max |err| {err} > {tol}")
        if name == "main_path":
            main_case = (q, k, v, err)

    # every shape the serving path gives the kernel: buckets 1..32 times
    # 1 channel (stream_evaluate) or 3 channels (serve_requests)
    bucket_err = 0.0
    for rows in sorted({b * m for b in (1, 2, 4, 8, 16, 32) for m in (1, 3)}):
        q, k, v = attention_inputs(gen, rows, 15, 15, 16, 16, 8, f32)
        got = ops.flash_attention(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        bucket_err = max(bucket_err, float((got - want).abs().max()))
    errs["serving_bucket_shapes"] = bucket_err
    if not bucket_err <= tol_f32:
        raise RuntimeError(f"serving bucket shapes: max |err| {bucket_err}")

    # padded keys are inert: poisoning k/v at and past kv_len changes nothing
    q, k, v = attention_inputs(gen, 1, 128, 256, 2, 2, 16, f32)
    base = ops.flash_attention(q, k, v, causal=False, kv_len=100)
    k[:, 100:], v[:, 100:] = 50.0, -50.0
    poisoned = ops.flash_attention(q, k, v, causal=False, kv_len=100)
    if not torch.equal(base, poisoned):
        raise RuntimeError("kv_len: poisoned padding keys changed the output")
    # rows whose window holds only padding are exactly 0
    q, k, v = attention_inputs(gen, 1, 256, 128, 2, 2, 16, f32)
    out = ops.flash_attention(q, k, v, causal=False, window=16, kv_len=100)
    if not torch.equal(out[0, 120:], torch.zeros_like(out[0, 120:])):
        raise RuntimeError("fully masked rows are not exactly zero")
    want = ref.flash_attention_ref(q, k, v, causal=False, window=16, kv_len=100)
    errs["fully_masked_rows"] = float((out - want).abs().max())
    if not errs["fully_masked_rows"] <= 2e-5:
        raise RuntimeError(f"fully masked case: max |err| {errs['fully_masked_rows']}")

    # one backward through the autograd.Function (backward = plain version's)
    q, k, v = attention_inputs(gen, 1, 60, 60, 4, 2, 16, f32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sin(ops.flash_attention(*leaves, causal=False)).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sin(ref.flash_attention_ref(*plain, causal=False)).sum().backward()
    errs["backward"] = max(float((a.grad - b.grad).abs().max())
                           for a, b in zip(leaves, plain))
    if not errs["backward"] <= 2e-5:
        raise RuntimeError(f"backward: max |grad err| {errs['backward']}")
    log(json.dumps({"kernel_cases": {"flash_attention": errs}}))

    # times at the serving path's shape
    q, k, v, err = main_case
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel_ms = timed_ms(lambda: ops.flash_attention(q, k, v, causal=False))
    plain_ms = timed_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False))
    library_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    # least work: each input read once, the output written once; QK^T and PV
    # over the (query, key) pairs this call's mask keeps, 2 flops per MAC
    pairs = int(ref.attention_mask(Sq, Skv, causal=False, window=None,
                                   kv_len=None).sum())
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    flops = 4 * B * H * hd * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:114",
        "tpu_kernel": "src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel",
        "shape": [B, Sq, H, hd],
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "bytes": nbytes,
        "flops": flops,
    }


# LocalUpdate's vmap(grad_and_value) through the kernel against the dense
# attention path, both on the card: the two differ in accumulation order
# (~1e-6 relative per attention output), which the backward sums over 15
# tokens x 32 series per client
VMAP_GRAD_TOL = 1e-4
VMAP_LOSS_TOL = 1e-5
TRAIN_BATCH = 32


def check_flash_training(ops, ref, tol_f32: float) -> dict:
    """The kernel at the shapes the training path gives it, against its
    plain version: LocalUpdate's vmap folds a cluster's K clients into the
    batch (K x 32 series), evaluate_rmse runs every client's test windows
    at once (K x n_test), for the clusters K = 21 / 27 / 10; a batch past
    gridDim.z's limit (the kernel strides over it); and one
    ``vmap(grad_and_value)`` of the full-width LoGTST loss over 27 clients
    through the kernel against the dense attention path."""
    import dataclasses

    from repro_torch.common import pytree_utils as pt
    from repro_torch.core import forecast as F
    from repro_torch.core.tasks import get_task

    task = get_task("ev", quick=False, clusters=3, num_days=420,
                    min_cluster_clients=4)
    n_test = task.client_data(task.series())[2].shape[1]
    rows = {f"train_K{K}": K * TRAIN_BATCH for K in MIX_K}
    rows.update({f"eval_K{K}": K * n_test for K in MIX_K})
    rows["above_grid_z"] = 70_000          # past gridDim.z's 65,535
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {}
    for name, B in rows.items():
        q, k, v = (torch.randn(B, 15, 16, 8, generator=gen, device="cuda")
                   for _ in range(3))
        before = ops.LAUNCHES
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        if ops.LAUNCHES != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch the kernel")
        want = ref.flash_attention_ref(q, k, v, causal=False)
        errs[f"{name}_B{B}"] = err = float((got - want).abs().max())
        if not err <= tol_f32:
            raise RuntimeError(f"{name} (B={B}): kernel vs plain max |err| "
                               f"{err} > {tol_f32}")
        del q, k, v, got, want

    cfg = F.logtst_config()
    params = F.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    vec, meta = pt.tree_flatten_to_vector(params)
    if meta.total != 273_284:
        raise RuntimeError(f"LoGTST full width has {meta.total} params")
    K = max(MIX_K)
    rng = np.random.default_rng(SEED)
    noise = rng.standard_normal((K, meta.total)).astype(np.float32)
    w = (vec[None] + 0.01 * torch.from_numpy(noise)).cuda()
    x = torch.from_numpy(rng.standard_normal(
        (K, TRAIN_BATCH, cfg.look_back)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal(
        (K, TRAIN_BATCH, cfg.horizon)).astype(np.float32)).cuda()

    def grads(c):
        def loss(wv, xb, yb):
            return F.mse_loss(c, pt.tree_unflatten_from_vector(wv, meta), xb, yb)
        return torch.func.vmap(torch.func.grad_and_value(loss))(w, x, y)

    before = ops.LAUNCHES
    g_flash, l_flash = grads(dataclasses.replace(cfg, use_flash_attn=True))
    torch.cuda.synchronize()
    if ops.LAUNCHES != before + 1:
        raise RuntimeError(f"vmap(grad) over {K} clients: "
                           f"{ops.LAUNCHES - before} kernel launches, not 1")
    g_dense, l_dense = grads(cfg)
    grad_err = float((g_flash - g_dense).abs().max())
    loss_err = float((l_flash - l_dense).abs().max())
    errs[f"vmap_grad_K{K}"] = {"grad_max_abs_err": grad_err,
                               "loss_max_abs_err": loss_err}
    if not (torch.allclose(g_flash, g_dense, atol=VMAP_GRAD_TOL,
                           rtol=VMAP_GRAD_TOL)
            and torch.allclose(l_flash, l_dense, atol=VMAP_LOSS_TOL,
                               rtol=VMAP_LOSS_TOL)):
        raise RuntimeError(f"vmap(grad) through the kernel vs dense: grad "
                           f"{grad_err}, loss {loss_err}")
    log(json.dumps({"kernel_cases": {"flash_attention_training": errs}}))
    return errs


def latency_quantiles(server) -> dict:
    """p50/p99 submit -> result latency over every request so far, estimated
    from the server's latency histogram (all clusters pooled)."""
    from repro_torch.launch.metrics import quantile_from_buckets

    hist = server.metrics.families()
    hist = next(f for f in hist if f.name == "forecast_latency_seconds")
    cum = None
    for _, child in hist.samples():
        c = child.get()[0]
        cum = c if cum is None else [a + b for a, b in zip(cum, c)]
    return {q: quantile_from_buckets(cum, hist.bounds, q) for q in (0.5, 0.99)}


def profile_forward(server, x, cluster, iters: int = 20) -> dict:
    """Device busy time vs host wall time of ``iters`` served bucket
    forwards, from ``torch.profiler``; device numbers are None when the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            server.predict(x, cluster=cluster)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    device_us, kernels, top = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue      # host ops: their device time is their kernels' rows
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        device_us += dev
        kernels += ev.count
        top.append((dev, ev.key))
    top.sort(reverse=True)
    if device_us == 0:
        return {"wall_ms_per_forward": wall_ms, "device_ms_per_forward": None,
                "device_idle_share": None, "device_ops_per_forward": None}
    device_ms = device_us / 1e3 / iters
    return {
        "wall_ms_per_forward": wall_ms,
        "device_ms_per_forward": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ops_per_forward": kernels / iters,
        "top_device_ms_per_forward": {k: d / 1e3 / iters for d, k in top[:6]},
    }


def drive_serving(ops) -> dict:
    """The port's main path at full width on the card."""
    from repro_torch.core import forecast as F
    from repro_torch.core.forecaster import (get_forecaster, load_forecaster,
                                             save_forecaster)
    from repro_torch.core.tasks import (get_task, update_routing_manifest,
                                        write_routing_manifest)
    from repro_torch.launch.serve_forecast import (ForecastServer,
                                                   serve_requests,
                                                   stream_evaluate)

    root = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    task = get_task("ev", quick=False)              # 58 stations, 420 days
    fc = get_forecaster("logtst", look_back=task.look_back,
                        horizon=task.horizon, use_flash_attn=True)
    if fc.num_params() != 273_284:
        raise RuntimeError(f"LoGTST full width has {fc.num_params()} params")
    gen = torch.Generator().manual_seed(SEED)
    for sub in ("psgf_c0", "psgf_c1", "psgf_c1_g1"):
        save_forecaster(os.path.join(root, sub), fc,
                        fc.init_params(gen, device="cuda"))
    series = task.series()
    labels = np.arange(task.num_clients) % 2
    write_routing_manifest(root, task, fc, labels,
                           [{"policy": "psgf", "cluster": 0},
                            {"policy": "psgf", "cluster": 1}], series=series)

    server = ForecastServer.from_manifest(root, denormalize=True,
                                          device="cuda", max_batch=32)
    server.warmup(channels=3)
    torch.cuda.synchronize()

    ops.LAUNCHES = 0                       # every kernel count, just before
    rep = serve_requests(server, 256, 3, stations=server.routable_stations())
    torch.cuda.synchronize()
    launches = ops.LAUNCHES                # ... and just after the main path
    if launches < rep["batches"] or rep["batches"] == 0:
        raise RuntimeError(f"{launches} flash-attention launches for "
                           f"{rep['batches']} dispatched batches")
    latency = latency_quantiles(server)

    # one full bucket (32 x 3 series -> the kernel's (96, 15, 16, 8) shape),
    # normalized units by cluster, against the CPU forward of the same params
    x = np.random.default_rng(SEED).standard_normal(
        (32, 3, task.look_back)).astype(np.float32)
    got = server.predict(x, cluster=0)
    fc_cpu, p_cpu, _ = load_forecaster(os.path.join(root, "psgf_c0"),
                                       device="cpu")
    with torch.inference_mode():
        want = F.forward_multivariate(fc_cpu.cfg, p_cpu,
                                      torch.from_numpy(x)).numpy()
    if got.shape != (32, 3, task.horizon) or not np.isfinite(got).all():
        raise RuntimeError(f"served bucket: shape {got.shape} or non-finite")
    serve_err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, atol=SERVE_TOL, rtol=SERVE_TOL):
        raise RuntimeError(f"served bucket vs CPU forward: max |err| {serve_err}")

    prof = profile_forward(server, x, cluster=0)

    ev = stream_evaluate(server, task, series=series, max_windows=4)
    if not (ev["windows"] > 0 and math.isfinite(ev["overall_rmse"])
            and ev["unroutable"] == 0 and ev["timed_out"] == 0):
        raise RuntimeError(f"stream_evaluate: {ev}")

    before = server.predict(x, cluster=1)
    gen_no, _ = update_routing_manifest(root, "psgf", {1: "psgf_c1_g1"})
    if not server.reload() or server.generation != gen_no:
        raise RuntimeError("reload did not publish the new generation")
    after = server.predict(x, cluster=1)
    if np.allclose(before, after):
        raise RuntimeError("cluster 1 still serves the old model after reload")
    server.close()
    return {
        "model": fc.name,
        "params": fc.num_params(),
        "clusters": 2,
        "stations": task.num_clients,
        "requests": rep["requests"],
        "channels": rep["channels"],
        "seconds": rep["seconds"],
        "forecasts_per_sec": rep["forecasts_per_sec"],
        "latency_s_p50": latency[0.5],
        "latency_s_p99": latency[0.99],
        "batches": rep["batches"],
        "padded_slots": rep["padded_slots"],
        "flash_attention_launches": launches,
        "bucket_max_abs_err_vs_cpu": serve_err,
        "stream_rmse": ev["overall_rmse"],
        "stream_windows": ev["windows"],
        "generation_after_reload": server.generation,
        "profile_bucket32x3": prof,
    }


# psgf_mix: the fused downlink at the main path's shapes. The mix is bitwise
# the plain version for any float mask (the kernel rounds each step as the
# plain torch ops do); the count is bitwise for 0/1 and quarter masks (exact
# float32 sums) and within float32 rounding of a sum in another order for
# arbitrary floats.
MIX_COUNT_RTOL = 1e-6
MIX_D = 273_284
MIX_K = (21, 27, 10)


def mix_inputs(gen, K, D, kind):
    g = torch.randn(D, generator=gen).to("cuda")
    w = torch.randn(K, D, generator=gen).to("cuda")
    u = torch.rand(K, D, generator=gen)
    m = {"binary": (u < 0.3).float(), "uniform": u,
         "quarters": torch.floor(u * 5) / 4}[kind].to("cuda")
    return g, w, m


def mix_bound_ms(K, D):
    """Least time: w and m read, the output written (K*D floats each), g
    read once, at the HBM rate; 2 flops per element at the fp32 rate."""
    nbytes = (3 * K * D + D) * 4
    return max(nbytes / HBM_BYTES_PER_S, 3 * K * D / FP32_FLOP_PER_S) * 1e3, nbytes


def check_psgf_mix(mix_ops, mix_ref) -> dict:
    gen = torch.Generator().manual_seed(SEED + 1)
    cases = [(K, MIX_D, "binary") for K in MIX_K] + [
        (3, 1_001, "binary"), (5, 8_192, "uniform"), (4, 10_000, "quarters"),
        (2, MIX_D, "uniform")]
    errs = {}
    for K, D, kind in cases:
        g, w, m = mix_inputs(gen, K, D, kind)
        before = mix_ops.LAUNCHES
        mixed, count = mix_ops.psgf_mix_batch(g, w, m)
        torch.cuda.synchronize()
        if mix_ops.LAUNCHES != before + 1:
            raise RuntimeError(f"psgf_mix K={K} D={D}: no kernel launch")
        want, want_count = mix_ref.psgf_mix_batch_ref(g, w, m)
        name = f"K{K}_D{D}_{kind}"
        if not torch.equal(mixed, want):
            raise RuntimeError(f"psgf_mix {name}: mix not bitwise equal, max "
                               f"|err| {float((mixed - want).abs().max())}")
        cerr = abs(float(count) - float(want_count))
        if kind == "uniform":
            if not cerr <= MIX_COUNT_RTOL * float(want_count):
                raise RuntimeError(f"psgf_mix {name}: count err {cerr}")
        elif cerr != 0.0:
            raise RuntimeError(f"psgf_mix {name}: count {float(count)} != "
                               f"{float(want_count)}")
        errs[name] = {"mix_max_abs_err": float((mixed - want).abs().max()),
                      "count_abs_err": cerr}
    # the single-vector form (the TPU's psgf_mix_kernel), K = 1
    g, w, m = mix_inputs(gen, 1, MIX_D, "uniform")
    before = mix_ops.LAUNCHES_SINGLE
    got = mix_ops.psgf_mix(g, w[0], m[0])
    torch.cuda.synchronize()
    if mix_ops.LAUNCHES_SINGLE != before + 1:
        raise RuntimeError("psgf_mix K=1: no kernel launch")
    want = mix_ref.psgf_mix_ref(g, w[0], m[0])
    if not torch.equal(got[0], want[0]):
        raise RuntimeError("psgf_mix K=1: mix not bitwise equal")
    k1_err = float((got[0] - want[0]).abs().max())
    k1_cerr = abs(float(got[1]) - float(want[1]))
    if not k1_cerr <= MIX_COUNT_RTOL * float(want[1]):
        raise RuntimeError(f"psgf_mix K=1: count err {k1_cerr}")
    errs["K1_psgf_mix"] = {"mix_max_abs_err": k1_err, "count_abs_err": k1_cerr}
    log(json.dumps({"kernel_cases": {"psgf_mix": errs}}))

    def lib(w_, g_, m_):     # the closest PyTorch calls: a lerp and a sum
        return torch.lerp(w_, g_.expand_as(w_), m_), m_.sum(dtype=torch.float32)

    per_k = {}
    for K in MIX_K + (1,):
        g, w, m = mix_inputs(gen, K, MIX_D, "binary")
        if K == 1:
            g1, w1, m1 = g, w[0], m[0]
            kernel = lambda: mix_ops.psgf_mix(g1, w1, m1)        # noqa: E731
            plain = lambda: mix_ref.psgf_mix_ref(g1, w1, m1)     # noqa: E731
        else:
            kernel = lambda: mix_ops.psgf_mix_batch(g, w, m)     # noqa: E731
            plain = lambda: mix_ref.psgf_mix_batch_ref(g, w, m)  # noqa: E731
        plain_ms = timed_ms(plain)
        kernel_ms = timed_ms(kernel)
        library_ms = timed_ms(lambda: lib(w, g, m))
        kernel_ms2 = timed_ms(kernel)
        plain_ms2 = timed_ms(plain)
        bound, nbytes = mix_bound_ms(K, MIX_D)
        per_k[K] = {"ms": statistics.median([kernel_ms, kernel_ms2]),
                    "ms_runs": [kernel_ms, kernel_ms2],
                    "plain_ms": statistics.median([plain_ms, plain_ms2]),
                    "plain_ms_runs": [plain_ms, plain_ms2],
                    "library_ms": library_ms, "bound_ms": bound,
                    "bytes": nbytes}
    main_k = max(MIX_K)
    rec = {
        "name": "psgf_mix_batch",
        "route": "cuda",
        "source": "src/repro_torch/csrc/psgf_mix.cu",
        "replaces": "src/repro/kernels/psgf_mix/kernel.py:76",
        "tpu_kernel": "src/repro/kernels/psgf_mix/kernel.py::psgf_mix_batch_kernel",
        "shape": [main_k, MIX_D],
        "max_abs_err": max(e["mix_max_abs_err"] for n, e in errs.items()
                           if n != "K1_psgf_mix"),
        "ms": per_k[main_k]["ms"],
        "kernel_ms": per_k[main_k]["ms"],
        "plain_ms": per_k[main_k]["plain_ms"],
        "bound_ms": per_k[main_k]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_k[main_k]["library_ms"],
        "library_call": "torch.lerp(w, g.expand_as(w), m) + m.sum(dtype=float32)",
        "bytes": per_k[main_k]["bytes"],
        "per_clients": {str(k): v for k, v in per_k.items() if k != 1},
        # the single-vector wrapper: same kernel at K = 1, its own count
        # (filled from the training run, where the engine does not call it)
        "k1_psgf_mix": dict(
            per_k[1], name="psgf_mix", route="cuda",
            source="src/repro_torch/csrc/psgf_mix.cu",
            replaces="src/repro/kernels/psgf_mix/kernel.py:39",
            tpu_kernel="src/repro/kernels/psgf_mix/kernel.py::psgf_mix_kernel",
            shape=[MIX_D], max_abs_err=k1_err, bound_by="bytes",
            library_call="torch.lerp(w, g, m) + m.sum(dtype=float32)"),
    }
    return rec


def card_vs_cpu_round(E, R, task, series, labels, model, spec_grid, seed):
    """One round of the smallest cluster from the same state and key on the
    card and on the CPU: selection, gates, the mixed matrix and the comm
    counters bitwise; the new global model within ROUND_TOL."""
    c = int(np.argmin(np.bincount(labels)))
    idx = np.nonzero(labels == c)[0]
    tr, _, _, _ = task.client_data(series, idx)
    policy_name, overrides = spec_grid[0]
    fl = E.FLConfig(policy=policy_name, num_clients=tr.shape[0],
                    select_ratio=0.5, local_steps=4, batch_size=TRAIN_BATCH,
                    **overrides)
    key = R.PRNGKey(seed + c)
    state_cpu, meta = E.init_fl_state(model.cfg, fl, R.split(key)[1],
                                      device="cpu")
    policy = E.pol.from_config(fl)
    out = {}
    for dev in ("cpu", "cuda"):
        state = {k: v.to(dev) for k, v in state_cpu.items()}
        rk = key.to(dev)
        down = E._round_down(state, rk, fl, meta, policy)
        new_state, metrics = E.fl_round(state, tr, rk, model.cfg, fl, meta,
                                        device=dev)
        out[dev] = (down, new_state, metrics)
    (dc, sc, mc), (dg, sg, mg) = out["cpu"], out["cuda"]
    same = {
        "selected": torch.equal(dc["selected"], dg["selected"].cpu()),
        "gates": torch.equal(dc["gates"], dg["gates"].cpu()),
        "w_mixed": torch.equal(dc["w_mixed"], dg["w_mixed"].cpu()),
        "comm_down": torch.equal(sc["comm_down"], sg["comm_down"].cpu()),
        "comm_up": torch.equal(sc["comm_up"], sg["comm_up"].cpu()),
        "adam_t": torch.equal(sc["adam_t"], sg["adam_t"].cpu()),
        "num_selected": float(mc["num_selected"]) == float(mg["num_selected"]),
    }
    if not all(same.values()):
        raise RuntimeError(f"card round != CPU round: {same}")
    keep = E.bk_free(meta)               # attn/bk: see FL_PARITY_TOL
    err = float((sg["w_global"].cpu() - sc["w_global"])[keep].abs().max())
    if not err <= ROUND_TOL:
        raise RuntimeError(f"card vs CPU w_global max |err| {err} > {ROUND_TOL}")
    return {"cluster": c, "clients": int(tr.shape[0]), "bitwise": same,
            "comm_down": float(sc["comm_down"]), "comm_up": float(sc["comm_up"]),
            "w_global_max_abs_err": err,
            "train_loss_cpu": float(mc["train_loss"]),
            "train_loss_card": float(mg["train_loss"])}


# one round on the card vs on the CPU, same state and key: cuBLAS and the CPU
# sum the forward's and backward's matmuls in other orders (ulps per op);
# Adam's first steps move each weight by about lr * sign(g), so an element
# whose gradient is near zero can move differently by up to lr * steps. The
# global model is a mean over 5 selected clients of weights ~O(0.1-1): 1e-4
# absolute is ~100x the ulp-level differences seen on the CPU between two
# float orders (FL_PARITY_TOL's 1.5e-6), well below a wrong gate (~1e-3).
ROUND_TOL = 1e-4


def profile_round(E, state, data, key, cfg, fl, meta) -> dict:
    """``torch.profiler`` over one round: device busy time, device time per
    engine stage (each kernel assigned to the ``record_function`` range
    whose span on the device holds its start: this counts the kernels the
    port launches through ``ctypes`` too) and the device idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    policy = E.pol.from_config(fl)
    E._round(state, data, key, cfg, fl, meta, policy)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        E._round(state, data, key, cfg, fl, meta, policy)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name.startswith("fl.")]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("fl.")]
    stages = {name: {"device_ms": 0.0, "kernels": 0} for name, _, _ in spans}
    stages["other"] = {"device_ms": 0.0, "kernels": 0}
    for e in kernels:
        name = next((n for n, a, b in spans if a <= e.time_range.start < b),
                    "other")
        stages[name]["device_ms"] += e.time_range.elapsed_us() / 1e3
        stages[name]["kernels"] += 1
    for ev in prof.key_averages():
        if ev.key in stages and ev.device_type == DeviceType.CPU:
            stages[ev.key]["cpu_ms"] = ev.cpu_time_total / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                  if busy_ms else None),
            "device_ops": len(kernels), "stages": stages}


TRAIN_ROUNDS = 4
TRAIN_EVAL_EVERY = 2


def drive_training(mix_ops, flash_ops) -> dict:
    """The paper's pipeline at full width on the card (phase 5)."""
    from repro_torch import random as R
    from repro_torch.core import forecast as F
    from repro_torch.core.fl import engine as E
    from repro_torch.core.forecaster import load_forecaster
    from repro_torch.core.tasks import (ExperimentSpec, get_task,
                                        read_routing_manifest, run_experiment,
                                        task_forecaster)
    from repro_torch.launch.serve_forecast import ForecastServer, serve_requests

    root = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    task = get_task("ev", quick=False, clusters=3, num_days=420,
                    min_cluster_clients=4)
    model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
    if model.num_params() != 273_284:
        raise RuntimeError(f"LoGTST full width has {model.num_params()} params")
    grid = (("psgf", {"share_ratio": 0.3, "forward_ratio": 0.2,
                      "use_pallas_mix": True}),)
    spec = ExperimentSpec(task=task, model=model, grid=grid, select_ratio=0.5,
                          local_steps=4, batch_size=TRAIN_BATCH,
                          max_rounds=TRAIN_ROUNDS, patience=10,
                          eval_every=TRAIN_EVAL_EVERY, driver="scan")
    series = task.series()
    t0 = time.perf_counter()
    labels = task.cluster_labels(series, device="cuda")
    cluster_s = time.perf_counter() - t0
    sizes = np.bincount(labels).tolist()
    if sizes != [21, 27, 10]:
        raise RuntimeError(f"DTW cluster sizes {sizes}, expected [21, 27, 10]")

    torch.cuda.synchronize()
    mix_ops.LAUNCHES = 0                   # every kernel count, just before
    mix_ops.LAUNCHES_SINGLE = 0
    flash_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_experiment(spec, checkpoint_dir=root, series=series,
                         labels=labels, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"psgf_mix_batch": mix_ops.LAUNCHES,  # ... and just after
                "psgf_mix": mix_ops.LAUNCHES_SINGLE,
                "flash_attention": flash_ops.LAUNCHES}
    rounds = sum(r["rounds"] for r in res["rows"])
    if rounds != TRAIN_ROUNDS * 3 or launches["psgf_mix_batch"] != rounds:
        raise RuntimeError(f"{launches['psgf_mix_batch']} psgf_mix launches "
                           f"for {rounds} rounds of 3 clusters")
    if launches["flash_attention"] == 0:
        raise RuntimeError("training launched no flash-attention kernel")
    for r in res["rows"]:
        if not (math.isfinite(r["rmse"]) and r["comm_params"] > 0):
            raise RuntimeError(f"row {r}")

    # the trained manifest, served on the card, against the CPU forward
    _, manifest = read_routing_manifest(root)
    if manifest["station_cluster"] != labels.tolist():
        raise RuntimeError("manifest routes stations to other clusters")
    server = ForecastServer.from_manifest(root, device="cuda", max_batch=32)
    server.warmup(channels=3)
    rep = serve_requests(server, 64, 3, stations=server.routable_stations())
    x = np.random.default_rng(SEED).standard_normal(
        (32, 3, task.look_back)).astype(np.float32)
    serve_err = 0.0
    for c in range(3):
        got = server.predict(x, cluster=c)
        sub = manifest["policies"]["psgf-s30-f20"][str(c)]
        fc_cpu, p_cpu, _ = load_forecaster(os.path.join(root, sub), device="cpu")
        with torch.inference_mode():
            want = F.forward_multivariate(fc_cpu.cfg, p_cpu,
                                          torch.from_numpy(x)).numpy()
        if got.shape != (32, 3, task.horizon) or not np.isfinite(got).all():
            raise RuntimeError(f"served bucket c{c}: shape {got.shape}")
        serve_err = max(serve_err, float(np.max(np.abs(got - want))))
        if not np.allclose(got, want, atol=SERVE_TOL, rtol=SERVE_TOL):
            raise RuntimeError(f"trained c{c} served vs CPU: {serve_err}")
    server.close()

    # card against the port's own CPU run, smallest cluster
    t0 = time.perf_counter()
    versus = card_vs_cpu_round(E, R, task, series, labels, model, grid,
                               spec.seed)
    versus["seconds"] = time.perf_counter() - t0

    # one profiled round of the largest cluster
    c = int(np.argmax(np.bincount(labels)))
    tr, _, _, _ = task.client_data(series, np.nonzero(labels == c)[0])
    fl = spec.fl_config("psgf", tr.shape[0], grid[0][1])
    state, meta = E.init_fl_state(model.cfg, fl, R.PRNGKey(0), device="cuda")
    prof = profile_round(E, state, torch.from_numpy(tr).cuda(),
                         R.PRNGKey(1, device="cuda"), model.cfg, fl, meta)
    per_round = [r["train_s"] / r["rounds"] for r in res["rows"]]
    return {
        "task": "ev full (58 stations, 420 days)",
        "model": model.name, "params": model.num_params(),
        "cluster_sizes": sizes, "cluster_s": cluster_s,
        "rounds_per_cluster": TRAIN_ROUNDS, "eval_every": TRAIN_EVAL_EVERY,
        "rows": res["rows"], "train_s": train_s,
        "s_per_round_by_cluster": per_round,
        "launches": launches,
        "served_requests": rep["requests"],
        "served_max_abs_err_vs_cpu": serve_err,
        "card_vs_cpu_round": versus,
        "profile_round_c%d" % c: prof,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    import repro_torch

    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}, "
                           f"not from this checkout's {src}")
    from repro_torch.core.forecast import FLASH_ATTN_TOL
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.psgf_mix import ops as mix_ops
    from repro_torch.kernels.psgf_mix import ref as mix_ref

    # 1. card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_info())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t0:.1f}s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    record = check_flash_attention(ops, ref, FLASH_ATTN_TOL)
    train_errs = check_flash_training(ops, ref, FLASH_ATTN_TOL)
    record["max_abs_err"] = max(
        [record["max_abs_err"]] + [e for n, e in train_errs.items()
                                   if not n.startswith("vmap_grad")])
    mix_record = check_psgf_mix(mix_ops, mix_ref)

    # 4. the serving path
    serving = drive_serving(ops)
    record["launches"] = serving["flash_attention_launches"]
    log(json.dumps({"serving": serving}))

    # 5. the training path
    training = drive_training(mix_ops, ops)
    mix_record["launches"] = training["launches"]["psgf_mix_batch"]
    mix_record["k1_psgf_mix"]["launches"] = training["launches"]["psgf_mix"]
    record["launches_training"] = training["launches"]["flash_attention"]
    log(json.dumps({"training": training}))
    log(json.dumps({"kernels": [record, mix_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
