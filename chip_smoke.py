#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

  1. card: require CUDA, pin fp32 matmuls and convolutions to full fp32 (no
     TF32), print the card's name and power limit (``nvidia-smi``);
  2. build: compile every CUDA kernel of the port from ``src/repro_torch/csrc``
     (one ``nvcc`` per source, all at once) and print the build time and the
     compiler's register/spill report;
  3. kernels: call each kernel's wrapper on the card at the serving path's
     shape and at the reference test classes, hold it against its plain
     PyTorch version, check one backward, and time the kernel, the plain
     version and the closest single PyTorch call;
  4. serving: the port's main path at full width — two LoGTST cluster models
     (look_back 128, d_model 128, 16 heads, flash attention on, random
     weights from a seeded generator) saved as checkpoints with a routing
     manifest over the 58 stations of the ``ev`` task, restored by
     ``ForecastServer.from_manifest`` on the card and driven through the
     micro-batching queue; then a served bucket against the CPU forward,
     ``stream_evaluate``, and a generation hot-swap.

Then it prints one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. It imports ``torch``, ``numpy``, the
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

    # 4. the main path
    serving = drive_serving(ops)
    record["launches"] = serving["flash_attention_launches"]
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
