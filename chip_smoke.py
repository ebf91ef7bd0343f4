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
     plain PyTorch version (flash attention on its three routes: the short
     kernel within its tolerance at the serving buckets, at training's
     K x 32 and evaluation's K x n_test rows of each cluster and past the
     grid's batch limit, one backward, and one vmap(grad) over 27 clients
     against dense attention; the general kernel (route "scalar") at long
     sequences and fp32 at hd 64 / 128 (GQA 5:1 and 6:1, causal, window,
     kv_len, ragged Sq != Skv, no valid key, past the grid's batch limit),
     and its ``-Xptxas -v`` registers and spills (none may spill in float32
     at hd 64 / 128); the tensor-core kernel, bf16 at hd 64 and 128, within
     its relative bound on GQA, windowed, ragged, padded, empty and
     past-the-grid cases, fewer work tiles than SMs and many more, G = 5, 6
     and 130, causal with Sq != Skv, each call on the route it should take,
     repeated and graph-replayed calls bitwise equal, and its ``-Xptxas -v``
     registers and spills per head dim (none may spill); psgf_mix
     bitwise at K = 21 / 27 / 10 clients of D = 273,284, a ragged D, a
     non-binary mask and the K = 1 case, its count across CUDA-graph
     replays, one kernel per call), and time the kernel, the plain version
     and the closest PyTorch call (flash's short route at the serving
     bucket, at training's 864 rows and at Table I's PatchTST calls of
     phase 18, ``FORECASTER_ATTN``, beside the scalar kernel, and an
     empty kernel's launch as the floor under both);
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
     and comm counters bitwise), and a ``torch.profiler`` split of a round;
  6. hybrid serving: the ssm_scan kernel against its plain version at
     hymba-1.5b's prefill shape (4, 2048, 3200, 16) in float32 and bf16,
     every state dim in both dtypes at ragged and aligned shapes, the final
     state (bitwise in float32) and a repeated call, and flash attention at
     hymba's (4, 2048, 25/5, 64) causal window-1024 shape (float32 on the
     general route, bf16 on the tensor-core route) and at qwen2-1.5b's
     float32 prefill (4, 2048, 12/2, 128) causal (general route), each
     timed beside ``scaled_dot_product_attention``; then
     ``launch.serve.serve("hymba-1.5b", reduced=False)`` at full width
     (1,662,161,600 params, batch 4, prompt 2048, 32 tokens) with the launch
     counts of its prefill (32 of each kernel, flash all on the tensor-core
     route), a profiled prefill, full-width block 0 on the card against the
     CPU, and reduced hymba in float32 on the card against the CPU (tokens
     equal);
  7. training drivers: ``driver="while"`` against ``driver="scan"`` at
     phase 5's full width — run A through ``run_experiment`` (3 clusters, 10
     rounds in chunks of 4, 4 and 2: the remainder graph; rows and trained
     models compared), then run A and run B (patience 1: the stop fires on
     the device, also run with every remaining chunk enqueued and masked)
     on the 27-station cluster stage by stage with the chunk loop under
     ``set_sync_debug_mode("error")``, set-up, warm wall per round and one
     profiled warm chunk of each driver; then ``driver="host"`` against
     ``driver="loop"`` on a 2,048-station ``nn5`` fleet (cohort 256, client
     chunk 64, 2 rounds, an evaluation after each): bitwise, the store
     pinned, bytes per round, peak device memory of each;
  8. the flywheel behind the gateway: phase 5's generation-0 root served
     raw by ``ForecastServer.from_manifest`` (watching its manifest) behind
     an authed ``ForecastGateway``, 16 closed-loop HTTP clients sending
     station-routed raw requests throughout; three stable
     ``stream_evaluate`` reports fed to ``RetrainController.step``, then 40
     drifted days of the 27-station cluster, so ``step`` retrains it with
     the scan driver (generation 1); then a while-driver controller
     retrains it again under the same traffic, capturing its CUDA graphs
     while the gateway serves (generation 2), and the same retrain runs
     alone from a copy of the generation-1 root. Every response 200,
     nothing shed, /healthz through generations 0, 1, 2, sampled forecasts
     of each generation against its checkpoint's CPU forward, the
     untouched clusters' engines and norm stats kept, the online RMSE
     recovered, the while retrain under load bitwise equal to the one
     alone, and the launches of both kernels on this path.
  9. zoo training: ``launch.train.train_psgf("qwen2-1.5b", reduced=False,
     pods=2, sync_interval=4, batch=8, seq=64, steps=12)`` (three syncs)
     and ``train("qwen2-1.5b", reduced=False, batch=4, seq=2048, steps=4)``
     at full width: losses finite and falling, every sync's wire bytes
     equal to the bytes worked out from its realised gates and below full
     sync's, every flash launch on the tensor-core route (two per layer per
     pod-step: the forward and its recompute); warm ms per step, tokens/s,
     ms per sync, peak memory and a ``torch.profiler`` split of one warm
     PSGF step and sync; then reduced qwen2 (one PSGF round) and reduced
     hymba (two steps through both kernels' backward) in float32 on the
     card against the CPU, ssm_scan's gradient against autograd through
     its plain version at hymba's training shape (8, 64, 3200, 16), and
     flash at qwen2's two training shapes, each timed.
 10. PSGF-Fed across processes: phase 7's nn5 cell (2,048 stations, cohort
     256, client chunk 64, full width) once more with ``driver="scan"`` in
     this process, then two fresh interpreters of this script
     (``--distributed-child``, ``launch.distributed.spawn_processes``) on
     ``cuda:0`` over gloo, each holding half of the client state: the
     partitioned ``driver="host"`` run, ``client_mesh`` runs with ``scan``
     and with ``while`` (its segments captured as CUDA graphs around the
     host exchanges), and the process-sharded serving of the distributed
     smoke. Each process's losses, comm, RMSE, ``w_global`` and client
     block must equal phase 7's host run and this scan run bit for bit;
     each reports its rounds/s, exchange bytes and seconds per round, peak
     memory and its own kernel launches (none may be 0).
 11. the zoo's vlm and moe families: flash attention at phi3.5-moe's (4,
     2048, 32/8, 128) and internvl2's (4, 2048, 16/8, 128) bf16 causal
     prefill on the tensor-core route against its plain version, timed
     beside ``scaled_dot_product_attention``; then
     ``launch.serve.serve(..., reduced=False)`` at every published width:
     internvl2-2b whole (1,889,146,880 params; batch 4, 256 patches + 1,792
     tokens), phi3.5-moe-42b-a6.6b at 4 of its 32 layers (4 x 2,048) and
     deepseek-v2-236b at 2 of its 60 layers (2 x 2,048 with dense MLA, then
     1 x 4,096 through ``flash_mha``), 32 tokens each, the depth cut by
     ``dataclasses.replace(cfg, num_layers=...)``; flash launches per
     prefill 24, 4 and 0 (MLA never reaches the kernel), all tensor-core,
     and 2 ``flash_mha`` calls in the 4,096-token prefill; init s, prefill
     ms, decode ms per token and peak memory per model beside the card's
     name and power limit; full-width block 0 and the reduced models
     (float32, 8 greedy tokens) on the card against the CPU, every MoE
     call's top-k experts equal.
 12. the zoo's last two families: flash attention at seamless-m4t's (4,
     2048, 16/16, 64) bf16 prefill and (4, 512, 16/16, 64) training step,
     the encoder's non-causal and the decoder's causal call at each, on the
     tensor-core route against its plain
     version, timed beside ``scaled_dot_product_attention``; ``serve`` at
     the published widths, whole: xlstm-125m (4 x 512: its recurrences are
     eager loops over positions) and seamless-m4t-large-v2 (4 x 2,048
     source frames and 2,048 target tokens; 48 flash launches a prefill,
     all tensor-core), 32 tokens each, with a profiled warm prefill and
     decode step; ``train_psgf`` of xlstm (2 pods x 8 x 16, a sync every 4
     steps, 4 steps), ``train`` of xlstm (4 x 64, 2 steps) and of seamless
     (4 x 512, 8 steps, one pod), their wire bytes and flash launches; the
     cuts and their reasons are beside ``LAST_SERVE``; full-width block 0 and
     the reduced models (float32; xlstm at 4 layers, so both cells run) on
     the card against the CPU: logits, greedy tokens, the prefill's final
     mLSTM / sLSTM states and cross K/V, two training steps' losses.

 13. card training of the moe and vlm families, at every published width:
     ``train`` of internvl2-2b whole (4 x (256 patches + 1,792 tokens), 8
     steps) and of phi3.5-moe-42b-a6.6b at 2 of its 32 layers (4 x 2,048,
     8 steps), then ``train_psgf`` of phi3.5-moe (2 pods x 4 x 512, a sync
     every 4 steps, 8 steps) at the deepest cut whose dry-run estimate is
     within 70 GB; before each run the dry run's one-device peak estimate
     (``launch.dryrun.one_device_peak``), after it the measured peak; losses
     finite and falling, every flash launch on the tensor-core route (two a
     layer and step: the forward and its remat recompute), every sync's
     wire bytes equal to the bytes worked out from its gates and below a
     full sync's; deepseek-v2's full-width estimate (one layer, more than
     the card holds), then reduced deepseek-v2 (2 steps at 2,048 and 4,096
     tokens: dense MLA and ``flash_mha``'s backward), phi3.5-moe and
     internvl2 in float32 on the card against the CPU, losses within 1e-4
     and every MoE call's top-k experts equal; and flash at phi3.5-moe's
     PSGF shape (4, 512, 32/8, 128) against its plain version, timed beside
     ``scaled_dot_product_attention``.
 14. the sharded steps' collectives, in two fresh interpreters of this
     script, one after the other (``--collectives-child``), so that no
     process group meets another and (a) is timed alone, (b) first,
     started with phase 13 and run on the CPU beside it: (a)
     on the card, a one-rank NCCL group and ``make_host_mesh(device="cuda")`` as
     a (1, 1) ``DeviceMesh``: qwen2-1.5b's ``train`` step at full width
     (4 x 2,048, 4 steps) over DTensors laid out by the train rules (the
     flash wrapper taking them itself) beside the plain step from the
     same params, the losses within 1e-5, the param delta, the same
     tensor-core flash launches, ``collective_bytes`` total 0 (every
     group has one rank), ms per step of each, warm from the second;
     (b) on this machine's CPU in a ``fake`` process
     group, every tensor on ``meta``: the dry run's record, with its
     ``collectives``, of qwen2-72b ``train_4k`` on two pods and phi3.5-moe
     ``train_4k`` on one pod at full width (one layer recounted under
     torch's ``CommDebugMode``: the same number of collectives), then
     ``benchmarks/psgf_dp_comm.py``'s table as the port computes it
     (qwen2-1.5b's bf16 param tree on (2, 2, 2), ``full_sync`` against
     ``psgf_sync_static`` at share 0.5 / 0.3 / 0.2: each exactly twice its
     shared leaves' bytes, all across pods) and PSGF-DP's local step (no
     collective). Its wall seconds are printed.
 15. a local mesh, several shards of this process: phase 10's nn5 cell
     with ``client_mesh=Mesh("clients", (cuda:0, cuda:0))`` (two shards of
     the card, each on its own stream, exchanging by device copies),
     ``driver="scan"`` and ``"while"`` (each shard's segments captured on
     its stream), each run twice, every run bitwise phase 10's one-process
     scan run; ms a round beside that run's, exchange bytes and seconds,
     graphs and replays, peak memory, the launches of psgf_mix_batch and
     the short flash route; then phase 5's generation-0 manifest served by
     ``ForecastServer(shard_batch=True)`` over the same two shards beside
     the plain server: each block of a full bucket bitwise the plain
     server's forward of that block, the bucket within ``SERVE_TOL``,
     forecasts/s and p50/p99 of both under the same traffic, one
     ``reload``. Where the machine has two GPUs, all of it again over
     ``(cuda:0, cuda:1)``; otherwise a line says that no such run was made.
 16. one process a GPU: (a) ``launch.train.train`` of qwen2-1.5b at
     published widths and full depth (4 x 2,048, 3 steps) and (b)
     ``launch.serve.serve`` (batch 4, prompt 2,048, 16 tokens), plain in
     this process, then as ``--processes 1`` runs them:
     ``distributed.launch_processes`` starts a child of this script
     (``python -m chip_smoke --host-mesh-child PART DIR``) that runs
     ``launch.train.main`` / ``launch.serve.main``, which join a one-rank
     NCCL group and run on its (1, 1) host mesh over DTensors: the losses,
     the tokens and the logits of the prefill and of every decode step
     bitwise the plain run's, flash all tensor-core and as many launches,
     ms a step and peak of both; (c) phase 10's cell over two gloo
     processes each with a client mesh of two shards of ``cuda:0``
     (``--hybrid-child``), ``scan`` and ``while``, bitwise phase 10's
     one-process scan, ms a round, peak per process, merge and gather
     bytes and host seconds at both levels; (d), started first and run
     beside (c), ``python -m
     repro_torch.launch.distributed --smoke --num-processes 1 --device
     cuda`` (one NCCL rank: the exchange's NCCL transport and barrier).
     Where the machine has two GPUs, (a), (b) and (c) again with one
     process a GPU over NCCL (the first loss and the prefill's logits
     within what splitting the batch moves them on one card, every rank
     the same); otherwise a line says that no such run was made.
 17. the zoo's float32 prefills at full width: ``ModelApi.prefill`` of
     hymba-1.5b (32 layers) and qwen2-1.5b (28 layers), 4 x 2,048 tokens,
     configs ``dataclasses.replace(get_config(arch), dtype="float32")`` as
     the reference's ``examples/long_context_decode.py`` builds them,
     random weights from ``PRNGKey(0)``: exactly 32 / 28 flash launches on
     the general route and none on the others, the last-position logits
     within ``HYBRID_CPU_TOL`` of the same prefill with
     ``attn_impl="chunked"`` (``flash_mha`` in torch ops, no flash kernel)
     from the same params, warm prefill ms and peak memory of both.
 18. the paper's comparison, through the port's own functions as the
     reference's ``benchmarks/table1.py`` and ``table23.py`` run it, in
     one fresh interpreter of this script (``--paper-child DIR``), alone
     on the card: (a) Table I,
     its five forecasters (LoGTST, PatchTST at look_back 512 and 336,
     MLPformer, IDformer) at the paper's widths (d_model 128, 16 heads,
     d_ff 256) with flash attention on, trained centrally from seeded
     random weights (Adam, ``one_cycle(1e-3, 200)``, batch 128 from
     ``default_rng(0)``; one eager step, then the step captured as a CUDA
     graph and replayed) on ETT-like and weather-like windows and
     evaluated on the last 20%: param counts exact, every PatchTST and
     LoGTST flash launch on the short route ((200 + 1) x attention layers
     a run), none for MLPformer and IDformer, the first 5 losses within
     ``TABLE1_CPU_RTOL`` of the same steps on the CPU, mse and mae finite,
     and table1.py's claim (LoGTST's mse beside PatchTST's at their
     parameter ratio) printed as a report. Cut to horizon 96 (the
     reference's full mode also runs 192) and 200 steps a run (its quick
     count). (b) one round of phase 5's 10-station cluster per policy
     (online, pso, psgf, psgf_topk) on the card against the CPU
     (``card_vs_cpu_round``) and psgf_topk's masks on tied scores on
     both; then table23.py's quick grid (online; PSO at shares 0.5 / 0.3;
     PSGF at forward 0.2 and shares 0.5 / 0.3; PSGF-topk 0.3 / 0.2), each
     with the fused psgf_mix downlink, through
     ``run_experiment(driver="while")`` on the full ``nn5`` and ``ev``
     tasks at its settings, uncut (select 0.5, 4 local steps, batch 32,
     max_rounds 120, patience 8, eval every 20): per row comm, RMSE,
     rounds, seconds and the kernels' launches (every flash launch short),
     patience stopping at least one row of each task before max_rounds,
     then Fig. 6's Pareto front (comm against RMSE); last, one PatchTST/63
     step profiled with the flash backward (the plain version's gradient)
     in its own span. A probe of an eager op's host time is taken in this
     process and before and after each stage in the child.

Then it prints ``{"training": ...}``, ``{"hybrid_serving": ...}``,
``{"training_drivers": ...}``, ``{"flywheel": ...}``, ``{"zoo_training":
...}``, ``{"distributed": ...}``, ``{"zoo_families": ...}``,
``{"zoo_last_families": ...}``, ``{"zoo_moe_vlm_training": ...}``,
``{"collectives": ...}``, ``{"local_mesh": ...}``, ``{"host_mesh": ...}``,
``{"float32_prefills": ...}``, ``{"paper_comparison": ...}``, one
``{"kernels": [...]}`` line (flash
attention with its three routes, psgf_mix_batch, psgf_mix, ssm_scan, and
the general flash route on its own path, ``flash_attention_general``), and
last ``{"ok": true, "device": {...}}``. It imports ``torch``, ``numpy``,
the standard library and ``repro_torch`` (from ``src/`` beside this file)
only. With ``--distributed-child DIR`` it is one of phase 10's processes,
with ``--collectives-child card|accounting DIR`` one of phase 14's, with
``--host-mesh-child PART DIR`` or ``--hybrid-child DIR DEVICE`` one of
phase 16's, with ``--paper-child DIR`` phase 18's.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
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


# the tensor-core route (bf16, hd 64 / 128) against the float32 plain version
# on the same bf16 inputs: within FLASH_BF16_RTOL |want| + FLASH_BF16_ATOL
# (P and the output rounded to bf16; the reason is beside the constants in
# kernels/flash_attention/ops.py) and within the absolute bf16 bound
BF16_TOL = 2e-2


def route_of(ops, q, k) -> str:
    """The route ``ops.kernel_route`` names for this call."""
    return ops.kernel_route(q.dtype, q.shape[3], tuple(q.shape), tuple(k.shape))


def flash_case(ops, ref, name, q, k, v, causal, window, kv_len, tol):
    """One call of the wrapper against the plain version: exactly one launch
    on the route ``kernel_route`` names, and the error within ``tol`` (and,
    on the tensor-core route, within the relative bound). Returns
    ``(output, max |err|, worst error / relative bound or None)``."""
    route = route_of(ops, q, k)
    before, before_route = ops.LAUNCHES, ops.ROUTE_LAUNCHES[route]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
    torch.cuda.synchronize()
    if (ops.LAUNCHES != before + 1
            or ops.ROUTE_LAUNCHES[route] != before_route + 1):
        raise RuntimeError(f"{name}: the wrapper did not launch the {route} "
                           f"kernel once")
    if got.dtype != q.dtype or got.shape != q.shape:
        raise RuntimeError(f"{name}: output {got.dtype} {tuple(got.shape)}")
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    if route == "tensor_core":
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **mask)
    else:
        want = ref.flash_attention_ref(q, k, v, **mask).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    ratio = None
    if route == "tensor_core":
        bound = ops.FLASH_BF16_RTOL * want.abs() + ops.FLASH_BF16_ATOL
        ratio = float((diff / bound).max())
    if not (err <= tol and (ratio is None or ratio <= 1.0)):
        raise RuntimeError(f"{name} ({route}): kernel vs plain max |err| {err} "
                           f"(tol {tol}), relative-bound ratio {ratio}")
    return got, err, ratio


# Table I's PatchTST at the paper's widths (16 heads of 8), phase 18's calls:
# (B, Sq, Skv, H, KV, hd) of a training batch of 128 at look_back 512 (63
# tokens: Sq * H = 1,008 of the short kernel's 1,024 threads, its slabs
# 96,768 of 114,688 bytes) and 336 (41 tokens), and of look_back 512's
# evaluation over weather-like's 11,639 test rows
FORECASTER_ATTN = {"patchtst63_batch": (128, 63, 63, 16, 16, 8),
                   "patchtst41_batch": (128, 41, 41, 16, 16, 8),
                   "patchtst63_eval": (11_639, 63, 63, 16, 16, 8)}


def check_flash_attention(ops, ref, tol_f32: float) -> dict:
    """Kernel vs plain version on the card, all three routes; returns the
    main-path record (the short route at the serving bucket, with the
    training shape's times and the launch floor)."""
    gen = torch.Generator().manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, Sq, Skv, H, KV, hd), causal, window, kv_len, dtype, tol
        ("main_path", (96, 15, 15, 16, 16, 8), False, None, None, f32, tol_f32),
        ("gqa_causal_hd64", (2, 256, 256, 4, 2, 64), True, None, None, f32, 2e-5),
        ("window64_hd128", (1, 200, 200, 4, 4, 128), True, 64, None, f32, 2e-5),
        ("sq_ne_skv_bidir", (2, 128, 384, 8, 2, 64), False, None, None, f32, 2e-5),
        ("bf16_hd128", (1, 256, 256, 2, 1, 128), True, None, None, bf16, BF16_TOL),
        ("window17_hd32", (1, 100, 100, 6, 3, 32), True, 17, None, f32, 2e-5),
        ("bidir_100_gqa", (1, 100, 100, 4, 2, 32), False, None, None, f32, 2e-5),
        ("bidir_130_hd16", (1, 130, 130, 8, 8, 16), False, None, None, f32, 2e-5),
        ("bidir_63_hd64", (3, 63, 63, 2, 1, 64), False, None, None, f32, 2e-5),
        ("kv_len_100", (1, 128, 256, 2, 2, 16), False, None, 100, f32, 2e-5),
        ("bf16_hd16_scalar", (1, 100, 100, 12, 2, 16), True, 17, None, bf16, BF16_TOL),
        # the short route: the forecaster's 63 tokens, GQA with every mask,
        # no valid key (exact zeros), hd 16 and 32, bf16
        ("short_63_tokens", (4, 63, 63, 16, 16, 8), False, None, None, f32, tol_f32),
        # Table I's PatchTST (phase 18): look_back 512's and 336's training
        # batch, and look_back 512's evaluation over weather-like's test rows
        ("short_patchtst63_batch", FORECASTER_ATTN["patchtst63_batch"], False,
         None, None, f32, tol_f32),
        ("short_patchtst41_batch", FORECASTER_ATTN["patchtst41_batch"], False,
         None, None, f32, tol_f32),
        ("short_patchtst63_eval", FORECASTER_ATTN["patchtst63_eval"], False,
         None, None, f32, tol_f32),
        ("short_gqa_window_kv_len", (2, 15, 15, 16, 4, 8), True, 5, 12, f32, tol_f32),
        ("short_no_valid_key", (2, 7, 40, 4, 1, 8), True, None, 0, f32, 0.0),
        ("short_window_kv_len_hd16", (2, 30, 20, 16, 2, 16), False, 9, 17, f32, tol_f32),
        ("short_hd32", (2, 15, 15, 16, 16, 32), False, None, None, f32, tol_f32),
        ("bf16_hd16_short", (1, 100, 100, 4, 2, 16), True, 17, None, bf16, BF16_TOL),
        ("bf16_hd8_short", (5, 15, 15, 16, 16, 8), False, None, None, bf16, BF16_TOL),
        ("bf16_hd32_short", (3, 16, 16, 16, 8, 32), False, 4, None, bf16, BF16_TOL),
    ]
    # the tensor-core route's cases, at hd 64 and 128
    for hd in (64, 128):
        cases += [
            (f"tc_gqa5_window1024_hd{hd}", (1, 2048, 2048, 5, 1, hd), True, 1024,
             None, bf16, BF16_TOL),
            (f"tc_window17_hd{hd}", (1, 100, 100, 6, 3, hd), True, 17, None, bf16,
             BF16_TOL),
            (f"tc_sq_ne_skv_bidir_hd{hd}", (2, 128, 384, 8, 2, hd), False, None,
             None, bf16, BF16_TOL),
            (f"tc_kv_len_100_hd{hd}", (1, 128, 256, 2, 2, hd), False, None, 100,
             bf16, BF16_TOL),
            (f"tc_no_valid_key_hd{hd}", (2, 7, 40, 4, 1, hd), True, None, 0, bf16,
             0.0),
            (f"tc_sq63_hd{hd}", (3, 63, 63, 2, 1, hd), False, None, None, bf16,
             BF16_TOL),
            (f"tc_sq130_hd{hd}", (1, 130, 130, 8, 8, hd), True, None, None, bf16,
             BF16_TOL),
            (f"tc_batch70000_hd{hd}", (70_000, 15, 15, 2, 1, hd), False, None,
             None, bf16, BF16_TOL),
            # the persistent grid and its row blocks: fewer work tiles than
            # SMs; G = 5 and 6 (12 and 10 positions a row block, so blocks
            # end inside no position and rows 60-63 are padding); G above 64
            # (head chunks of one position); causal with Sq != Skv both
            # ways; a ragged kv_len; a window without causal
            (f"tc_few_tiles_hd{hd}", (1, 64, 64, 8, 8, hd), False, None, None,
             bf16, BF16_TOL),
            (f"tc_g5_hd{hd}", (2, 100, 100, 10, 2, hd), True, None, None, bf16,
             BF16_TOL),
            (f"tc_g6_window17_hd{hd}", (2, 70, 70, 12, 2, hd), True, 17, None,
             bf16, BF16_TOL),
            (f"tc_g130_hd{hd}", (1, 40, 40, 130, 1, hd), True, None, None, bf16,
             BF16_TOL),
            (f"tc_causal_sq_lt_skv_hd{hd}", (2, 100, 300, 8, 2, hd), True, None,
             None, bf16, BF16_TOL),
            (f"tc_causal_sq_gt_skv_hd{hd}", (2, 300, 100, 8, 2, hd), True, None,
             None, bf16, BF16_TOL),
            (f"tc_causal_kv_len77_hd{hd}", (2, 200, 200, 6, 3, hd), True, None,
             77, bf16, BF16_TOL),
            (f"tc_window50_bidir_hd{hd}", (1, 300, 300, 4, 2, hd), False, 50,
             None, bf16, BF16_TOL),
        ]
    # the general route in float32 at hd 64 and 128 (the zoo's float32
    # prefills): GQA 5:1 and 6:1, causal, window, kv_len, ragged Sq != Skv
    # both ways, no valid key (exact zeros), a batch past the grid's limit
    for hd in (64, 128):
        cases += [
            (f"gen_gqa5_window37_hd{hd}", (1, 300, 300, 10, 2, hd), True, 37,
             None, f32, 2e-5),
            (f"gen_gqa6_causal_hd{hd}", (2, 130, 130, 12, 2, hd), True, None,
             None, f32, 2e-5),
            (f"gen_causal_sq_lt_skv_hd{hd}", (2, 100, 300, 8, 2, hd), True,
             None, None, f32, 2e-5),
            (f"gen_causal_sq_gt_skv_kv_len77_hd{hd}", (2, 300, 100, 6, 1, hd),
             True, None, 77, f32, 2e-5),
            (f"gen_window50_bidir_kv_len350_hd{hd}", (1, 300, 400, 4, 4, hd),
             False, 50, 350, f32, 2e-5),
            (f"gen_no_valid_key_hd{hd}", (2, 7, 40, 5, 1, hd), True, None, 0,
             f32, 0.0),
            (f"gen_batch70000_hd{hd}", (70_000, 15, 15, 2, 1, hd), False, None,
             None, f32, 2e-5),
        ]
    # more work tiles (8,192) than the grid's blocks take in one round
    cases.append(("tc_many_tiles_hd128", (64, 512, 512, 32, 8, 128), True, None,
                  None, bf16, BF16_TOL))
    errs, ratios, routes = {}, {}, {}
    for name, shape, causal, window, kv_len, dtype, tol in cases:
        q, k, v = attention_inputs(gen, *shape, dtype)
        got, errs[name], ratio = flash_case(ops, ref, name, q, k, v, causal,
                                            window, kv_len, tol)
        routes.setdefault(route_of(ops, q, k), []).append(name)
        if ratio is not None:
            ratios[name] = ratio
        if kv_len == 0 and not torch.equal(got, torch.zeros_like(got)):
            raise RuntimeError(f"{name}: rows with no valid key are not 0")
        if name == "main_path":
            main_case = (q, k, v, errs[name])
        del q, k, v, got
    if routes["short"][0] != "main_path" or not routes.get("scalar"):
        raise RuntimeError(f"flash cases took the routes {routes}")

    # every shape the serving path gives the kernel: buckets 1..32 times
    # 1 channel (stream_evaluate) or 3 channels (serve_requests)
    bucket_err = 0.0
    for rows in sorted({b * m for b in (1, 2, 4, 8, 16, 32) for m in (1, 3)}):
        q, k, v = attention_inputs(gen, rows, 15, 15, 16, 16, 8, f32)
        before = ops.ROUTE_LAUNCHES["short"]
        got = ops.flash_attention(q, k, v, causal=False)
        if ops.ROUTE_LAUNCHES["short"] != before + 1:
            raise RuntimeError(f"serving bucket {rows}: not on the short route")
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
    repeats = check_tensor_core_repeats(ops, gen)
    log(json.dumps({"kernel_cases": {"flash_attention": errs,
                                     "flash_attention_bf16_bound_ratio": ratios,
                                     "flash_attention_routes": routes,
                                     "tensor_core_repeats": repeats}}))

    # times at the serving bucket and at training's K x 32 rows: the short
    # route, the scalar kernel on the same inputs (its route forced), the
    # plain version and SDPA, in turns; an empty kernel's launch is the
    # floor under all of them
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.bound import attention_bound

    empty = _build.load("flash_attention_short").flash_attention_short_empty
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    floor_ms = timed_ms(lambda: empty(torch.cuda.current_stream().cuda_stream))
    q, k, v, err = main_case
    # (and the serving bucket at look_back 512: 63 tokens, 1,008 pairs, and
    # Table I's PatchTST calls of phase 18)
    shapes = {"serving": (q, k, v),
              "training": attention_inputs(gen, TRAIN_ROWS, 15, 15, 16, 16, 8, f32),
              "serving_63_tokens": attention_inputs(gen, 96, 63, 63, 16, 16, 8, f32),
              **{key: attention_inputs(gen, *shape, f32)
                 for key, shape in FORECASTER_ATTN.items()}}
    times = {}
    for key, (q, k, v) in shapes.items():
        short = lambda: ops.flash_attention(q, k, v, causal=False)  # noqa: E731
        scalar = lambda: ops._launch(q, k, v, False, None, None,    # noqa: E731
                                     route="scalar")
        scalar_err = float((scalar() - ref.flash_attention_ref(q, k, v, causal=False))
                           .abs().max())
        if not scalar_err <= tol_f32:
            raise RuntimeError(f"scalar kernel at the {key} shape: max |err| "
                               f"{scalar_err}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        runs = {"short": [timed_ms(short)], "scalar": [timed_ms(scalar)]}
        plain_ms = timed_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False))
        library_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt))
        runs["scalar"].append(timed_ms(scalar))
        runs["short"].append(timed_ms(short))
        bound = attention_bound(tuple(q.shape), tuple(k.shape), q.dtype)
        times[key] = {"shape": list(q.shape), "ms": statistics.median(runs["short"]),
                      "ms_runs": runs["short"],
                      "scalar_ms": statistics.median(runs["scalar"]),
                      "scalar_ms_runs": runs["scalar"], "scalar_max_abs_err": scalar_err,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound["ms"], "bound_by": bound["bound_by"],
                      "bytes": bound["bytes"], "flops": bound["flops"]}
    serving = times["serving"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "kernel_route": "short",
        "source": "src/repro_torch/csrc/flash_attention_short.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:114",
        "tpu_kernel": "src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel",
        "shape": serving["shape"],
        "max_abs_err": err,
        "ms": serving["ms"],
        "kernel_ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
        "library_call": "scaled_dot_product_attention",
        "bytes": serving["bytes"],
        "flops": serving["flops"],
        "launch_floor_ms": floor_ms,
        "general_case_errs": {n: e for n, e in errs.items() if n.startswith("gen_")},
        "serving_shape": serving,
        "training_shape": times["training"],
        "serving_63_tokens_shape": times["serving_63_tokens"],
        "table1_shapes": {key: times[key] for key in FORECASTER_ATTN},
    }


# the tensor-core kernel's design, for the kernels line (its source note
# says why)
TENSOR_CORE_DESIGN = (
    "warp-specialised: 1 producer warpgroup (setmaxnreg 40; one thread issues "
    "every TMA load of Q and the K/V ring) + 2 consumer warpgroups (232), "
    "ping-pong on named barriers, S_j with P_{j-1}.V_{j-1} in flight "
    "(wait_group 1), Q double-buffered and O stored by TMA; persistent grid "
    "min(SMs, work tiles), longest-first snake schedule; 128-key tiles at hd "
    "64, 64-key at hd 128, 4 stages")


def tensor_core_ptxas(build) -> dict:
    """``-Xptxas -v``'s registers and spills of the tensor-core kernel per
    head dim; raises if either spills."""
    report = build.parse_ptxas(build.build_log("flash_attention_tc"))
    out = {f"hd{hd}": entry for name, entry in report.items()
           for hd in (64, 128) if f"ILi{hd}E" in name}
    if sorted(out) != ["hd128", "hd64"] or any(
            e.get("spill_stores", 1) or e.get("spill_loads", 1) for e in out.values()):
        raise RuntimeError(f"tensor-core kernel's ptxas report: {out}")
    log(json.dumps({"tensor_core_ptxas": out}))
    return out


def check_tensor_core_repeats(ops, gen) -> dict:
    """The tensor-core kernel's static schedule: two eager calls, and a call
    captured in a CUDA graph and replayed, bitwise equal to the first eager
    call, at hd 64 and 128 (phi3.5-moe's PSGF shape and seamless's training
    shape, causal)."""
    out = {}
    for shape in ((4, 512, 512, 32, 8, 128), (4, 512, 512, 16, 16, 64)):
        q, k, v = attention_inputs(gen, *shape, torch.bfloat16)
        eager = ops.flash_attention(q, k, v, causal=True)
        again = ops.flash_attention(q, k, v, causal=True)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.flash_attention(q, k, v, causal=True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ops.flash_attention(q, k, v, causal=True)
        graph.replay()
        torch.cuda.synchronize()
        key = f"hd{shape[-1]}"
        out[key] = {"eager_bitwise": bool(torch.equal(eager, again)),
                    "graph_bitwise": bool(torch.equal(eager, captured))}
        if not all(out[key].values()):
            raise RuntimeError(f"tensor-core kernel at {shape}: repeated calls "
                               f"differ {out[key]}")
    return out


# LocalUpdate's vmap(grad_and_value) through the kernel against the dense
# attention path, both on the card: the two differ in accumulation order
# (~1e-6 relative per attention output), which the backward sums over 15
# tokens x 32 series per client
VMAP_GRAD_TOL = 1e-4
VMAP_LOSS_TOL = 1e-5
TRAIN_BATCH = 32
TRAIN_ROWS = 27 * TRAIN_BATCH      # the largest cluster's LocalUpdate batch


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
        before = ops.LAUNCHES, ops.ROUTE_LAUNCHES["short"]
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        if (ops.LAUNCHES, ops.ROUTE_LAUNCHES["short"]) != (before[0] + 1,
                                                           before[1] + 1):
            raise RuntimeError(f"{name}: the wrapper did not launch the short "
                               f"kernel once")
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

    before = ops.LAUNCHES, ops.ROUTE_LAUNCHES["short"]
    g_flash, l_flash = grads(dataclasses.replace(cfg, use_flash_attn=True))
    torch.cuda.synchronize()
    if (ops.LAUNCHES, ops.ROUTE_LAUNCHES["short"]) != (before[0] + 1,
                                                       before[1] + 1):
        raise RuntimeError(f"vmap(grad) over {K} clients: "
                           f"{ops.LAUNCHES - before[0]} kernel launches "
                           f"({ops.ROUTE_LAUNCHES}), not 1 short")
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


def latency_histogram(server):
    """The server's submit -> result latency histogram, all clusters pooled:
    ``(cumulative bucket counts, bounds)``."""
    hist = server.metrics.families()
    hist = next(f for f in hist if f.name == "forecast_latency_seconds")
    cum = [0] * (len(hist.bounds) + 1)
    for _, child in hist.samples():
        cum = [a + b for a, b in zip(cum, child.get()[0])]
    return cum, hist.bounds


def latency_quantiles(server, since=None, until=None) -> dict:
    """p50/p99 submit -> result latency over every request so far, or
    between two ``latency_histogram`` snapshots, estimated from the server's
    latency histogram (all clusters pooled)."""
    from repro_torch.launch.metrics import quantile_from_buckets

    cum, bounds = until or latency_histogram(server)
    if since is not None:
        cum = [a - b for a, b in zip(cum, since[0])]
    return {q: quantile_from_buckets(cum, bounds, q) for q in (0.5, 0.99)}


def host_ms(fn) -> float:
    """Host wall time of one ``fn()`` that ends in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_device(fn, iters: int, unit: str) -> dict:
    """Device busy time vs host wall time of ``iters`` calls of ``fn``, from
    ``torch.profiler``; device numbers are None when the profiler recorded
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
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
        return {f"wall_ms_per_{unit}": wall_ms, f"device_ms_per_{unit}": None,
                "device_idle_share": None, f"device_ops_per_{unit}": None}
    device_ms = device_us / 1e3 / iters
    return {
        f"wall_ms_per_{unit}": wall_ms,
        f"device_ms_per_{unit}": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        f"device_ops_per_{unit}": kernels / iters,
        f"top_device_ms_per_{unit}": {k: d / 1e3 / iters for d, k in top[:6]},
    }


def profile_forward(server, x, cluster, iters: int = 20) -> dict:
    """``profile_device`` over ``iters`` served bucket forwards."""
    return profile_device(lambda: server.predict(x, cluster=cluster), iters,
                          "forward")


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

    ops.reset_launch_counts()              # every kernel count, just before
    rep = serve_requests(server, 256, 3, stations=server.routable_stations())
    torch.cuda.synchronize()
    launches = ops.LAUNCHES                # ... and just after the main path
    routes = dict(ops.ROUTE_LAUNCHES)
    if launches < rep["batches"] or rep["batches"] == 0:
        raise RuntimeError(f"{launches} flash-attention launches for "
                           f"{rep['batches']} dispatched batches")
    if ops.ROUTE_LAUNCHES["short"] != launches:
        raise RuntimeError(f"serving's fp32 hd-8 attention took the routes "
                           f"{ops.ROUTE_LAUNCHES}")
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
        "flash_route_launches": routes,
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
    from repro_torch.common import hw

    nbytes = (3 * K * D + D) * 4
    return max(nbytes / hw.HBM_BYTES_PER_S, 3 * K * D / hw.FP32_FLOP_PER_S) * 1e3, nbytes


def check_psgf_mix_replays(gen, mix_ops, mix_ref) -> dict:
    """One call captured in a CUDA graph and replayed three times, at K = 1
    and K = 27: the mix bitwise and the count exact each time (the last
    block resets the ticket counter, so every replay starts clean); two
    calls back to back give the same count."""
    out = {}
    for K in (1, max(MIX_K)):
        g, w, m = mix_inputs(gen, K, MIX_D, "binary")
        want, want_count = mix_ref.psgf_mix_batch_ref(g, w, m)
        first = mix_ops.psgf_mix_batch(g, w, m)[1]
        second = mix_ops.psgf_mix_batch(g, w, m)[1]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            mixed, count = mix_ops.psgf_mix_batch(g, w, m)
        counts = []
        for _ in range(3):
            mixed.zero_()
            count.fill_(-1.0)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(mixed, want):
                raise RuntimeError(f"psgf_mix K={K}: a graph replay's mix is "
                                   f"not bitwise the plain version's")
            counts.append(float(count))
        if counts + [float(first), float(second)] != [float(want_count)] * 5:
            raise RuntimeError(f"psgf_mix K={K}: counts {counts} in replays, "
                               f"{float(first)}, {float(second)} back to back; "
                               f"want {float(want_count)}")
        out[f"K{K}"] = {"replay_counts": counts, "count": float(want_count)}
    return out


def kernels_per_call(fn) -> list:
    """Names of the device operations (kernels, copies, fills) one ``fn()``
    runs, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


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
    replays = check_psgf_mix_replays(gen, mix_ops, mix_ref)
    g, w, m = mix_inputs(gen, max(MIX_K), MIX_D, "binary")
    per_call = kernels_per_call(lambda: mix_ops.psgf_mix_batch(g, w, m))
    if not (len(per_call) == 1 and "psgf_mix_kernel" in per_call[0]):
        raise RuntimeError(f"one psgf_mix call ran the device operations "
                           f"{per_call}, not the mix alone")
    log(json.dumps({"kernel_cases": {"psgf_mix": errs,
                                     "psgf_mix_graph_replays": replays,
                                     "psgf_mix_device_ops_per_call": per_call}}))

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
        per_k[K] = {"grid_blocks": mix_ops._kernel_fns()[0](MIX_D, K),
                    "ms": statistics.median([kernel_ms, kernel_ms2]),
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


def card_vs_cpu_round(E, R, task, series, labels, model, entry, seed):
    """One round of the smallest cluster under the grid entry ``entry``
    (``(policy, overrides)``) from the same state and key on the card and on
    the CPU: selection, downlink gates, the mixed matrix, the uplink gates
    and the comm counters bitwise; the new global model within ROUND_TOL.

    psgf_topk's uplink gates are the top k of ``|global - trained row|``:
    where the card's and the CPU's trained rows differ by float noise at
    the k-th largest difference, each device keeps another element (a flip;
    k, and so the counts, stay exact). For it the flips are counted, the
    uplink gates the CPU draws from the card's own trained rows must equal
    the card's bit for bit (the same selection and tie rule), and the
    global model is held within ROUND_TOL where no selected client's
    uplink gate flipped."""
    c = int(np.argmin(np.bincount(labels)))
    idx = np.nonzero(labels == c)[0]
    tr, _, _, _ = task.client_data(series, idx)
    policy_name, overrides = entry
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
        # the round's own uplink gates, from its trained rows (_round_up)
        up = policy.uplink_gates(down["k_upmask"], state["w_global"],
                                 new_state["w_clients"], down["selected"])
        out[dev] = (down, new_state, metrics, up)
    (dc, sc, mc, uc), (dg, sg, mg, ug) = out["cpu"], out["cuda"]
    ug = ug.cpu()
    from_card_rows = policy.uplink_gates(dc["k_upmask"], state_cpu["w_global"],
                                         sg["w_clients"].cpu(), dc["selected"])
    flips = uc != ug
    n_flips = int(flips.sum())
    same = {
        "selected": torch.equal(dc["selected"], dg["selected"].cpu()),
        "gates": torch.equal(dc["gates"], dg["gates"].cpu()),
        "w_mixed": torch.equal(dc["w_mixed"], dg["w_mixed"].cpu()),
        "uplink_gates_from_the_card_rows": torch.equal(from_card_rows, ug),
        "comm_down": torch.equal(sc["comm_down"], sg["comm_down"].cpu()),
        "comm_up": torch.equal(sc["comm_up"], sg["comm_up"].cpu()),
        "adam_t": torch.equal(sc["adam_t"], sg["adam_t"].cpu()),
        "num_selected": float(mc["num_selected"]) == float(mg["num_selected"]),
    }
    if policy_name != "psgf_topk":
        same["uplink_gates"] = n_flips == 0
    if not all(same.values()):
        raise RuntimeError(f"card round != CPU round: {same}")
    keep = E.bk_free(meta) & ~flips.any(0)      # attn/bk: see FL_PARITY_TOL
    diff = (sg["w_global"].cpu() - sc["w_global"]).abs()
    err = float(diff[keep].max())
    if not err <= ROUND_TOL:
        raise RuntimeError(f"card vs CPU w_global max |err| {err} > {ROUND_TOL}")
    return {"policy": policy_name, "cluster": c, "clients": int(tr.shape[0]),
            "bitwise": same,
            "comm_down": float(sc["comm_down"]), "comm_up": float(sc["comm_up"]),
            "w_global_max_abs_err": err,
            "uplink_gate_flips": n_flips,
            "elements_with_a_flip": int(flips.any(0).sum()),
            "w_global_max_abs_err_at_flips": float(diff[flips.any(0)].max())
            if n_flips else 0.0,
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


def profile_spans(fn, prefixes) -> dict:
    """``torch.profiler`` over one ``fn()``: device busy time, device time
    per ``record_function`` range named with one of ``prefixes`` (each
    kernel assigned to the range whose span on the device holds its start:
    this counts the kernels the port launches through ``ctypes`` too) and
    the device idle share. A kernel in no span (autograd launches the
    backward's from its own thread) goes to ``"other"``; each stage also
    has its window (first kernel start to last kernel end, over each run of
    its kernels in device order) and the idle share within it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    named = lambda n: n.startswith(tuple(prefixes))  # noqa: E731
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and named(e.name)]
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and not named(e.name)),
                     key=lambda e: e.time_range.start)
    stages = {name: {"device_ms": 0.0, "kernels": 0, "window_ms": 0.0}
              for name, _, _ in spans}
    stages["other"] = {"device_ms": 0.0, "kernels": 0, "window_ms": 0.0}
    runs = []                    # [name, first start, last end] in device order
    for e in kernels:
        name = next((n for n, a, b in spans if a <= e.time_range.start < b),
                    "other")
        stages[name]["device_ms"] += e.time_range.elapsed_us() / 1e3
        stages[name]["kernels"] += 1
        if runs and runs[-1][0] == name:
            runs[-1][2] = max(runs[-1][2], e.time_range.end)
        else:
            runs.append([name, e.time_range.start, e.time_range.end])
    for name, start, end in runs:
        stages[name]["window_ms"] += (end - start) / 1e3
    for stage in stages.values():
        w = stage["window_ms"]
        stage["idle_share"] = max(0.0, 1 - stage["device_ms"] / w) if w else None
    for ev in prof.key_averages():
        if ev.key in stages and ev.device_type == DeviceType.CPU:
            stages[ev.key]["cpu_ms"] = ev.cpu_time_total / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                  if busy_ms else None),
            "device_ops": len(kernels), "stages": stages}


def profile_round(E, state, data, key, cfg, fl, meta) -> dict:
    """``profile_spans`` over one warm round, split by engine stage."""
    policy = E.pol.from_config(fl)
    E._round(state, data, key, cfg, fl, meta, policy)      # warm
    return profile_spans(lambda: E._round(state, data, key, cfg, fl, meta, policy),
                         ("fl.",))


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
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(spec, checkpoint_dir=root, series=series,
                         labels=labels, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"psgf_mix_batch": mix_ops.LAUNCHES,  # ... and just after
                "psgf_mix": mix_ops.LAUNCHES_SINGLE,
                "flash_attention": flash_ops.LAUNCHES}
    flash_routes = dict(flash_ops.ROUTE_LAUNCHES)
    if flash_ops.ROUTE_LAUNCHES["short"] != launches["flash_attention"]:
        raise RuntimeError(f"training's fp32 hd-8 attention took the routes "
                           f"{flash_ops.ROUTE_LAUNCHES}")
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
    versus = card_vs_cpu_round(E, R, task, series, labels, model, grid[0],
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
        "flash_routes": flash_routes,
        "served_requests": rep["requests"],
        "served_max_abs_err_vs_cpu": serve_err,
        "card_vs_cpu_round": versus,
        "profile_round_c%d" % c: prof,
    }


# ---------------------------------------------------------------------------
# Phase 7: the while and host FL drivers
# ---------------------------------------------------------------------------

WHILE_A = dict(max_rounds=10, eval_every=4, patience=100)   # chunks 4, 4, 2
WHILE_B = dict(max_rounds=48, eval_every=4, patience=1)     # the stop fires
# the nn5 cell of phases 7, 10, 15 and 16: 2 rounds, an evaluation after
# each (cut from 4 rounds in chunks of 2 for the script's time): two
# evaluations and a while run's chunk graph replayed twice, as before
HOST_K, HOST_S, HOST_CHUNK, HOST_ROUNDS, HOST_EVAL = 2048, 256, 64, 2, 1
DIST_PROCESSES = 2          # phase 10: processes sharing the card

KERNEL_NAMES = {"flash_short": "flash_short_kernel",
                "psgf_mix_batch": "psgf_mix_kernel"}


def profile_chunk(fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` (a chunk of rounds, ended
    by a device sync): host wall ms, device busy ms, the idle share, the
    device kernels and how many of them each of the port's kernels is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the engine's record_function ranges ("fl.*"),
    # which eager runs also show on the device and which span their kernels
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("fl.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    named = {k: sum(1 for e in kernels if pat in e.name)
             for k, pat in KERNEL_NAMES.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                  if busy_ms else None),
            "device_ops": len(kernels), "kernels": named}


def event_ms(fn) -> float:
    """Device time of one ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@contextlib.contextmanager
def counting_captures(E, counts):
    """Count the kernel wrappers' calls captured in each CUDA graph that the
    engine captures in the block: its capture helper is wrapped so that each
    capture appends ``(id(graph), change of counts() across it)`` to the
    list yielded. Graphs of one run are captured longest chunk first."""
    captured, capture = [], E._capture_graph

    @contextlib.contextmanager
    def counted(graph, pool, stream):
        before = counts()
        with capture(graph, pool, stream):
            yield
        after = counts()
        captured.append((id(graph), {k: after[k] - before[k] for k in after}))

    E._capture_graph = counted
    try:
        yield captured
    finally:
        E._capture_graph = capture


def while_stepwise(E, R, cfg, fl, tr, te, seed, max_rounds, eval_every,
                   patience, counts=None, mask_all=False):
    """The while driver stage by stage, as ``run_fl`` runs it, with the
    chunk loop (first replay to the final read) under
    ``set_sync_debug_mode("error")``: any host sync in it raises.

    With ``counts`` (a function that reads the kernel wrappers' counters)
    the run's kernel launches are counted two ways: each captured graph's
    wrapper calls (the counters' change across its capture) times that
    graph's replays, exact; and ``torch.profiler`` over the run itself
    (:func:`profile_chunk`; the profiler does not synchronize), which shows
    the kernels ran inside the replays but may lose a few events. With
    ``mask_all`` the host never reads the stop flag: every chunk's graph is
    replayed in turn and the chunks past the stop are masked on the card
    (the design the pipelined stop replaced, measured beside it)."""
    key = R.split(R.PRNGKey(seed, device="cuda")).unbind(0)
    state, meta = E.init_fl_state(cfg, fl, key[1], device="cuda")
    with counting_captures(E, counts or (lambda: {})) as captured:
        run = E._WhileRun(state, key[0], torch.from_numpy(tr).cuda(),
                          torch.from_numpy(te).cuda(), cfg, fl, meta,
                          E.pol.from_config(fl), max_rounds, eval_every,
                          patience)
    captured = dict(captured)
    torch.cuda.synchronize()
    got = []

    def go():
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if mask_all:
                for length in run.lengths:
                    run.graphs[length].replay()
            else:
                run.launch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got.extend(run.read())
        got.append(time.perf_counter() - t0)

    prof = profile_chunk(go) if counts is not None else go()
    rounds, chunks, losses, comms, rmses, replay_s = got
    wh = {"rounds_run": rounds, "chunks_run": chunks, "train_loss": losses,
          "comm": comms, "rmse": rmses, "replay_s": replay_s, "profile": prof}
    if counts is not None:
        per = {n: captured[id(g)] for n, g in run.graphs.items()}
        if any(per[n]["psgf_mix_batch"] != n for n in per):
            raise RuntimeError(f"one psgf_mix call a round expected: {per}")
        wh["captured_per_replay"] = {str(n): v for n, v in per.items()}
        wh["launches"] = {k: sum(per[n][k] * run.replays[n] for n in per)
                          for k in KERNEL_NAMES}
        if not all(prof["kernels"].values()):
            raise RuntimeError(f"a kernel is missing from the run's trace: "
                               f"{prof['kernels']}")
    return run, meta, wh


def while_vs_scan(E, R, cfg, fl, tr, te, seed, run_kw, counts=None) -> dict:
    """One cluster under the while driver (stage by stage, chunks pipelined
    two deep; for run B also with every chunk replayed and masked past the
    stop) and under ``run_fl(driver="scan")`` from the same key:
    ``rounds_run``, comm and the RMSE indices bitwise, states within
    ROUND_TOL; set-up and warm wall per round apart; one warm chunk
    profiled for each, and with ``counts`` the while run's own launches
    and trace (:func:`while_stepwise`)."""
    E.run_fl(cfg, fl, tr, te, R.PRNGKey(seed), driver="scan", device="cuda",
             max_rounds=1)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = E.run_fl(cfg, fl, tr, te, R.PRNGKey(seed), driver="scan",
                  device="cuda", **run_kw)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    run, meta, wh = while_stepwise(E, R, cfg, fl, tr, te, seed, **run_kw,
                                   counts=counts)
    n = run_kw["eval_every"]
    rmse_rounds = [min((i + 1) * n, run_kw["max_rounds"]) - 1
                   for i in range(wh["chunks_run"])]
    same = {"rounds_run": wh["rounds_run"] == sh["rounds_run"],
            "comm": wh["comm"] == sh["comm"],
            "rmse_rounds": rmse_rounds == [r for r, _ in sh["rmse"]]}
    if not all(same.values()):
        raise RuntimeError(f"while != scan on the card: {same}")
    keep = E.bk_free(meta).cuda()
    state_err, bitwise = 0.0, True
    for k, want in sh["state"].items():
        got = run.state[k]
        bitwise = bitwise and torch.equal(got, want)
        if got.is_floating_point() and got.dim():
            state_err = max(state_err, float(
                (got[..., keep] - want[..., keep]).abs().max()))
        elif not torch.equal(got, want):
            raise RuntimeError(f"while vs scan counter {k} differs")
    if not state_err <= ROUND_TOL:
        raise RuntimeError(f"while vs scan states: {state_err} > {ROUND_TOL}")
    rounds = wh["rounds_run"]
    out = {
        "rounds_run": rounds, "stopped_early": rounds < run_kw["max_rounds"],
        "bitwise": same, "states_bitwise": bitwise,
        "state_max_abs_err": state_err,
        "loss_max_abs_err": float(np.max(np.abs(
            np.subtract(wh["train_loss"], sh["train_loss"])))),
        "while": {"warmup_s": run.warmup_s, "capture_s": run.capture_s,
                  "replay_s": run.replay_s, "profiled": counts is not None,
                  "wall_ms_per_round": run.replay_s * 1e3 / rounds,
                  "replays": {str(k): v for k, v in run.replays.items()},
                  "graphs": sorted(run.graphs)},
        "scan": {"run_s": scan_s, "wall_ms_per_round": scan_s * 1e3 / rounds},
    }
    if counts is not None:
        out["while"]["profile_run"] = wh["profile"]
        out["while"]["captured_per_replay"] = wh["captured_per_replay"]
        out["while"]["launches"] = wh["launches"]
    if run_kw["patience"] <= 1:
        masked, _, mh = while_stepwise(E, R, cfg, fl, tr, te, seed, **run_kw,
                                       mask_all=True)
        if (mh["rounds_run"], mh["comm"]) != (rounds, wh["comm"]):
            raise RuntimeError("masking every remaining chunk changed the run")
        out["while_mask_all"] = {
            "replay_s": mh["replay_s"],
            "wall_ms_per_round": mh["replay_s"] * 1e3 / rounds,
            "replays": len(masked.lengths)}
        del masked
    # one warm chunk each: a replay of the full-chunk graph (the run is
    # over, so the chunk is masked back: the same kernels, nothing kept)
    # and the scan driver's chunk body with its RMSE on the scan's state
    graph = run.graphs[n]
    out["while"]["profile_chunk"] = profile_chunk(graph.replay)
    out["while"]["event_ms_chunk"] = event_ms(graph.replay)
    pol = E.pol.from_config(fl)
    data = torch.from_numpy(tr).cuda()
    test = torch.from_numpy(te).cuda()

    def scan_chunk():
        st, _, ms = E._run_chunk(sh["state"], R.PRNGKey(seed, device="cuda"),
                                 data, cfg, fl, sh["meta"], pol, n)
        ms["train_loss"].cpu()
        float(E._rmse_device(cfg, st["w_global"], sh["meta"], test,
                             fl.client_chunk))

    out["scan"]["profile_chunk"] = profile_chunk(scan_chunk)
    per = out["while"]["profile_chunk"]["kernels"]
    if per["psgf_mix_batch"] != n or per["flash_short"] == 0:
        raise RuntimeError(f"a {n}-round replay ran kernels {per}")
    return out


def drive_training_drivers(mix_ops, flash_ops) -> dict:
    """Phase 7: ``run_fl(driver="while")`` and ``driver="host"`` on the
    card at full width, each against the driver that runs the same
    rounds."""
    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core.fl import engine as E
    from repro_torch.core.forecaster import load_forecaster
    from repro_torch.core.tasks import (ExperimentSpec, get_task,
                                        run_experiment, task_forecaster)

    out = {}
    # run A: the 3-cluster pipeline through run_experiment, while then scan
    task = get_task("ev", quick=False, clusters=3, num_days=420,
                    min_cluster_clients=4)
    model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
    grid = (("psgf", {"share_ratio": 0.3, "forward_ratio": 0.2,
                      "use_pallas_mix": True}),)
    series = task.series()
    labels = task.cluster_labels(series, device="cuda")
    rows, ckpt = {}, {}
    for driver in ("while", "scan"):
        spec = ExperimentSpec(task=task, model=model, grid=grid,
                              select_ratio=0.5, local_steps=4,
                              batch_size=TRAIN_BATCH, driver=driver, **WHILE_A)
        ckpt[driver] = os.path.join(ROOT, "build", f"chip_smoke_{driver}")
        shutil.rmtree(ckpt[driver], ignore_errors=True)
        torch.cuda.synchronize()
        if driver == "while":
            mix_ops.LAUNCHES = 0           # every kernel count, just before
            flash_ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_experiment(spec, checkpoint_dir=ckpt[driver], series=series,
                             labels=labels, device="cuda")
        torch.cuda.synchronize()
        if driver == "while":              # ... and just after
            captured = {"psgf_mix_batch": mix_ops.LAUNCHES,
                        "flash_attention": flash_ops.LAUNCHES,
                        "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}
        rows[driver] = (res["rows"], time.perf_counter() - t0)
    keys = ("cluster", "clients", "rounds", "comm_params", "comm_bytes")
    same = [[w[k] for k in keys] == [s[k] for k in keys]
            for w, s in zip(rows["while"][0], rows["scan"][0])]
    if not all(same) or len(same) != 3:
        raise RuntimeError(f"run_experiment while vs scan rows: {rows}")
    if captured["psgf_mix_batch"] == 0 or captured["flash_short"] == 0:
        raise RuntimeError(f"the while pipeline captured no kernel: {captured}")
    # per cluster: 1 warm-up round + one capture of each chunk length
    want_mix = 3 * (1 + WHILE_A["eval_every"]
                    + WHILE_A["max_rounds"] % WHILE_A["eval_every"])
    if captured["psgf_mix_batch"] != want_mix:
        raise RuntimeError(f"{captured['psgf_mix_batch']} psgf_mix calls "
                           f"captured, expected {want_mix}")
    ckpt_err = 0.0
    for r in rows["while"][0]:
        sub = f"psgf-s30-f20_c{r['cluster']}"
        got = load_forecaster(os.path.join(ckpt["while"], sub), device="cpu")[1]
        want = load_forecaster(os.path.join(ckpt["scan"], sub), device="cpu")[1]
        gv, meta = pt.tree_flatten_to_vector(got)
        wv, _ = pt.tree_flatten_to_vector(want)
        keep = E.bk_free(meta)
        ckpt_err = max(ckpt_err, float((gv - wv)[keep].abs().max()))
    if not ckpt_err <= ROUND_TOL:
        raise RuntimeError(f"while vs scan trained models: {ckpt_err}")
    out["run_A_pipeline"] = {
        "config": dict(WHILE_A), "rows_while": rows["while"][0],
        "rows_scan": rows["scan"][0], "while_s": rows["while"][1],
        "scan_s": rows["scan"][1], "captured_calls": captured,
        "checkpoint_w_global_max_abs_err": ckpt_err}

    # runs A and B on the 27-station cluster, stage by stage
    c = int(np.argmax(np.bincount(labels)))
    tr, _, te, _ = task.client_data(series, np.nonzero(labels == c)[0])
    fl = spec.fl_config("psgf", tr.shape[0], grid[0][1])
    def counts():
        return {"psgf_mix_batch": mix_ops.LAUNCHES,
                "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}

    for name, run_kw, count in (("run_A_c%d" % c, WHILE_A, None),
                                ("run_B_c%d" % c, WHILE_B, counts)):
        out[name] = while_vs_scan(E, R, model.cfg, fl, tr, te, spec.seed + c,
                                  run_kw, count)
        log(json.dumps({name: out[name]}))
    if not out["run_B_c%d" % c]["stopped_early"]:
        raise RuntimeError("run B: the stop did not fire on the device")
    per = out["run_B_c%d" % c]["while"]
    # the third way to stop, a conditional graph node, needs this API
    out["conditional_node_in_torch"] = hasattr(torch.cuda.CUDAGraph,
                                               "begin_capture_to_if_node")
    out["while_launches_run_B"] = {
        "how": "calls captured in run B's own graphs x their replays",
        **per["launches"],
        "in_the_trace": per["profile_run"]["kernels"]}

    # the host driver against the loop driver: a 2,048-station fleet
    out["host_vs_loop"] = drive_host_vs_loop(E, R, mix_ops, flash_ops)
    return out


def host_cell(E, data: bool = True):
    """Phase 7's nn5 cell: K = 2,048 stations, cohort 256, client chunk 64,
    full-width LoGTST with flash and the fused downlink. Returns ``(task,
    model, train, test, FLConfig, run_fl keywords)``; without ``data`` the
    series are not made (None)."""
    from repro_torch.core.tasks import get_task, task_forecaster

    task = get_task("nn5", quick=False, num_clients=HOST_K)
    model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
    tr = te = None
    if data:
        tr, _, te, _ = task.client_data(task.series(), streaming=True)
    fl = E.FLConfig(policy="psgf", num_clients=HOST_K, select_ratio=0.5,
                    share_ratio=0.3, forward_ratio=0.2, local_steps=4,
                    batch_size=TRAIN_BATCH, use_pallas_mix=True,
                    streaming_windows=True, participation=HOST_S,
                    client_chunk=HOST_CHUNK)
    kw = dict(max_rounds=HOST_ROUNDS, eval_every=HOST_EVAL, patience=100)
    return task, model, tr, te, fl, kw


def tensor_sha(t) -> str:
    import hashlib

    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def run_digest(h, blocks) -> dict:
    """What a multi-process run must reproduce bit for bit: the history,
    ``w_global``'s hash and the hash of ``w_clients``'s rows ``[lo, hi)``
    for each block of ``blocks`` (``h["state"]["w_clients"]`` indexed from
    0)."""
    wc = h["state"]["w_clients"]
    return {"losses": h["train_loss"], "comm": h["comm"],
            "rmse": [[int(r), float(v)] for r, v in h["rmse"]],
            "final_rmse": h["final_rmse"], "rounds": h["rounds_run"],
            "w_global_sha": tensor_sha(h["state"]["w_global"]),
            "w_clients_sha": [tensor_sha(wc[lo:hi]) for lo, hi in blocks]}


def drive_host_vs_loop(E, R, mix_ops, flash_ops) -> dict:
    """``run_fl(driver="host")`` against ``driver="loop"`` on the same
    inputs: nn5 at K = 2,048 stations, cohort 256, full-width LoGTST;
    states, comm and rounds bitwise; host memory, bytes per round and peak
    device memory of each; the host run's digest (:func:`run_digest`, the
    client rows in phase 10's blocks)."""
    task, model, tr, te, fl, kw = host_cell(E)
    res = {}
    for driver in ("host", "loop"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mix_ops.LAUNCHES = 0
        flash_ops.reset_launch_counts()
        t0 = time.perf_counter()
        h = E.run_fl(model.cfg, fl, tr, te, R.PRNGKey(SEED), driver=driver,
                     device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[driver] = (h, wall, torch.cuda.max_memory_allocated(),
                       {"psgf_mix_batch": mix_ops.LAUNCHES,
                        "flash_short": flash_ops.ROUTE_LAUNCHES["short"]})
    (hh, hs, hpeak, hl), (lh, ls, lpeak, ll) = res["host"], res["loop"]
    store = hh["client_store"]
    if not all(getattr(store, k).is_pinned()
               for k in ("w_clients", "adam_m", "adam_v", "adam_t", "train")):
        raise RuntimeError("the host store is not pinned")
    same = {k: hh[k] == lh[k] for k in ("rounds_run", "comm", "train_loss")}
    same.update({f"state/{k}": torch.equal(hh["state"][k].cuda(), v)
                 for k, v in lh["state"].items()})
    if not all(same.values()):
        raise RuntimeError(f"host driver != loop driver: {same}")
    if not hpeak < lpeak:
        raise RuntimeError(f"host peak device memory {hpeak} >= loop's {lpeak}")
    if hl["psgf_mix_batch"] != HOST_ROUNDS or hl["flash_short"] == 0:
        raise RuntimeError(f"host driver launches {hl}")
    from repro_torch.launch.distributed import block_range

    digest = run_digest(hh, [block_range(HOST_K, i, DIST_PROCESSES)
                             for i in range(DIST_PROCESSES)])
    D = hh["meta"].total
    T = tr.shape[1]
    row_bytes = 3 * D * 4 + 4
    with open("/proc/meminfo") as f:
        mem_total = f.readline().split()[1]
    rounds = hh["rounds_run"]
    return {
        "task": f"nn5 full, {HOST_K} stations, look_back {task.look_back}, "
                f"horizon {task.horizon}, {task.num_days} days",
        "params": D, "cohort": HOST_S, "client_chunk": HOST_CHUNK,
        "rounds": rounds, "host_ram_kb": int(mem_total),
        "store_state_bytes": store.state_nbytes,
        "store_series_bytes": store.series_nbytes,
        "h2d_bytes_per_round": HOST_S * (row_bytes + T * 4),
        "d2h_bytes_per_round": HOST_S * row_bytes,
        "bitwise": same,
        "host": {"run_s": hs, "rounds_per_s": rounds / hs,
                 "store_setup_s": hh["client_store_setup_s"],
                 "round_s": hh["round_s"],
                 "rounds_per_s_rounds_alone": rounds / sum(hh["round_s"]),
                 "peak_device_bytes": hpeak, "launches": hl},
        "loop": {"run_s": ls, "rounds_per_s": rounds / ls,
                 "peak_device_bytes": lpeak, "launches": ll},
        "final_rmse": {"host": hh["final_rmse"], "loop": lh["final_rmse"]},
        "host_digest": digest,
    }


# ---------------------------------------------------------------------------
# Phase 6: hymba-1.5b hybrid decoder serving (the model zoo's hybrid family)
# ---------------------------------------------------------------------------


# ssm_scan against its plain version: float32 within the reference's own
# kernel tolerance (tests/test_kernels.py:270); bf16 within one bf16
# rounding of the output (2^-8 relative, either side) of float32 values that
# agree to SSM_F32_TOL
SSM_F32_TOL = 1e-4
SSM_BF16_RTOL = 2.0 ** -7
HYMBA_SSM = (4, 2048, 3200, 16)         # prefill: B, S, d_inner, state
HYMBA_ATTN = (4, 2048, 25, 5, 64)       # prefill: B, S, H, KV, hd
HYMBA_WINDOW = 1024
QWEN_ATTN_F32 = (4, 2048, 12, 2, 128)  # qwen2-1.5b's float32 prefill: B, S, H, KV, hd
HYMBA_PARAMS = 1_662_161_600
# flash attention at hymba's shape against its plain version: float32 as the
# reference classes above (2e-5); bf16 output as the bf16 class above
FLASH_HYMBA_TOL = {torch.float32: 2e-5, torch.bfloat16: BF16_TOL}
# card against CPU in float32 (no TF32): cuBLAS and the CPU sum matmuls of
# depth up to 5504 in other orders, the flash kernel's online softmax and
# the dense one round differently, and the scan's dot with C sums in
# another order; 1e-4 abs/rel is ~100x the float32 ulps of O(1) values
HYBRID_CPU_TOL = 1e-4


def ssm_inputs(gen, B, S, D, N, dtype):
    x = torch.randn(B, S, D, generator=gen).to("cuda", dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, D, generator=gen)).to(
        "cuda", dtype)
    bm = torch.randn(B, S, N, generator=gen).to("cuda", dtype)
    cm = torch.randn(B, S, N, generator=gen).to("cuda", dtype)
    a = -torch.exp(0.1 * torch.randn(D, N, generator=gen)).to("cuda")
    return x, dt, bm, cm, a


def ssm_bound_ms(x, bm, a):
    """Least time: x, dt, B, C and A read once, y written once, at the HBM
    rate; the B*S*D*N exponentials on the special-function units; ~6 fp32
    flops per (t, d, n) on the CUDA cores. The larger of the three."""
    from repro_torch.common import hw

    B, S, D = x.shape
    N = a.shape[1]
    nbytes = 3 * x.nbytes + 2 * bm.nbytes + a.nbytes
    work = B * S * D * N
    times = {"bytes": nbytes / hw.HBM_BYTES_PER_S * 1e3,
             "operations": max(work / hw.SFU_OPS_PER_S,
                               6 * work / hw.FP32_FLOP_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by, nbytes, work


def check_ssm_scan(ssm_ops, ssm_ref) -> dict:
    """The ssm_scan kernel against its plain version on the card: hymba's
    prefill shape in float32 and bf16, every N of ``STATE_DIMS`` in both
    dtypes at ragged and vector-aligned S and D, the final state (bitwise
    in float32) and a repeated call; then times at the prefill's bf16
    shape."""
    gen = torch.Generator().manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("hymba_f32", HYMBA_SSM, f32), ("hymba_bf16", HYMBA_SSM, bf16),
             ("ragged", (1, 37, 300, 8), f32), ("n4", (2, 64, 128, 4), f32),
             ("n64", (1, 100, 96, 64), f32), ("n64_bf16", (2, 50, 200, 64), bf16)]
    # every state dim in both dtypes: D = 203 is a multiple of no block's
    # channel count and of no 16-byte vector (scalar staging), D = 256 takes
    # the vector staging; S = 130 and 200 end in a partial time tile
    for n in ssm_ops.STATE_DIMS:
        for dtype in (f32, bf16):
            tag = str(dtype).replace("torch.", "")
            cases += [(f"n{n}_ragged_{tag}", (2, 130, 203, n), dtype),
                      (f"n{n}_vector_{tag}", (1, 200, 256, n), dtype)]
    errs = {}
    for name, shape, dtype in cases:
        args = ssm_inputs(gen, *shape, dtype)
        before = ssm_ops.LAUNCHES
        y, h = ssm_ops.ssm_scan(*args, return_state=True)
        torch.cuda.synchronize()
        if ssm_ops.LAUNCHES != before + 1:
            raise RuntimeError(f"ssm_scan {name}: the wrapper did not launch")
        want_y, want_h = ssm_ref.ssm_scan_ref(*args, return_state=True)
        yerr = float((y.float() - want_y.float()).abs().max())
        herr = float((h - want_h).abs().max())
        rtol = SSM_F32_TOL if dtype == f32 else SSM_BF16_RTOL
        ok_y = torch.allclose(y.float(), want_y.float(), atol=SSM_F32_TOL, rtol=rtol)
        # the state update rounds as the plain version's does: h is bitwise
        # equal in float32 (and within the float32 tolerance from bf16 inputs)
        ok_h = (torch.equal(h, want_h) if dtype == f32 else
                torch.allclose(h, want_h, atol=SSM_F32_TOL, rtol=SSM_F32_TOL))
        # the reduction over the states is fixed: a second call, without the
        # state, gives the same y bit for bit
        repeat = torch.equal(ssm_ops.ssm_scan(*args), y)
        errs[name] = {"y_max_abs_err": yerr, "h_max_abs_err": herr}
        if not (ok_y and ok_h and repeat and y.dtype == dtype
                and torch.isfinite(y).all()):
            raise RuntimeError(f"ssm_scan {name}: kernel vs plain y {yerr}, h "
                               f"{herr}, repeat equal {repeat}")
        if name == "hymba_bf16":
            main = (args, yerr)
        del args, y, h, want_y, want_h
    log(json.dumps({"kernel_cases": {"ssm_scan": errs}}))

    args, err = main
    kernel_ms = timed_ms(lambda: ssm_ops.ssm_scan(*args))
    plain_ms = timed_ms(lambda: ssm_ref.ssm_scan_ref(*args), calls=1, reps=3)
    kernel_ms2 = timed_ms(lambda: ssm_ops.ssm_scan(*args))
    bound, by, nbytes, work = ssm_bound_ms(args[0], args[2], args[4])
    return {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:73",
        "tpu_kernel": "src/repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel",
        "shape": list(HYMBA_SSM), "dtype": "bfloat16",
        "max_abs_err": err,
        "ms": statistics.median([kernel_ms, kernel_ms2]),
        "ms_runs": [kernel_ms, kernel_ms2],
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a selective scan",
        "bytes": nbytes, "exponentials": work,
        "cases": errs,
    }


def check_flash_hymba(ops, ref) -> dict:
    """Flash attention at hymba's prefill shape (causal, window 1024, which
    bites at 2048) against its plain version in float32 and bf16, and at
    qwen2-1.5b's float32 prefill (causal, GQA 6:1, hd 128); times of the
    bf16 call (the tensor-core route) and of both float32 calls (the
    general route), each with ``scaled_dot_product_attention`` on the same
    inputs (same mask) as the library's yardstick."""
    B, S, H, KV, hd = HYMBA_ATTN
    gen = torch.Generator().manual_seed(SEED + 4)
    errs, routes, inputs = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(gen, B, S, S, H, KV, hd, dtype)
        key = str(dtype).replace("torch.", "")
        routes[key] = route_of(ops, q, k)
        got, errs[key], ratio = flash_case(
            ops, ref, f"flash at hymba's shape ({key})", q, k, v, True,
            HYMBA_WINDOW, None, FLASH_HYMBA_TOL[dtype])
        if ratio is not None:
            errs[key + "_bound_ratio"] = ratio
        inputs[key] = (q, k, v)
        del got
    qB, qS, qH, qKV, qhd = QWEN_ATTN_F32
    q2, k2, v2 = attention_inputs(gen, qB, qS, qS, qH, qKV, qhd, torch.float32)
    routes["qwen2_float32"] = route_of(ops, q2, k2)
    got, errs["qwen2_float32"], _ = flash_case(
        ops, ref, "flash at qwen2's float32 prefill", q2, k2, v2, True, None,
        None, FLASH_HYMBA_TOL[torch.float32])
    del got
    if routes != {"float32": "scalar", "bfloat16": "tensor_core",
                  "qwen2_float32": "scalar"}:
        raise RuntimeError(f"flash at hymba's / qwen2's shape took the routes {routes}")
    log(json.dumps({"kernel_cases": {"flash_attention_hymba": errs}}))
    record = flash_times(ops, ref, *inputs["bfloat16"], HYMBA_WINDOW)
    general = {
        "hymba-1.5b prefill": {
            "shape": [B, S, H, KV, hd], "causal": True, "window": HYMBA_WINDOW,
            "max_abs_err": errs["float32"],
            **flash_times(ops, ref, *inputs["float32"], HYMBA_WINDOW)},
        "qwen2-1.5b prefill": {
            "shape": list(QWEN_ATTN_F32), "causal": True, "window": None,
            "max_abs_err": errs["qwen2_float32"],
            **flash_times(ops, ref, q2, k2, v2, None)}}
    log(json.dumps({"flash_general_float32": general}))
    return {"kernel_route": "tensor_core",
            "source": "src/repro_torch/csrc/flash_attention_tc.cu",
            "shape": [B, S, H, KV, hd], "dtype": "bfloat16", "causal": True,
            "window": HYMBA_WINDOW, "max_abs_err": errs["bfloat16"],
            "bound_ratio": errs["bfloat16_bound_ratio"],
            "max_abs_err_float32": errs["float32"], "general_float32": general,
            **record}


def sdpa_calls(ref, q, k, v, window, causal):
    """``{name: (fn, backend)}`` of the ``scaled_dot_product_attention``
    calls that compute what the flash call computes, on K/V expanded to the
    query heads: with the mask as a tensor (which keeps SDPA off its fused
    backends) and, where no window cuts the keys and Sq == Skv, without one
    (``is_causal=causal``); ``backend`` is the one the dispatcher picks for
    the call (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                              kv_len=None, device=q.device)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))

    def backend(attn_mask, is_causal):
        return SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, attn_mask, 0.0, is_causal)).name.lower()

    calls = {"scaled_dot_product_attention(attn_mask=the same mask)":
             (lambda: sdpa(qt, kt, vt, attn_mask=mask), backend(mask, False))}
    if window is None and Sq == Skv:
        calls[f"scaled_dot_product_attention(is_causal={causal})"] = (
            lambda: sdpa(qt, kt, vt, is_causal=causal), backend(None, causal))
    return calls


def flash_times(ops, ref, q, k, v, window, causal=True, bound=True) -> dict:
    """The wrapper's call on ``q, k, v`` (on the route ``kernel_route``
    names) timed beside its plain version and the
    ``scaled_dot_product_attention`` calls of ``sdpa_calls``, with the bound
    (``kernels/flash_attention/bound.py``) unless ``bound`` is False (a tree
    that has no such module). ``library_ms`` is the faster SDPA call, named
    in ``library_call`` with its backend in ``library_backend``; each
    call's time and backend are in ``library_ms_by_call`` and
    ``library_backend_by_call``."""
    kernel_ms = timed_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                     window=window), calls=5)
    plain_ms = timed_ms(lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), calls=2, reps=3)
    calls = sdpa_calls(ref, q, k, v, window, causal)
    by_call = {name: timed_ms(fn, calls=5) for name, (fn, _) in calls.items()}
    library_call = min(by_call, key=by_call.get)
    out = {"ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": by_call[library_call], "library_call": library_call,
           "library_backend": calls[library_call][1],
           "library_ms_by_call": by_call,
           "library_backend_by_call": {name: backend for name, (_, backend)
                                       in calls.items()}}
    if bound:
        from repro_torch.kernels.flash_attention.bound import attention_bound

        b = attention_bound(tuple(q.shape), tuple(k.shape), q.dtype,
                            causal=causal, window=window)
        out.update(bound_ms=b["ms"], bound_by=b["bound_by"],
                   bound_operations_by=b["operations_by"], bytes=b["bytes"],
                   flops=b["flops"], pairs=b["pairs"])
    return out


def numpy_params(spec_tree, seed):
    """numpy params of a spec tree's shapes (scaled normals; ones and zeros
    leaves perturbed so every weight matters)."""
    from repro_torch.common import pytree_utils as pt
    from repro_torch.models import spec as S

    rng = np.random.default_rng(seed)

    def make(s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "ones":
            return 1.0 + 0.1 * noise
        if s.init == "zeros":
            return 0.1 * noise
        return (S._scale(s) * noise).astype(np.float32)

    return pt.tree_map(make, spec_tree, is_leaf=S.is_spec)


def hybrid_reduced_card_vs_cpu() -> dict:
    """Reduced hymba in float32 on the same numpy-made params: prefill of 48
    tokens (the window of 32 wraps) and 8 greedy decode steps on the card
    and on the CPU; tokens equal, logits within HYBRID_CPU_TOL."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="float32")
    host = numpy_params(decoder.model_spec(cfg), SEED)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 48))
    runs = {}
    for dev in ("cuda", "cpu"):
        api = ModelApi(cfg, dev)
        params = decoder.params_from_numpy(host, dev)
        with torch.inference_mode():
            logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks).to(dev)},
                                        cache_len=56)
            out, steps = [], [logits[:, -1].float().cpu()]
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for i in range(8):
                out.append(tok.cpu())
                logits, cache = api.decode_step(params, cache, tok, 48 + i)
                steps.append(logits[:, -1].float().cpu())
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        runs[dev] = (torch.cat(out, dim=1), torch.stack(steps))
    (tg, lg), (tc, lc) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    if not (torch.equal(tg, tc) and torch.allclose(lg, lc, atol=HYBRID_CPU_TOL,
                                                   rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"reduced hymba card vs CPU: tokens equal "
                           f"{torch.equal(tg, tc)}, logits max |err| {err}")
    return {"tokens_equal": True, "logits_max_abs_err": err,
            "tokens": tg[0].tolist()}


def hybrid_block0_card_vs_cpu(params) -> dict:
    """Block 0 of full-width hymba alone, B = 1, S = 256, float32: the card
    (flash and ssm_scan kernels) against the CPU (dense attention, the
    scan's plain version), from the same weights."""
    import dataclasses

    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config("hymba-1.5b"), dtype="float32")
    p0 = pt.tree_map(lambda a: a[0], params["blocks"])
    emb = params["embed"]["embedding"]
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, 256))).cuda()
    x = emb[toks]
    pos = torch.arange(256, dtype=torch.int32, device="cuda")
    outs = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            p = pt.tree_map(lambda a: a.to(dev), p0)
            y, _ = decoder._block_apply(cfg, p, x.to(dev), pos.to(dev), 0.0, "auto")
            outs[dev] = y.cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    if not (torch.isfinite(outs["cuda"]).all()
            and torch.allclose(outs["cuda"], outs["cpu"], atol=HYBRID_CPU_TOL,
                               rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"hymba block 0 card vs CPU: max |err| {err}")
    return {"shape": [1, 256, cfg.d_model], "max_abs_err": err,
            "max_abs_out": float(outs["cpu"].abs().max())}


def drive_hybrid_serving(ssm_ops, flash_ops) -> dict:
    """Phase 6's main path: ``serve("hymba-1.5b")`` at full width on the
    card, then a profiled prefill and the card-against-CPU checks."""
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi
    from repro_torch.launch.serve import serve

    B, S, _, _, _ = HYMBA_ATTN
    gen = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssm_ops.LAUNCHES = 0                   # every kernel count, just before
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = serve("hymba-1.5b", batch=B, prompt_len=S, gen=gen, reduced=False,
                device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"ssm_scan": ssm_ops.LAUNCHES,          # ... and just after
                "flash_attention": flash_ops.LAUNCHES}
    flash_routes = dict(flash_ops.ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config("hymba-1.5b")
    toks = rep["tokens"]
    if rep["params"] != HYMBA_PARAMS:
        raise RuntimeError(f"hymba-1.5b has {rep['params']} params")
    if (launches != {"ssm_scan": cfg.num_layers, "flash_attention": cfg.num_layers}
            or flash_routes != {"scalar": 0, "tensor_core": cfg.num_layers,
                                "short": 0}):
        raise RuntimeError(f"kernel launches {launches} (flash routes "
                           f"{flash_routes}) for one prefill of "
                           f"{cfg.num_layers} layers")
    if toks.shape != (B, gen) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise RuntimeError(f"generated tokens {toks.shape} out of range")

    # one prefill under the profiler, from the same key's weights
    api = ModelApi(cfg, "cuda")
    params = api.init_params(R.PRNGKey(0))
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    def prefill():
        return api.prefill(params, {"tokens": prompt}, cache_len=S + gen)

    with torch.inference_mode():
        logits, cache = prefill()
        if logits.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
        warm_prefill_ms = host_ms(prefill)
        prof = profile_device(prefill, 1, "prefill")
        # decode from that prefill's cache: warm, timed, then profiled steps
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        api.decode_step(params, cache, tok, S)
        steps = 8
        warm_decode_ms = host_ms(lambda: [api.decode_step(params, cache, tok, S + 1 + i)
                                          for i in range(steps)]) / steps
        dprof = profile_device(lambda: api.decode_step(params, cache, tok, S + 9),
                               4, "decode_step")
    block0 = hybrid_block0_card_vs_cpu(params)
    del params, logits, cache
    reduced = hybrid_reduced_card_vs_cpu()
    return {
        "model": cfg.name, "params": rep["params"], "batch": B,
        "prompt_len": S, "gen": gen, "activations": cfg.dtype,
        "weights": "float32 from PRNGKey(0)",
        "init_s": rep["init_s"], "prefill_ms": rep["prefill_ms"],
        "decode_ms_per_token": rep["decode_ms_per_token"],
        "serve_wall_s": wall_s, "peak_memory_bytes": peak,
        "launches_prefill": launches,
        "flash_route_launches_prefill": flash_routes,
        "first_tokens": toks[:, :8].tolist(),
        "prefill_ms_warm": warm_prefill_ms,
        "decode_ms_per_token_warm": warm_decode_ms,
        "profile_prefill": prof,
        "profile_decode_step": dprof,
        "block0_card_vs_cpu": block0,
        "reduced_card_vs_cpu": reduced,
    }


# ---------------------------------------------------------------------------
# Phase 8: the flywheel behind the gateway
# ---------------------------------------------------------------------------

FLY_CLIENTS = 16            # closed-loop HTTP clients, one keep-alive each
FLY_CHANNELS = 3
FLY_TOKEN = "chip-smoke-token"
FLY_QUIET_S = 3.0           # traffic alone before the drift and after
FLY_SAMPLES = 32            # requests per generation held to the CPU forward
FLY_POLL_S = 0.01           # /healthz and manifest poll
FLY_REASONS = ("draining", "unroutable", "rate_limit", "queue_full",
               "deadline")


class _Traffic:
    """``FLY_CLIENTS`` closed-loop clients, each on one keep-alive
    connection, sending station-routed raw requests (a uniform station,
    three look-back windows of its raw series) until stopped; every
    request's send and receive time, status and forecast is kept."""

    def __init__(self, address, series, stations, look_back):
        import threading

        self.address, self.series = address, series
        self.stations, self.L = stations, look_back
        self.stop = threading.Event()
        self.records = [[] for _ in range(FLY_CLIENTS)]
        self.failures = []
        self.threads = [threading.Thread(target=self._client, args=(i,),
                                         daemon=True)
                        for i in range(FLY_CLIENTS)]

    def x_of(self, s, t):
        return np.stack([self.series[s, t + k: t + k + self.L]
                         for k in (0, 7, 14)]).astype(np.float32)

    def _client(self, i):
        import http.client

        from repro_torch.launch.gateway import request_json

        rng = np.random.default_rng(SEED + 100 + i)
        conn = http.client.HTTPConnection(*self.address, timeout=60)
        top = self.series.shape[1] - self.L - 14
        try:
            while not self.stop.is_set():
                s = self.stations[int(rng.integers(len(self.stations)))]
                t = int(rng.integers(top))
                body = {"x": self.x_of(s, t).tolist(), "station": s}
                t0 = time.perf_counter()
                status, _, out = request_json(*self.address, "POST",
                                              "/v1/forecast", body,
                                              token=FLY_TOKEN, conn=conn)
                t1 = time.perf_counter()
                self.records[i].append(
                    (t0, t1, status, s, t,
                     out.get("y") if isinstance(out, dict) else None))
        except Exception as exc:           # counted, and fails the phase
            self.failures.append(repr(exc))
        finally:
            conn.close()

    def start(self):
        for t in self.threads:
            t.start()

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in self.threads):
            raise RuntimeError("a traffic client did not stop")

    def all(self):
        return [r for rec in self.records for r in rec]


class _Watch:
    """Polls ``/healthz`` and the manifest every ``FLY_POLL_S``: the first
    time (perf_counter) each generation shows in /healthz."""

    def __init__(self, address):
        import threading

        self.address = address
        self.shown, self.errors = {}, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        import http.client

        from repro_torch.launch.gateway import request_json

        conn = http.client.HTTPConnection(*self.address, timeout=60)
        try:
            while not self.stop.is_set():
                status, _, health = request_json(*self.address, "GET",
                                                 "/healthz", conn=conn)
                now = time.perf_counter()
                if status != 200:
                    self.errors.append(status)
                self.shown.setdefault(health["generation"], now)
                time.sleep(FLY_POLL_S)
        except Exception as exc:
            self.errors.append(repr(exc))
        finally:
            conn.close()

    def wait_for(self, generation, timeout=120.0):
        deadline = time.perf_counter() + timeout
        while generation not in self.shown:
            if time.perf_counter() > deadline or self.errors:
                raise RuntimeError(f"/healthz never showed generation "
                                   f"{generation}: {self.errors}")
            time.sleep(FLY_POLL_S)
        return self.shown[generation]


def window_stats(records, t0, t1, h0, h1, groups) -> dict:
    """Forecasts/s and client-side p50/p99 latency of the requests that
    completed in ``[t0, t1)``; the server's own submit -> result p50/p99
    (its queue and forward, no HTTP) between its histogram's snapshots
    ``h0`` and ``h1`` taken at ``t0`` and ``t1``; and, from the worker's
    ``(start, end)`` of each group it served, the longest group and the
    longest time the worker served none."""
    lat = sorted(r[1] - r[0] for r in records if t0 <= r[1] < t1)
    if not lat or t1 <= t0:
        raise RuntimeError(f"no request completed in a {t1 - t0:.3f} s window")
    out = {"seconds": t1 - t0, "requests": len(lat),
           "forecasts_per_sec": len(lat) * FLY_CHANNELS / (t1 - t0),
           "latency_s_p50": float(np.quantile(lat, 0.5)),
           "latency_s_p99": float(np.quantile(lat, 0.99))}
    q = latency_quantiles(None, since=h0, until=h1)
    out["server_latency_s_p50"], out["server_latency_s_p99"] = q[0.5], q[0.99]
    spans = sorted(g for g in groups if t0 <= g[0] < t1)
    out["worker_groups"] = len(spans)
    out["worker_longest_group_s"] = max((b - a for a, b in spans), default=0.0)
    out["worker_longest_idle_s"] = max(
        (n[0] - p[1] for p, n in zip(spans, spans[1:])), default=0.0)
    return out


def drive_flywheel(mix_ops, flash_ops) -> dict:
    """Phase 8: phase 5's generation-0 root served behind the gateway to
    ``FLY_CLIENTS`` closed-loop HTTP clients, and retrained twice while they
    run: the drift path (``step`` -> scan) and ``retrain`` with the while
    driver, whose CUDA graphs are captured while the gateway serves."""
    import dataclasses

    from repro_torch.common import pytree_utils as pt
    from repro_torch.core import forecast as F
    from repro_torch.core.fl import engine as E
    from repro_torch.core.fl.flywheel import DriftDetector, RetrainController
    from repro_torch.core.forecaster import load_forecaster
    from repro_torch.core.tasks import (ExperimentSpec, get_task,
                                        read_routing_manifest,
                                        task_forecaster)
    from repro_torch.launch.gateway import ForecastGateway, request_json
    from repro_torch.launch.metrics import parse_exposition, sum_samples
    from repro_torch.launch.serve_forecast import (ForecastServer,
                                                   stream_evaluate)

    root = os.path.join(ROOT, "build", "chip_smoke_flywheel")
    quiet = os.path.join(ROOT, "build", "chip_smoke_flywheel_quiet")
    for d in (root, quiet):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "build", "chip_smoke_train"), root)
    task = get_task("ev", quick=False, clusters=3, num_days=420,
                    min_cluster_clients=4)
    model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
    grid = (("psgf", {"share_ratio": 0.3, "forward_ratio": 0.2,
                      "use_pallas_mix": True}),)
    spec = ExperimentSpec(task=task, model=model, grid=grid, select_ratio=0.5,
                          local_steps=4, batch_size=TRAIN_BATCH,
                          max_rounds=TRAIN_ROUNDS, patience=10,
                          eval_every=TRAIN_EVAL_EVERY, driver="scan")
    wspec = dataclasses.replace(spec, driver="while")
    series = task.series()
    labels = np.asarray(read_routing_manifest(root)[1]["station_cluster"])
    if np.bincount(labels).tolist() != [21, 27, 10]:
        raise RuntimeError(f"generation 0 clusters {np.bincount(labels)}")

    server = ForecastServer.from_manifest(root, denormalize=True,
                                          device="cuda", max_batch=32)
    server.warmup(channels=FLY_CHANNELS)
    server.watch_manifest(interval_s=0.1)
    engines0 = dict(server.engines)
    groups, run_group = [], server._run_group

    def timed_group(items):        # the worker's timeline, for the windows
        t0 = time.perf_counter()
        run_group(items)
        groups.append((t0, time.perf_counter()))

    server._run_group = timed_group
    gw = ForecastGateway(server, auth_token=FLY_TOKEN, max_pending=1024,
                         deadline_s=30.0)
    address = gw.start()
    traffic = _Traffic(address, series, server.routable_stations(),
                       task.look_back)
    watch = _Watch(address)

    def counts():
        return {"psgf_mix_batch": mix_ops.LAUNCHES,
                "flash_attention": flash_ops.LAUNCHES}

    def captured_calls():       # this thread's calls recorded into graphs
        return {"psgf_mix_batch": mix_ops.captured_calls(),
                "flash_attention": flash_ops.captured_calls()}

    marks, hists = {}, {}
    try:
        with counting_captures(E, captured_calls) as captured_loaded:
            torch.cuda.synchronize()
            mix_ops.LAUNCHES = 0               # every kernel count, just before
            flash_ops.reset_launch_counts()
            watch.thread.start()
            watch.wait_for(0)
            marks["start"] = time.perf_counter()
            hists["start"] = latency_histogram(server)
            traffic.start()
            time.sleep(FLY_QUIET_S)
            marks["steady_end"] = time.perf_counter()
            hists["steady_end"] = latency_histogram(server)

            # the drift path: three stable reports, then 40 drifted days
            # (every test window: the drifted days are the latest ones)
            ctl = RetrainController(spec, root, series=series.copy(),
                                    labels=labels, server=server,
                                    detector=DriftDetector(), device="cuda")
            for _ in range(3):
                rep = stream_evaluate(server, task, series=ctl.series)
                if ctl.step(rep)["retrained"]:
                    raise RuntimeError("a stable report retrained a cluster")
            tail = ctl.series[:, -40:].copy()
            tail[labels == 1] = tail[labels == 1] * 3.0 + 5.0
            ctl.append_windows(tail)
            drifted = stream_evaluate(server, task, series=ctl.series)
            marks["scan_call"] = time.perf_counter()
            hists["scan_call"] = latency_histogram(server)
            step = ctl.step(drifted)
            marks["scan_return"] = time.perf_counter()
            if (step["drifted"] != [1] or sorted(step["retrained"]) != [1]
                    or step["generation"] != 1):
                raise RuntimeError(f"drift step: {step}")
            marks["gen1_shown"] = watch.wait_for(1)
            hists["gen1_shown"] = latency_histogram(server)
            recovered = stream_evaluate(server, task, series=ctl.series)
            rmse = {"stable": rep["per_cluster"][1]["rmse"],
                    "drifted": drifted["per_cluster"][1]["rmse"],
                    "after_swap": recovered["per_cluster"][1]["rmse"]}
            if not rmse["after_swap"] < rmse["drifted"]:
                raise RuntimeError(f"cluster 1's online RMSE did not fall: "
                                   f"{rmse}")

            # the capture path: a while retrain from generation 1, under load
            shutil.copytree(root, quiet)
            wctl = RetrainController(wspec, root, series=ctl.series,
                                     labels=labels, server=server,
                                     device="cuda")
            marks["while_call"] = time.perf_counter()
            hists["while_call"] = latency_histogram(server)
            wres = wctl.retrain([1])
            marks["while_return"] = time.perf_counter()
            if wres["generation"] != 2:
                raise RuntimeError(f"while retrain published "
                                   f"{wres['generation']}")
            marks["gen2_shown"] = watch.wait_for(2)
            hists["gen2_shown"] = latency_histogram(server)
            time.sleep(FLY_QUIET_S)
            marks["stop"] = time.perf_counter()
            hists["stop"] = latency_histogram(server)
            traffic.join()
            torch.cuda.synchronize()
            launched = counts()                # ... and just after
            routes = dict(flash_ops.ROUTE_LAUNCHES)
            metricz = request_json(*address, "GET", "/metricz")[2]
    finally:
        traffic.stop.set()
        watch.stop.set()
        if watch.thread.is_alive():
            watch.thread.join(timeout=60)  # before the drain answers 503
        gw.stop(close_server=True)
    engines2 = dict(server.engines)
    clock_offset = time.time() - time.perf_counter()

    # the same while retrain from the same generation-1 root, alone
    with counting_captures(E, captured_calls) as captured_quiet:
        qres = RetrainController(wspec, quiet, series=ctl.series,
                                 labels=labels, device="cuda").retrain([1])
    sub = "psgf-s30-f20_c1_g2"
    got = load_forecaster(os.path.join(root, sub), device="cpu")[1]
    want = load_forecaster(os.path.join(quiet, sub), device="cpu")[1]
    if not all(torch.equal(g, w) for (_, g), (_, w) in zip(
            pt.flatten_with_paths(got), pt.flatten_with_paths(want))):
        raise RuntimeError("the while retrain under load differs from the "
                           "same retrain alone")

    # every response 200, nothing shed, no client failed
    records = traffic.all()
    codes = {}
    for r in records:
        codes[r[2]] = codes.get(r[2], 0) + 1
    samples = parse_exposition(metricz)
    shed = {k: sum_samples(samples, "gateway_shed_total", reason=k)
            for k in FLY_REASONS}
    if traffic.failures or set(codes) != {200} or any(shed.values()):
        raise RuntimeError(f"traffic: codes {codes}, shed {shed}, failures "
                           f"{traffic.failures[:3]}")
    if sorted(watch.shown) != [0, 1, 2] or watch.errors:
        raise RuntimeError(f"/healthz showed {sorted(watch.shown)}, "
                           f"errors {watch.errors}")
    if not all(engines2[c] is engines0[c] for c in (0, 2)):
        raise RuntimeError("an unchanged cluster's engine was rebuilt")

    # norm stats: only cluster 1's stations moved, and only at generation 1
    norms = [np.asarray(read_routing_manifest(root, g)[1]["norm"][k])
             for g in (0, 1, 2) for k in ("mu", "sd")]
    moved = (norms[2] != norms[0]) | (norms[3] != norms[1])
    if not (moved[labels == 1].all() and not moved[labels != 1].any()
            and np.array_equal(norms[4], norms[2])
            and np.array_equal(norms[5], norms[3])):
        raise RuntimeError("norm stats moved outside cluster 1")

    # requests sent once /healthz showed g, before generation g+1 could be
    # published, against the CPU forward of generation g's checkpoint
    windows = {0: (marks["start"], marks["scan_call"]),
               1: (marks["gen1_shown"], marks["while_call"]),
               2: (marks["gen2_shown"], marks["stop"])}
    rng = np.random.default_rng(SEED)
    serve_err = 0.0
    for g, (t0, t1) in windows.items():
        pool = [r for r in records if t0 <= r[0] < t1]
        if len(pool) < FLY_SAMPLES:
            raise RuntimeError(f"generation {g}: {len(pool)} requests")
        _, man = read_routing_manifest(root, g)
        cpu = {}
        for i in rng.choice(len(pool), FLY_SAMPLES, replace=False):
            _, _, _, s, t, y = pool[i]
            c = man["station_cluster"][s]
            sub = man["policies"]["psgf-s30-f20"][str(c)]
            if sub not in cpu:
                cpu[sub] = load_forecaster(os.path.join(root, sub),
                                           device="cpu")
            fc, params, _ = cpu[sub]
            # the server's float32 stats, as it rescales raw requests
            mu = float(np.float32(man["norm"]["mu"][s]))
            sd = float(np.float32(man["norm"]["sd"][s]))
            x = (traffic.x_of(s, t) - mu) / sd
            with torch.inference_mode():
                want = F.forward_multivariate(fc.cfg, params,
                                              torch.from_numpy(x)[None])
            want = want[0].numpy() * sd + mu
            got = np.asarray(y, np.float32)
            serve_err = max(serve_err, float(np.max(np.abs(got - want))))
            if not np.allclose(got, want, atol=SERVE_TOL, rtol=SERVE_TOL):
                raise RuntimeError(f"generation {g} station {s}: served vs "
                                   f"CPU max |err| {serve_err}")

    # launches: a captured call is counted once, at its capture, and runs at
    # every replay of its graph. Each graph's calls are the loaded run's own:
    # the wrappers count the calls on a capturing stream per thread, so the
    # serving thread's launches during the capture are not among them. The
    # same retrain alone must have captured the same calls
    if routes["short"] != launched["flash_attention"]:
        raise RuntimeError(f"flash launches left the short route: {routes}")
    scan_rounds = step["retrained"][1]["rounds"]
    wrow, qrow = wres["rows"][1], qres["rows"][1]
    lengths = sorted(wrow["while_run"]["captured"], reverse=True)
    per_loaded = dict(zip(lengths, (d for _, d in captured_loaded)))
    per_quiet = dict(zip(lengths, (d for _, d in captured_quiet)))
    replays = {int(n): k for n, k in wrow["while_run"]["replays"].items()}
    if (len(captured_loaded) != len(lengths) or per_loaded != per_quiet
            or any(per_loaded[n]["psgf_mix_batch"] != n for n in lengths)):
        raise RuntimeError(f"one psgf_mix call a round expected, the same "
                           f"calls alone: {per_loaded} vs {per_quiet}")
    replayed = {k: sum(per_loaded[n][k] * replays[n] for n in lengths)
                for k in ("psgf_mix_batch", "flash_attention")}
    captured_once = {k: sum(per_loaded[n][k] for n in lengths)
                     for k in replayed}
    launches = {k: launched[k] - captured_once[k] + replayed[k]
                for k in replayed}
    while_mix = replayed["psgf_mix_batch"] + 1       # + the warm-up round
    if (replayed["psgf_mix_batch"] != wrow["rounds"]
            or launches["psgf_mix_batch"] != scan_rounds + while_mix):
        raise RuntimeError(f"psgf_mix launches {launches} for rounds "
                           f"{scan_rounds} (scan) and {wrow['rounds']} (while)")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel did not run on this path: {launches}")

    # what counting captured calls adds to each launch of a wrapper: one
    # capture-status query of the current stream
    with torch.cuda.stream(torch.cuda.Stream()):
        t0 = time.perf_counter()
        for _ in range(10_000):
            torch.cuda.is_current_stream_capturing()
        capture_query_us = (time.perf_counter() - t0) * 100

    def swap_s(g):
        """Manifest snapshot written -> /healthz first showed it."""
        stamp = os.stat(os.path.join(root, f"routing.g{g:06d}.json")).st_mtime
        return watch.shown[g] - (stamp - clock_offset)

    return {
        "task": "ev full (58 stations, 420 + 40 days)",
        "model": model.name, "params": model.num_params(),
        "clients": FLY_CLIENTS, "channels": FLY_CHANNELS,
        "requests": len(records), "status_codes": codes,
        "shed_by_reason": shed, "client_failures": len(traffic.failures),
        "generations_shown": sorted(watch.shown),
        "windows": {name: window_stats(records, marks[a], marks[b],
                                       hists[a], hists[b], groups)
                    for name, (a, b) in (
                        ("steady", ("start", "steady_end")),
                        ("retrain_scan", ("scan_call", "gen1_shown")),
                        ("retrain_while", ("while_call", "gen2_shown")),
                        ("after", ("gen2_shown", "stop")))},
        "retrain_s": {"scan": marks["scan_return"] - marks["scan_call"],
                      "while": marks["while_return"] - marks["while_call"]},
        "rows": {"scan": step["retrained"][1], "while": wrow,
                 "while_alone": qrow},
        "swap_s": {"1": swap_s(1), "2": swap_s(2)},
        "rmse_cluster1": rmse,
        "capture_query_us_per_launch": capture_query_us,
        "checked_vs_cpu_per_generation": FLY_SAMPLES,
        "served_max_abs_err_vs_cpu": serve_err,
        "while_bitwise_vs_alone": True,
        "captured_per_graph": {
            "loaded": {str(n): v for n, v in per_loaded.items()},
            "alone": {str(n): v for n, v in per_quiet.items()}},
        "launches": {**launches, "counted": launched, "flash_routes": routes,
                     "psgf_mix_batch_scan": scan_rounds,
                     "psgf_mix_batch_while": while_mix},
    }


# ---------------------------------------------------------------------------
# Phase 9: zoo training (qwen2-1.5b with PSGF-DP, hymba's ssm_scan gradient)
# ---------------------------------------------------------------------------

QWEN = "qwen2-1.5b"
QWEN_PSGF = dict(pods=2, sync_interval=4, batch=8, seq=64, steps=12)
QWEN_TRAIN = dict(batch=4, seq=2048, steps=4)
# flash at qwen2's training shapes: (B, S, H, KV, hd), causal, bf16
QWEN_ATTN = {"psgf_step": (8, 64, 12, 2, 128), "train_step": (4, 2048, 12, 2, 128)}
HYMBA_TRAIN_SSM = (8, 64, 3200, 16)      # B, S, d_inner, state at batch 8 x 64
# card against CPU in float32 (no TF32) after training steps: the losses of
# the first step are within HYBRID_CPU_TOL's matmul-order ulps; Adam then
# moves each weight by ~lr whatever its gradient's size, so a float-noise
# gradient's sign can differ (a 2 lr step, 6e-4 at the 3e-4 peak), and the
# next losses move by far less than that; 1e-4 abs/rel still fails a wrong
# gradient, which moves a reduced model's loss by 1e-2 or more
TRAIN_CPU_TOL = 1e-4
# ssm_scan's backward against autograd through its plain version on the
# card: the same float32 products summed in other orders
SSM_GRAD_TOL = 1e-5


@contextlib.contextmanager
def float32_configs(train_mod):
    """The trainer's configs in float32 for the card-against-CPU checks."""
    import dataclasses

    real = train_mod.get_config
    train_mod.get_config = lambda arch: dataclasses.replace(real(arch),
                                                            dtype="float32")
    try:
        yield
    finally:
        train_mod.get_config = real


def gate_bytes_from_keys(cfg, keys, pods, share, fwd, select) -> list:
    """Each sync's wire bytes worked out from its key: the selection and
    leaf gates drawn again from it (``masks``), then every leaf's float32
    bytes times its share gate for each selected pod, up and down, and its
    forward gate for each unselected pod."""
    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core.fl import masks as M
    from repro_torch.models import decoder
    from repro_torch.models import spec as S

    spec = decoder.model_spec(cfg)
    sizes = [math.prod(s.shape) * 4 for s in pt.leaves(spec, is_leaf=S.is_spec)]
    out = []
    for key in keys:
        k_sel, k_share, k_fwd = R.split(torch.tensor(key), 3)
        c = int(M.select_clients(k_sel, pods, select).sum())
        gs = pt.leaves(M.leaf_gates(k_share, spec, share), is_leaf=S.is_spec)
        gf = pt.leaves(M.leaf_gates(k_fwd, spec, fwd), is_leaf=S.is_spec)
        out.append(float(sum(n * (2 * c * float(a) + (pods - c) * float(b))
                             for n, a, b in zip(sizes, gs, gf))))
    return out


def check_losses(name, losses):
    if not (losses and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise RuntimeError(f"{name}: losses {losses} not finite and falling")


def free_device_memory():
    """Collect reference cycles before a full-width run: torch imports
    ``torch._dynamo`` at the first ``torch.utils.checkpoint`` call of a
    process, and that import keeps the calling frames, and so the first
    trainer's 40+ GB of state, in a cycle until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def train_run(name, fn, flash_ops, ssm_ops, **kw) -> dict:
    """One trainer call on the card with every kernel count set to 0 just
    before and read just after; its wall, peak memory, what was allocated
    before it (earlier phases' leftovers) and history."""
    free_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hist = {}
    ssm_ops.LAUNCHES = 0
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = fn(device="cuda", history=hist, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rec = {"losses": losses, "wall_s": wall_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "base_memory_bytes": base,
           "flash_launches": flash_ops.LAUNCHES,
           "flash_route_launches": dict(flash_ops.ROUTE_LAUNCHES),
           "ssm_scan_launches": ssm_ops.LAUNCHES, "history": hist}
    check_losses(name, losses)
    return rec


def per_step(rec, steps, pods=1) -> dict:
    """Warm host ms per step (the median past the first), tokens/s, and
    flash launches per pod per step by route."""
    warm = statistics.median(rec["history"]["step_s"][1:]) * 1e3
    return {"warm_ms_per_step": warm,
            "flash_launches_per_pod_step": {
                r: n / (steps * pods) for r, n in rec["flash_route_launches"].items()}}


def profile_psgf_step(api, optimizer, cfg, P, TR) -> dict:
    """One warm local step of 2 pods and one sync under the profiler, split
    into forward, backward, optimizer and sync. The backward's kernels are
    launched from autograd's own thread, outside the ``train.backward``
    range: ``profile_spans`` files them under ``other``, renamed
    ``backward`` here (nothing else is launched in this window)."""
    from repro_torch import random as R

    pods, batch, seq = QWEN_PSGF["pods"], QWEN_PSGF["batch"], QWEN_PSGF["seq"]
    free_device_memory()
    glob = api.init_params(R.PRNGKey(0, device="cuda"))
    local = P.stack_for_pods(glob, pods)
    opt = P.init_pod_opt_state(optimizer, local)
    step = P.make_local_train_step(api.loss_fn, optimizer)
    per_pod = [TR.make_batch(cfg, p, batch, seq, "cuda") for p in range(pods)]
    stacked = {k: torch.stack([b[k] for b in per_pod]) for k in per_pod[0]}
    dp = P.PSGFDPConfig(sync_interval=QWEN_PSGF["sync_interval"])
    key = R.PRNGKey(1, device="cuda")
    step(local, opt, stacked)                                   # warm
    P.psgf_sync(local, glob, key, dp, pods)

    def one():
        step(local, opt, stacked)
        P.psgf_sync(local, glob, key, dp, pods)

    prof = profile_spans(one, ("train.", "psgf."))
    prof["stages"]["backward"] = prof["stages"].pop("other")
    del glob, local, opt
    return prof


def ssm_scan_training_grads(ssm_ops, ssm_ref) -> dict:
    """ssm_scan under autograd at hymba's full-width training shape (batch 8
    x 64 tokens, d_inner 3200, state 16), float32 and bf16: the kernel's
    forward with the plain backward against autograd through the plain
    version, and the times of each part."""
    gen = torch.Generator().manual_seed(SEED + 9)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = ssm_inputs(gen, *HYMBA_TRAIN_SSM, dtype)
        dy = torch.randn(args[0].shape, generator=gen).to("cuda", dtype)
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(ssm_ops.ssm_scan(*a), a, dy)
        want = torch.autograd.grad(ssm_ref.ssm_scan_ref(*b), b, dy)
        errs = {}
        for name, g, w in zip(("x", "dt", "Bm", "Cm", "A"), got, want):
            scale = max(1.0, float(w.abs().max()))
            err = float((g.float() - w.float()).abs().max())
            tol = SSM_GRAD_TOL if dtype == torch.float32 else SSM_BF16_RTOL
            if not err <= tol * scale:
                raise RuntimeError(f"ssm_scan grad of {name} ({dtype}): max |err| "
                                   f"{err} against plain autograd (tol {tol} x {scale})")
            errs[name] = err
        key = str(dtype).replace("torch.", "")
        y_plain = ssm_ref.ssm_scan_ref(*b)
        bound, by, _, _ = ssm_bound_ms(args[0], args[2], args[4])
        out[key] = {
            "max_abs_err": errs, "forward_bound_ms": bound, "forward_bound_by": by,
            "kernel_forward_ms": timed_ms(lambda: ssm_ops.ssm_scan(*args), calls=5),
            "backward_ms": timed_ms(lambda: ssm_ref.ssm_scan_ref_backward(*args, dy),
                                    calls=2, reps=3),
            "plain_autograd_backward_ms": statistics.median(
                event_ms(lambda: torch.autograd.grad(y_plain, b, dy, retain_graph=True))
                for _ in range(3)),
            "plain_forward_ms": timed_ms(lambda: ssm_ref.ssm_scan_ref(*args),
                                         calls=2, reps=3),
        }
    return {"shape": list(HYMBA_TRAIN_SSM), **out}


def check_flash_qwen2(ops, ref) -> dict:
    """Flash attention at qwen2's two training shapes (bf16, causal, GQA
    6:1, hd 128) against its plain version on the tensor-core route, timed
    beside the plain version and ``scaled_dot_product_attention``."""
    gen = torch.Generator().manual_seed(SEED + 8)
    out = {}
    for name, (B, S, H, KV, hd) in QWEN_ATTN.items():
        q, k, v = attention_inputs(gen, B, S, S, H, KV, hd, torch.bfloat16)
        if route_of(ops, q, k) != "tensor_core":
            raise RuntimeError(f"flash at qwen2's {name} shape is not routed to "
                               "the tensor cores")
        _, err, ratio = flash_case(ops, ref, f"flash at qwen2's {name} shape",
                                   q, k, v, True, None, None, BF16_TOL)
        out[name] = {"shape": [B, S, H, KV, hd], "max_abs_err": err,
                     "bound_ratio": ratio,
                     **flash_times(ops, ref, q, k, v, None)}
        del q, k, v
    return out


def reduced_card_vs_cpu(TR, flash_ops, ssm_ops) -> dict:
    """Reduced qwen2 (one PSGF round: 2 pods, 2 steps) and reduced hymba (2
    training steps through both kernels' backward) in float32, on the card
    and on the CPU from the same key: losses within TRAIN_CPU_TOL; the
    sync's keys, selection, leaf gates and wire bytes bitwise."""
    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.core.fl import masks as M
    from repro_torch.models import decoder
    from repro_torch.models import spec as S

    kw = dict(steps=2, batch=2, seq=64, log_every=100)
    runs = {}
    with float32_configs(TR):
        for dev in ("cuda", "cpu"):
            hist, hyst = {}, {}
            ssm_ops.LAUNCHES = 0
            flash_ops.reset_launch_counts()
            runs[dev] = {
                "qwen2": TR.train_psgf(QWEN, pods=2, sync_interval=2, device=dev,
                                       history=hist, **kw),
                "qwen2_history": hist,
                "hymba": TR.train("hymba-1.5b", device=dev, history=hyst, **kw),
                "launches": {"flash_attention": flash_ops.LAUNCHES,
                             "ssm_scan": ssm_ops.LAUNCHES}}
    card, cpu = runs["cuda"], runs["cpu"]
    errs = {}
    for name in ("qwen2", "hymba"):
        check_losses(f"reduced {name} on the card", card[name])
        diff = [abs(a - b) for a, b in zip(card[name], cpu[name])]
        if not all(d <= TRAIN_CPU_TOL * (1 + abs(b)) for d, b in zip(diff, cpu[name])):
            raise RuntimeError(f"reduced {name} losses card {card[name]} vs CPU "
                               f"{cpu[name]}")
        errs[name] = max(diff)
    hc, hp = card["qwen2_history"], cpu["qwen2_history"]
    if hc["sync_keys"] != hp["sync_keys"] or hc["wire_bytes"] != hp["wire_bytes"]:
        raise RuntimeError(f"reduced qwen2 sync card {hc['wire_bytes']} vs CPU "
                           f"{hp['wire_bytes']}")
    spec = decoder.model_spec(get_config(QWEN).reduced())
    for key in hc["sync_keys"]:
        ks = {dev: R.split(torch.tensor(key, device=dev), 3) for dev in ("cuda", "cpu")}
        sel = {dev: M.select_clients(k[0], 2, 0.5).cpu() for dev, k in ks.items()}
        gates = {dev: [float(g) for g in pt.leaves(M.leaf_gates(k[1], spec, 0.3),
                                                   is_leaf=S.is_spec)]
                 for dev, k in ks.items()}
        if not (torch.equal(sel["cuda"], sel["cpu"]) and gates["cuda"] == gates["cpu"]):
            raise RuntimeError(f"sync key {key}: selection or gates differ")
    if card["launches"]["ssm_scan"] == 0 or card["launches"]["flash_attention"] == 0:
        raise RuntimeError(f"reduced training on the card launched {card['launches']}")
    return {"losses_max_abs_err": errs, "sync_bitwise": True,
            "wire_bytes": hc["wire_bytes"], "launches_card": card["launches"],
            "qwen2_losses": card["qwen2"], "hymba_losses": card["hymba"]}


def drive_zoo_training(flash_ops, flash_ref, ssm_ops, ssm_ref) -> dict:
    """Phase 9: ``launch.train.train_psgf`` and ``train`` for qwen2-1.5b at
    full width on the card, a profiled PSGF step, reduced qwen2 and hymba
    against the CPU, ssm_scan's gradient and flash at qwen2's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core import psgf_dp as P
    from repro_torch.launch import train as TR
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder
    from repro_torch.models.spec import spec_num_params
    from repro_torch.optim import Adam, one_cycle

    cfg = get_config(QWEN)
    n_params = spec_num_params(decoder.model_spec(cfg))
    layers = cfg.num_layers * (2 if cfg.remat else 1)  # forward + recompute

    psgf = train_run("train_psgf", lambda **k: TR.train_psgf(QWEN, **k),
                     flash_ops, ssm_ops, reduced=False, log_every=4, **QWEN_PSGF)
    hist = psgf["history"]
    pods, steps = QWEN_PSGF["pods"], QWEN_PSGF["steps"]
    want_bytes = gate_bytes_from_keys(cfg, hist["sync_keys"], pods, 0.3, 0.2, 0.5)
    full = 2.0 * pods * n_params * 4
    if (hist["wire_bytes"] != want_bytes or len(want_bytes) != steps // 4
            or not 0 < hist["psgf_bytes"] < hist["full_bytes"]
            or hist["full_bytes"] != full * len(want_bytes)):
        raise RuntimeError(f"PSGF bytes {hist['wire_bytes']} (from the gates "
                           f"{want_bytes}), total {hist['psgf_bytes']} vs full "
                           f"{hist['full_bytes']}")
    routes = psgf["flash_route_launches"]
    if routes != {"scalar": 0, "short": 0, "tensor_core": steps * pods * layers}:
        raise RuntimeError(f"train_psgf flash launches {routes}")
    psgf.update(per_step(psgf, steps, pods))
    tokens = pods * QWEN_PSGF["batch"] * QWEN_PSGF["seq"]
    psgf["tokens_per_s"] = tokens / (psgf["warm_ms_per_step"] / 1e3)
    psgf["ms_per_sync"] = [s * 1e3 for s in hist["sync_s"]]
    psgf["psgf_over_full_bytes"] = hist["psgf_bytes"] / hist["full_bytes"]
    log(json.dumps({"zoo_train_psgf": {k: v for k, v in psgf.items()
                                       if k != "history"}}))

    api = ModelApi(cfg, "cuda")
    prof = profile_psgf_step(api, Adam(lr=one_cycle(3e-4, steps)), cfg, P, TR)
    log(json.dumps({"zoo_profile_psgf_step": prof}))

    plain = train_run("train", lambda **k: TR.train(QWEN, **k), flash_ops,
                      ssm_ops, reduced=False, log_every=1, **QWEN_TRAIN)
    routes = plain["flash_route_launches"]
    if routes != {"scalar": 0, "short": 0,
                  "tensor_core": QWEN_TRAIN["steps"] * layers}:
        raise RuntimeError(f"train flash launches {routes}")
    plain.update(per_step(plain, QWEN_TRAIN["steps"]))
    plain["tokens_per_s"] = (QWEN_TRAIN["batch"] * QWEN_TRAIN["seq"]
                             / (plain["warm_ms_per_step"] / 1e3))
    log(json.dumps({"zoo_train": {k: v for k, v in plain.items()
                                  if k != "history"}}))

    reduced = reduced_card_vs_cpu(TR, flash_ops, ssm_ops)
    ssm = ssm_scan_training_grads(ssm_ops, ssm_ref)
    flash = check_flash_qwen2(flash_ops, flash_ref)
    return {
        "model": QWEN, "params": n_params, "activations": cfg.dtype,
        "weights": "float32 from PRNGKey(0)", "remat": cfg.remat,
        "train_psgf": {**{k: v for k, v in psgf.items() if k != "history"},
                       "config": QWEN_PSGF, "wire_bytes": hist["wire_bytes"]},
        "profile_psgf_step": prof,
        "train": {**{k: v for k, v in plain.items() if k != "history"},
                  "config": QWEN_TRAIN},
        "reduced_card_vs_cpu": reduced,
        "ssm_scan_training_grads": ssm,
        "flash_qwen2": flash,
        "launches": {"flash_attention": psgf["flash_launches"] + plain["flash_launches"],
                     "ssm_scan": reduced["launches_card"]["ssm_scan"]},
    }


# ---------------------------------------------------------------------------
# Phase 10: PSGF-Fed across two processes on one card (gloo)
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 600        # both children, all three runs and the serving
DIST_RUNS = ("host", "scan", "while")


def distributed_child(workdir: str) -> dict:
    """One process of phase 10 (``chip_smoke.py --distributed-child DIR``):
    joins the group on ``cuda:0`` over gloo, runs the nn5 cell three ways
    (``driver="host"`` partitioned, ``client_mesh`` with ``scan`` and with
    ``while``), each with the kernel counts set to 0 just before and read
    just after (the while run's launches are each captured segment's calls
    times its replays, plus its eager first round), then the smoke's
    process-sharded serving. Returns its report."""
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.core.fl.partition import MeshRun
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.psgf_mix import ops as mix_ops
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_client_mesh

    if not D.initialize_distributed(device="cuda:0", backend="gloo"):
        raise RuntimeError("distributed child: no process group configured")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, model, _, _, fl, kw = host_cell(E, data=False)
    z = np.load(os.path.join(workdir, "inputs.npz"))
    tr, te = z["train"], z["test"]
    mesh = make_client_mesh(multi_host=True)
    counts = lambda: {"psgf_mix_batch": mix_ops.LAUNCHES,  # noqa: E731
                      "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}
    out = {"process": D.process_index(), "backend": D.backend(),
           "device": str(D.device()), "pid": os.getpid(), "runs": {}}
    for name in DIST_RUNS:
        run_kw = (dict(driver="host") if name == "host"
                  else dict(driver=name, client_mesh=mesh))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        D.sync(name)                            # both start together
        mix_ops.LAUNCHES = 0
        flash_ops.reset_launch_counts()
        with counting_captures(E, counts) as captured:
            t0 = time.perf_counter()
            h = E.run_fl(model.cfg, fl, tr, te, R.PRNGKey(SEED),
                         device="cuda", **kw, **run_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        if captured:                 # MeshRun captures its segments in order
            replays = h["mesh_run"]["replays"]
            per = dict(zip(MeshRun.SEGMENTS, (c for _, c in captured)))
            launches = {k: v + sum(p[k] * (replays[n] - 1)
                                   for n, p in per.items())
                        for k, v in launches.items()}
        lo, hi = h["owned_rows"]
        ex = h["exchange"]
        rounds = h["rounds_run"]
        rec = {"digest": run_digest(h, [(0, hi - lo)]), "owned_rows": [lo, hi],
               "run_s": wall, "rounds_per_s": rounds / wall,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "exchange": {k: ex[k] for k in ("merge", "gather", "rmse")}}
        if name == "host":
            store = h["client_store"]
            rec["round_s"] = h["round_s"]
            rec["store_setup_s"] = h["client_store_setup_s"]
            rec["store_state_bytes"] = store.state_nbytes
            store.close()
        else:
            rec["mesh_run"] = h["mesh_run"]
        out["runs"][name] = rec
        del h
    serve_root = os.path.join(workdir, "serve")
    os.makedirs(serve_root, exist_ok=True)
    out["serving"] = D.smoke_serving(serve_root, D.device())
    D.sync("done")
    D.shutdown_distributed()
    return out


def drive_distributed(mix_ops, flash_ops, host_digest) -> dict:
    """Phase 10: the nn5 cell across two processes on this card over gloo,
    each process holding half of the client state, against one-process
    runs bit for bit: the partitioned host run against phase 7's host run
    (``host_digest``), the mesh's scan and while runs against a one-process
    scan run made here first."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.launch import distributed as D

    task, model, tr, te, fl, kw = host_cell(E)
    free_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mix_ops.LAUNCHES = 0
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    h = E.run_fl(model.cfg, fl, tr, te, R.PRNGKey(SEED), driver="scan",
                 device="cuda", **kw)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    blocks = [D.block_range(HOST_K, i, DIST_PROCESSES)
              for i in range(DIST_PROCESSES)]
    scan = {"digest": run_digest(h, blocks), "run_s": scan_s,
            "rounds_per_s": h["rounds_run"] / scan_s,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"psgf_mix_batch": mix_ops.LAUNCHES,
                         "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}}
    del h
    free_device_memory()

    workdir = os.path.join(ROOT, "build", "chip_smoke_distributed")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), train=tr, test=te)
    t0 = time.perf_counter()
    procs = D.spawn_processes(
        DIST_PROCESSES,
        [sys.executable, os.path.abspath(__file__), "--distributed-child",
         workdir], env=D.child_env(), timeout=DIST_TIMEOUT_S,
        coordinator="file://" + os.path.join(workdir, "store"))
    spawn_s = time.perf_counter() - t0
    reports = []
    for i, r in enumerate(procs):
        if r.returncode != 0:
            log(f"--- distributed child {i} stderr ---\n{r.stderr[-6000:]}")
            raise RuntimeError(f"distributed child {i} exited {r.returncode}")
        reports.append(json.loads(r.stdout.strip().splitlines()[-1]))
    same = {}
    for i, rep in enumerate(reports):
        if (rep["backend"], rep["device"]) != ("gloo", "cuda:0"):
            raise RuntimeError(f"process {i}: {rep['backend']} on {rep['device']}")
        for name, run in rep["runs"].items():
            want = host_digest if name == "host" else scan["digest"]
            got = run["digest"]
            if run["owned_rows"] != list(blocks[i]):
                raise RuntimeError(f"process {i} {name}: rows {run['owned_rows']}")
            checks = {k: got[k] == want[k] for k in
                      ("losses", "comm", "rmse", "final_rmse", "rounds",
                       "w_global_sha")}
            checks["w_clients_block_sha"] = got["w_clients_sha"][0] == want["w_clients_sha"][i]
            same[f"process_{i}/{name}"] = checks
            if not all(checks.values()):
                raise RuntimeError(f"process {i} {name} != the one-process "
                                   f"run: {checks}")
            if not all(run["launches"].values()):
                raise RuntimeError(f"process {i} {name}: a kernel never "
                                   f"launched: {run['launches']}")
    owned = sorted(c for r in reports for c in r["serving"]["owned_clusters"])
    if owned != [0, 1] or not all(r["serving"]["shard_gauges"] for r in reports):
        raise RuntimeError(f"process-sharded serving: {[r['serving'] for r in reports]}")

    def per_round(run, kind):
        ex = run["exchange"][kind]
        return {"bytes": ex["bytes"], "s": ex["s"]}

    runs = {name: [{"rounds_per_s": r["runs"][name]["rounds_per_s"],
                    "run_s": r["runs"][name]["run_s"],
                    "peak_device_bytes": r["runs"][name]["peak_device_bytes"],
                    "launches": r["runs"][name]["launches"],
                    "merge": per_round(r["runs"][name], "merge"),
                    "gather": per_round(r["runs"][name], "gather"),
                    **{k: r["runs"][name][k] for k in
                       ("round_s", "store_setup_s", "store_state_bytes",
                        "mesh_run") if k in r["runs"][name]}}
                   for r in reports] for name in DIST_RUNS}
    return {
        "cell": f"nn5 full, {HOST_K} stations, cohort {HOST_S}, client "
                f"chunk {HOST_CHUNK}, {HOST_ROUNDS} rounds, eval every "
                f"{HOST_EVAL}, {DIST_PROCESSES} processes on one card, gloo",
        "processes": [{"process": r["process"], "backend": r["backend"],
                       "device": r["device"]} for r in reports],
        "bitwise": same,
        "one_process_scan": {k: v for k, v in scan.items() if k != "digest"},
        "one_process_scan_digest": scan["digest"],
        "runs": runs, "spawn_s": spawn_s,
        "serving": [r["serving"] for r in reports],
        "launches": {name: {k: [r["runs"][name]["launches"][k] for r in reports]
                            for k in ("psgf_mix_batch", "flash_short")}
                     for name in DIST_RUNS},
    }


# ---------------------------------------------------------------------------
# Phase 11: the zoo's vlm and moe families served at full width
# ---------------------------------------------------------------------------

# (arch, layers kept (None: all), batch, prompt tokens, tokens generated):
# every width as published, depth cut to fit one 80 GB card (fp32 weights:
# phi3.5-moe 5.2 GB a layer, deepseek-v2 15.9 GB a layer) and, phi3.5-moe's
# to 4 layers (8 fit), the script's 1,200 s beside phase 18; internvl2's 256
# patches + 1,792 tokens make a 2,048-position prefill; deepseek-v2 also
# serves one 4,096-token prompt, past the 2,048 threshold, through flash_mha
ZOO_SERVE = (
    ("internvl2-2b", None, 4, 1792, 32),
    ("phi3.5-moe-42b-a6.6b", 4, 4, 2048, 32),
    ("deepseek-v2-236b", 2, 2, 2048, 32),
    ("deepseek-v2-236b", 2, 1, 4096, 32),
)
# flash attention at the prefills above: (B, S, H, KV, hd), bf16, causal
ZOO_ATTN = {"phi3.5-moe": (4, 2048, 32, 8, 128), "internvl2": (4, 2048, 16, 8, 128)}
# full-width block 0, card against CPU in float32: B x S tokens
ZOO_BLOCK0 = (1, 64)


@contextlib.contextmanager
def patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def counting_flash_mha(layers, counts):
    """``layers.flash_mha`` wrapped to count its calls in ``counts``."""
    real = layers.flash_mha

    def flash_mha(*args, **kw):
        counts["flash_mha"] += 1
        return real(*args, **kw)
    return patched(layers, "flash_mha", flash_mha)


def recording_routes(layers, log):
    """``layers.moe_route`` wrapped to append each call's top-k experts (on
    the host) to ``log``."""
    real = layers.moe_route

    def moe_route(*args, **kw):
        route = real(*args, **kw)
        log.append(route["gate_idx"].cpu())
        return route
    return patched(layers, "moe_route", moe_route)


def decode_cast_bytes(cfg) -> int:
    """Bytes one decode step moves to cast the float32 weights it uses to
    bf16 at each use, as the reference does: every decoder block leaf and
    the head read in float32, written and read again in bf16 (8 bytes a
    parameter); the embedding is gathered per token, unless the head is
    tied to it (then the whole table is cast); an encoder is not run."""
    from repro_torch.common import pytree_utils as pt
    from repro_torch.launch.api import model_module
    from repro_torch.models import spec as S

    spec = model_module(cfg).model_spec(cfg)
    skip = ("enc_blocks/", "enc_norm/") + (() if cfg.tie_embeddings else ("embed/",))
    n = sum(math.prod(s.shape) for path, s in
            pt.flatten_with_paths(spec, is_leaf=S.is_spec)
            if not path.startswith(skip))
    return 8 * n


def zoo_reduced_card_vs_cpu(arch) -> dict:
    """Reduced ``arch`` in float32 on the same numpy-made params: prefill of
    48 tokens (after 256 patches for vlm) and 8 greedy decode steps on the
    card and on the CPU; tokens equal, logits within HYBRID_CPU_TOL, and
    every MoE call's top-k experts equal at every token."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    host = numpy_params(decoder.model_spec(cfg), SEED)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 48))
    start = 48 + (cfg.vlm.num_patches if cfg.family == "vlm" else 0)
    runs = {}
    for dev in ("cuda", "cpu"):
        api = ModelApi(cfg, dev)
        params = decoder.params_from_numpy(host, dev)
        inputs = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "vlm":
            inputs["img_embeds"] = decoder.image_embeds(cfg, 2, R.PRNGKey(0, device=dev))
        routes = []
        with torch.inference_mode(), recording_routes(layers, routes):
            logits, cache = api.prefill(params, inputs, cache_len=start + 8)
            out, steps = [], [logits[:, -1].float().cpu()]
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for i in range(8):
                out.append(tok.cpu())
                logits, cache = api.decode_step(params, cache, tok, start + i)
                steps.append(logits[:, -1].float().cpu())
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        runs[dev] = (torch.cat(out, dim=1), torch.stack(steps), routes)
    (tg, lg, rg), (tc, lc, rc) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    routes_equal = len(rg) == len(rc) and all(torch.equal(a, b) for a, b in zip(rg, rc))
    if cfg.family == "moe" and not (rg and routes_equal):
        raise RuntimeError(f"reduced {arch}: MoE top-k experts differ between the "
                           f"card and the CPU ({len(rg)} / {len(rc)} calls)")
    if not (torch.equal(tg, tc) and torch.allclose(lg, lc, atol=HYBRID_CPU_TOL,
                                                   rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"reduced {arch} card vs CPU: tokens equal "
                           f"{torch.equal(tg, tc)}, logits max |err| {err}")
    return {"tokens_equal": True, "logits_max_abs_err": err,
            "moe_calls_routed_equal": len(rg) if cfg.family == "moe" else None,
            "tokens": tg[0].tolist()}


def zoo_block0_card_vs_cpu(cfg) -> dict:
    """Block 0 at full width, float32, B x S = ZOO_BLOCK0: its weights drawn
    on the card from a key, the block on the card against the CPU from the
    same weights (and, for MoE, the same top-k experts at every token)."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.models import decoder
    from repro_torch.models import layers
    from repro_torch.models import spec as S

    cfg = dataclasses.replace(cfg, dtype="float32")
    p0 = S.init_params_from_key(decoder.block_spec(cfg), R.PRNGKey(SEED + 11),
                                "cuda")
    B, T = ZOO_BLOCK0
    x = (torch.randn(B, T, cfg.d_model, generator=torch.Generator().manual_seed(SEED))
         ).cuda()
    pos = torch.arange(T, dtype=torch.int32, device="cuda")
    outs, routes = {}, {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            p = p0 if dev == "cuda" else pt.tree_map(lambda a: a.cpu(), p0)
            routes[dev] = []
            with recording_routes(layers, routes[dev]):
                y, _ = decoder._block_apply(cfg, p, x.to(dev), pos.to(dev), 0.0, "auto")
            outs[dev] = y.cpu()
            del p
    del p0
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    same_routes = all(torch.equal(a, b) for a, b in zip(routes["cuda"], routes["cpu"]))
    if not (torch.isfinite(outs["cuda"]).all() and same_routes
            and torch.allclose(outs["cuda"], outs["cpu"], atol=HYBRID_CPU_TOL,
                               rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"{cfg.name} block 0 card vs CPU: max |err| {err}, "
                           f"routes equal {same_routes}")
    return {"shape": [B, T, cfg.d_model], "max_abs_err": err,
            "max_abs_out": float(outs["cpu"].abs().max()),
            "moe_routes_equal": same_routes if routes["cpu"] else None}


def check_flash_zoo(ops, ref) -> dict:
    """Flash attention at phi3.5-moe's and internvl2's prefill (bf16,
    causal, hd 128, GQA 4:1 and 2:1) against its plain version on the
    tensor-core route, timed beside the plain version and
    ``scaled_dot_product_attention``."""
    gen = torch.Generator().manual_seed(SEED + 12)
    out = {}
    for name, (B, S, H, KV, hd) in ZOO_ATTN.items():
        q, k, v = attention_inputs(gen, B, S, S, H, KV, hd, torch.bfloat16)
        if route_of(ops, q, k) != "tensor_core":
            raise RuntimeError(f"flash at {name}'s shape is not routed to the "
                               "tensor cores")
        _, err, ratio = flash_case(ops, ref, f"flash at {name}'s prefill",
                                   q, k, v, True, None, None, BF16_TOL)
        out[name] = {"shape": [B, S, H, KV, hd], "max_abs_err": err,
                     "bound_ratio": ratio,
                     **flash_times(ops, ref, q, k, v, None)}
        del q, k, v
    return out


def warm_profile(cfg, batch, prompt, profiled=None) -> dict:
    """The served model again from the same key, outside ``serve``: a warm
    prefill (host ms of two calls), a profiled prefill (of the first
    ``profiled`` prompt tokens, if given: the profiler takes ~0.7 ms a
    kernel to trace and sum), warm decode steps and three profiled ones;
    ``serve``'s own prefill is the process's first at these shapes and
    carries one-time costs."""
    from repro_torch import random as R
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder, encdec

    api = ModelApi(cfg, "cuda")
    params = api.init_params(R.PRNGKey(0))
    inputs = {"tokens": torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, prompt))).cuda()}
    start = prompt
    if cfg.family == "vlm":
        inputs["img_embeds"] = decoder.image_embeds(
            cfg, batch, R.PRNGKey(0, device="cuda"))
        start += cfg.vlm.num_patches
    if cfg.family == "audio":
        inputs["src_embeds"] = encdec.source_embeds(
            cfg, batch, prompt, R.PRNGKey(0, device="cuda"))
    steps = 8
    with torch.inference_mode():
        def prefill():
            return api.prefill(params, inputs, cache_len=start + steps + 4)

        prefill_ms = [host_ms(prefill) for _ in range(2)]
        if profiled is not None and profiled != prompt:
            cut = {k: v[:, :profiled] for k, v in inputs.items()}
            prof = profile_device(lambda: api.prefill(params, cut), 1, "prefill")
            prof["prompt_len"] = profiled
        else:
            prof = profile_device(prefill, 1, "prefill")
        logits, cache = prefill()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        api.decode_step(params, cache, tok, start)
        decode_ms = host_ms(lambda: [api.decode_step(params, cache, tok, start + 1 + i)
                                     for i in range(steps)]) / steps
        dprof = profile_device(lambda: api.decode_step(params, cache, tok,
                                                       start + steps + 1),
                               3, "decode_step")
    del params, cache, logits
    return {"prefill_ms_warm": prefill_ms, "decode_ms_per_token_warm": decode_ms,
            "profile_prefill": prof, "profile_decode_step": dprof}


def serve_one(flash_ops, layers, arch, depth, batch, prompt, gen) -> dict:
    """One ``serve`` call at full width (depth cut to ``depth`` layers), the
    kernel counts set to 0 just before and read just after."""
    import dataclasses

    from repro_torch.launch import serve as serve_mod

    real = serve_mod.get_config
    cut = (real if depth is None else
           lambda a: dataclasses.replace(real(a), num_layers=depth))
    free_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {"flash_mha": 0}
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(serve_mod, "get_config", cut), counting_flash_mha(layers, counts):
        rep = serve_mod.serve(arch, batch=batch, prompt_len=prompt, gen=gen,
                              reduced=False, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    flash = dict(flash_ops.ROUTE_LAUNCHES)
    cfg = cut(arch)
    toks = rep["tokens"]
    if toks.shape != (batch, gen) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise RuntimeError(f"{arch}: generated tokens {toks.shape} out of range")
    return {"cfg": cfg, "params": rep["params"], "batch": batch,
            "prompt_len": prompt, "gen": gen, "init_s": rep["init_s"],
            "prefill_ms": rep["prefill_ms"],
            "decode_ms_per_token": rep["decode_ms_per_token"],
            "serve_wall_s": wall_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_route_launches_prefill": flash,
            "flash_mha_calls": counts["flash_mha"],
            "first_tokens": toks[:, :8].tolist()}


def drive_zoo_families(flash_ops, flash_ref) -> dict:
    """Phase 11: ``serve`` for internvl2-2b (whole), phi3.5-moe-42b-a6.6b (4
    of 32 layers) and deepseek-v2-236b (2 of 60 layers) at their published
    widths; flash at their prefill shapes; full-width block 0 and the
    reduced configs on the card against the CPU."""
    from repro_torch.common import hw
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    card = card_info()
    kernels = check_flash_zoo(flash_ops, flash_ref)
    models = []
    for arch, depth, batch, prompt, gen in ZOO_SERVE:
        rep = serve_one(flash_ops, layers, arch, depth, batch, prompt, gen)
        cfg = rep.pop("cfg")
        flash, mha = rep["flash_route_launches_prefill"], rep["flash_mha_calls"]
        if cfg.mla is not None:
            # MLA never reaches the kernel; past 2,048 positions flash_mha
            want_flash = {"scalar": 0, "tensor_core": 0, "short": 0}
            want_mha = cfg.num_layers if prompt > 2048 else 0
        else:
            want_flash = {"scalar": 0, "tensor_core": cfg.num_layers, "short": 0}
            want_mha = 0
        if flash != want_flash or mha != want_mha:
            raise RuntimeError(f"{arch} ({batch} x {prompt}): flash launches "
                               f"{flash}, flash_mha calls {mha} for one prefill "
                               f"of {cfg.num_layers} layers")
        if prompt <= 2048:            # the 4,096-token run follows a warm one
            free_device_memory()
            rep.update(warm_profile(cfg, batch, prompt))
        cast = decode_cast_bytes(cfg)
        rep.update(model=arch, layers=cfg.num_layers,
                   layers_published=get_config(arch).num_layers,
                   decode_cast_bytes_per_token=cast,
                   decode_cast_bound_ms=cast / hw.HBM_BYTES_PER_S * 1e3,
                   card=card)
        log(json.dumps({"zoo_model": rep}))
        models.append(rep)
    block0, reduced = {}, {}
    for arch in ("internvl2-2b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"):
        free_device_memory()
        block0[arch] = zoo_block0_card_vs_cpu(get_config(arch))
        reduced[arch] = zoo_reduced_card_vs_cpu(arch)
    return {"card": card, "activations": "bfloat16",
            "weights": "float32 from PRNGKey(0)", "models": models,
            "flash_tensor_core": kernels, "block0_card_vs_cpu": block0,
            "reduced_card_vs_cpu": reduced,
            "flash_launches_prefill": sum(
                m["flash_route_launches_prefill"]["tensor_core"] for m in models)}


# ---------------------------------------------------------------------------
# Phase 12: the zoo's last two families, xlstm-125m and seamless-m4t-large-v2
# ---------------------------------------------------------------------------

XLSTM, SEAMLESS = "xlstm-125m", "seamless-m4t-large-v2"
# Both run whole at their published widths; the cuts are in sequence length
# and steps only. xlstm's recurrences are eager loops over positions, ~41
# device kernels a position and layer, host-bound (on the H100: a 4 x 512
# prefill ~3.3 s, a training step ~5 ms a position and layer with remat), so
# its prompt is 512 tokens, its profiled prefill 32, and its training
# sequences 16 (PSGF) and 64 (train), not 64 and 512; its trainers take 4
# and 2 steps (3.6 and 6.2 s a step on the H100), which the script's
# 1,200 s allow beside phase 18 (its loss falls over both). Seamless
# encodes 2,048 source frames and prefills 2,048 target tokens.
# serving: (arch, batch, prompt tokens, tokens generated, profiled prompt)
LAST_SERVE = ((XLSTM, 4, 512, 32, 32), (SEAMLESS, 4, 2048, 32, 2048))
XLSTM_PSGF = dict(pods=2, sync_interval=4, batch=8, seq=16, steps=4)
XLSTM_TRAIN = dict(batch=4, seq=64, steps=2)
# one pod: at ~23 bytes a parameter and pod (phase 9's qwen2-1.5b), two
# pods of seamless's 1.63e9 would need ~75 GB. 8 steps, not 4: over 4
# steps of the trainer's 1cycle the loss rises (12.95 -> 16.34 on the H100)
# and fails ``check_losses``; at reduced width the reference's trainer
# rises at the last of 4 steps too, and the port's follows it loss for loss
# (tests/test_torch_train.py); over 8 steps it falls below its start
SEAMLESS_TRAIN = dict(batch=4, seq=512, steps=8)
# flash attention at seamless's serving prefill and at its training step
# (SEAMLESS_TRAIN): (B, S, H, KV, hd), bf16, the encoder non-causal and the
# decoder causal
SEAMLESS_ATTN = {"prefill": (4, 2048, 16, 16, 64),
                 "training": (SEAMLESS_TRAIN["batch"], SEAMLESS_TRAIN["seq"],
                              16, 16, 64)}
# the reduced models on the card against the CPU: xlstm at 4 layers, so
# that layer 3 runs the sLSTM (reduced() keeps 2, both mLSTM)
LAST_REDUCED = {XLSTM: dict(num_layers=4), SEAMLESS: {}}


def flash_layers(cfg) -> int:
    """Self-attention layers of one forward, each one flash launch on the
    card: none for xlstm, the encoder's and the decoder's for seamless."""
    return 0 if cfg.family == "ssm" else cfg.encdec.enc_layers + cfg.encdec.dec_layers


def check_flash_seamless(ops, ref) -> dict:
    """Flash attention at seamless's prefill and training shapes
    (SEAMLESS_ATTN), the encoder's non-causal and the decoder's causal call,
    against its plain version on the tensor-core route, timed beside the
    plain version and ``scaled_dot_product_attention``. Keys ``encoder`` and
    ``decoder`` are the prefill's, ``*_training`` the training step's."""
    gen = torch.Generator().manual_seed(SEED + 13)
    out = {}
    for where, (B, S, H, KV, hd) in SEAMLESS_ATTN.items():
        q, k, v = attention_inputs(gen, B, S, S, H, KV, hd, torch.bfloat16)
        if route_of(ops, q, k) != "tensor_core":
            raise RuntimeError(f"flash at seamless's {where} shape is not routed "
                               "to the tensor cores")
        for name, causal in (("encoder", False), ("decoder", True)):
            key = name if where == "prefill" else f"{name}_{where}"
            _, err, ratio = flash_case(ops, ref, f"flash at seamless's {name} "
                                       f"({where})", q, k, v, causal, None, None,
                                       BF16_TOL)
            out[key] = {"shape": [B, S, H, KV, hd], "causal": causal,
                        "max_abs_err": err, "bound_ratio": ratio,
                        **flash_times(ops, ref, q, k, v, None, causal)}
        del q, k, v
    return out


def last_block0_card_vs_cpu(arch) -> dict:
    """Block 0 at full width in float32, B x S = ZOO_BLOCK0, its weights
    drawn on the card from a key, on the card against the CPU: xlstm's
    block with the flag off and on (mLSTM, sLSTM), seamless's encoder and
    decoder blocks (the decoder over a random encoder output)."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.models import decoder, encdec
    from repro_torch.models import spec as S

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    B, T = ZOO_BLOCK0
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(B, T, cfg.d_model, generator=gen)
    enc_out = torch.randn(B, T, cfg.d_model, generator=gen)
    if cfg.family == "ssm":
        specs = {"block": decoder.block_spec(cfg)}
        runs = {f"flag_{f:g}": ("block", lambda p, x_, pos, f=f: decoder._block_apply(
            cfg, p, x_, pos, f, "auto")[0]) for f in (0.0, 1.0)}
    else:
        specs = {"enc": encdec.enc_block_spec(cfg), "dec": encdec.dec_block_spec(cfg)}
        runs = {"encoder": ("enc", lambda p, x_, pos: encdec._enc_block(
                    cfg, p, x_, pos, "auto")),
                "decoder": ("dec", lambda p, x_, pos: encdec._dec_block(
                    cfg, p, x_, pos, enc_out.to(x_.device),
                    torch.ones(B, T, dtype=torch.bool, device=x_.device), "auto"))}
    params = {name: S.init_params_from_key(spec, R.PRNGKey(SEED + 14), "cuda")
              for name, spec in specs.items()}
    out = {}
    with torch.inference_mode():
        for run, (name, fn) in runs.items():
            ys = {}
            for dev in ("cuda", "cpu"):
                p = pt.tree_map(lambda a: a.to(dev), params[name])
                pos = torch.arange(T, dtype=torch.int32, device=dev)
                ys[dev] = fn(p, x.to(dev), pos).cpu()
            err = float((ys["cuda"] - ys["cpu"]).abs().max())
            if not (torch.isfinite(ys["cuda"]).all()
                    and torch.allclose(ys["cuda"], ys["cpu"], atol=HYBRID_CPU_TOL,
                                       rtol=HYBRID_CPU_TOL)):
                raise RuntimeError(f"{arch} {run} block 0 card vs CPU: max |err| {err}")
            out[run] = {"max_abs_err": err,
                        "max_abs_out": float(ys["cpu"].abs().max())}
    del params
    return {"shape": [B, T, cfg.d_model], **out}


def last_reduced_card_vs_cpu(arch) -> dict:
    """The reduced model in float32 (LAST_REDUCED) on the same numpy-made
    params on the card and on the CPU: a 48-token prefill (seamless: 48
    source frames and 48 target tokens) and 8 greedy decode steps, the
    logits within HYBRID_CPU_TOL and the tokens equal; the prefill's cache
    (xlstm: every layer's final mLSTM and sLSTM state; seamless: the self
    and cross K/V) within HYBRID_CPU_TOL."""
    import dataclasses

    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi, model_module
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **LAST_REDUCED[arch])
    host = numpy_params(model_module(cfg).model_spec(cfg), SEED)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (2, 48))
    src = (0.1 * rng.standard_normal((2, 48, cfg.d_model))).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        api = ModelApi(cfg, dev)
        params = decoder.params_from_numpy(host, dev)
        inputs = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "audio":
            inputs["src_embeds"] = torch.from_numpy(src).to(dev)
        with torch.inference_mode():
            logits, cache = api.prefill(params, inputs, cache_len=56)
            first_cache = pt.tree_map(lambda a: a.float().cpu().clone(), cache)
            out, steps = [], [logits[:, -1].float().cpu()]
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for i in range(8):
                out.append(tok.cpu())
                logits, cache = api.decode_step(params, cache, tok, 48 + i)
                steps.append(logits[:, -1].float().cpu())
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        runs[dev] = (torch.cat(out, dim=1), torch.stack(steps), first_cache)
    (tg, lg, cg), (tc, lc, cc) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    cache_err = {}
    for (path, a), (_, b) in zip(pt.flatten_with_paths(cg), pt.flatten_with_paths(cc)):
        cache_err[path] = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=HYBRID_CPU_TOL, rtol=HYBRID_CPU_TOL):
            raise RuntimeError(f"reduced {arch} prefill cache {path} card vs CPU: "
                               f"max |err| {cache_err[path]}")
    if not (torch.equal(tg, tc) and torch.allclose(lg, lc, atol=HYBRID_CPU_TOL,
                                                   rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"reduced {arch} card vs CPU: tokens equal "
                           f"{torch.equal(tg, tc)}, logits max |err| {err}")
    return {"layers": cfg.num_layers, "tokens_equal": True,
            "logits_max_abs_err": err, "cache_max_abs_err": cache_err,
            "tokens": tg[0].tolist()}


def last_training_card_vs_cpu(TR, arch) -> dict:
    """Two ``train`` steps of the reduced model (LAST_REDUCED) in float32 on
    the card and on the CPU from the same key: losses within
    TRAIN_CPU_TOL."""
    import dataclasses

    real = TR._config

    def config(a, reduced):
        return dataclasses.replace(real(a, reduced), dtype="float32",
                                   **LAST_REDUCED[a])

    losses = {}
    with patched(TR, "_config", config):
        for dev in ("cuda", "cpu"):
            losses[dev] = TR.train(arch, steps=2, batch=2, seq=64, log_every=100,
                                   device=dev)
    check_losses(f"reduced {arch} on the card", losses["cuda"])
    diff = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    if not all(d <= TRAIN_CPU_TOL * (1 + abs(b)) for d, b in zip(diff, losses["cpu"])):
        raise RuntimeError(f"reduced {arch} losses card {losses['cuda']} vs CPU "
                           f"{losses['cpu']}")
    return {"losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
            "losses_max_abs_err": max(diff)}


def drive_last_families(flash_ops, flash_ref, ssm_ops) -> dict:
    """Phase 12: ``serve`` for xlstm-125m (4 x 512) and seamless-m4t-large-v2
    (4 x 2,048 frames and tokens), whole at their published widths;
    ``train_psgf`` and ``train`` of xlstm, ``train`` of seamless; flash at
    seamless's prefill and training shapes; full-width block 0 and the reduced models
    (serving and two training steps) on the card against the CPU."""
    from repro_torch.common import hw
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    from repro_torch.models import layers

    card = card_info()
    kernels = check_flash_seamless(flash_ops, flash_ref)
    models = []
    for arch, batch, prompt, gen, profiled in LAST_SERVE:
        rep = serve_one(flash_ops, layers, arch, None, batch, prompt, gen)
        cfg = rep.pop("cfg")
        want = {"scalar": 0, "tensor_core": flash_layers(cfg), "short": 0}
        if rep["flash_route_launches_prefill"] != want or rep["flash_mha_calls"]:
            raise RuntimeError(f"{arch} ({batch} x {prompt}): flash launches "
                               f"{rep['flash_route_launches_prefill']} (want "
                               f"{want}), flash_mha calls {rep['flash_mha_calls']}")
        free_device_memory()
        rep.update(warm_profile(cfg, batch, prompt, profiled))
        prof = rep["profile_prefill"]
        if cfg.family == "ssm" and prof.get("device_ops_per_prefill"):
            # the eager recurrence: device kernels per position and layer of
            # the profiled prefill, host ms per position of the warm one
            rep["prefill_ops_per_position_layer"] = (prof["device_ops_per_prefill"]
                                                     / (profiled * cfg.num_layers))
            rep["prefill_ms_per_position"] = statistics.median(
                rep["prefill_ms_warm"]) / prompt
        cast = decode_cast_bytes(cfg)
        rep.update(model=arch, layers=cfg.num_layers,
                   decode_cast_bytes_per_token=cast,
                   decode_cast_bound_ms=cast / hw.HBM_BYTES_PER_S * 1e3, card=card)
        log(json.dumps({"zoo_model": rep}))
        models.append(rep)

    training = {}
    n_xlstm = models[0]["params"]
    psgf = train_run("xlstm train_psgf", lambda **k: TR.train_psgf(XLSTM, **k),
                     flash_ops, ssm_ops, reduced=False, log_every=4, **XLSTM_PSGF)
    hist = psgf["history"]
    pods, steps = XLSTM_PSGF["pods"], XLSTM_PSGF["steps"]
    want_bytes = gate_bytes_from_keys(get_config(XLSTM), hist["sync_keys"], pods,
                                      0.3, 0.2, 0.5)
    if (hist["wire_bytes"] != want_bytes
            or len(want_bytes) != steps // XLSTM_PSGF["sync_interval"]
            or not 0 < hist["psgf_bytes"] < hist["full_bytes"]
            or hist["full_bytes"] != 2.0 * pods * n_xlstm * 4 * len(want_bytes)
            or psgf["flash_launches"] != 0):
        raise RuntimeError(f"xlstm PSGF bytes {hist['wire_bytes']} (from the gates "
                           f"{want_bytes}), total {hist['psgf_bytes']} vs full "
                           f"{hist['full_bytes']}, flash {psgf['flash_launches']}")
    psgf.update(per_step(psgf, steps, pods))
    psgf["tokens_per_s"] = (pods * XLSTM_PSGF["batch"] * XLSTM_PSGF["seq"]
                            / (psgf["warm_ms_per_step"] / 1e3))
    psgf["ms_per_sync"] = [t * 1e3 for t in hist["sync_s"]]
    psgf["psgf_over_full_bytes"] = hist["psgf_bytes"] / hist["full_bytes"]
    psgf["wire_bytes"] = hist["wire_bytes"]
    training["xlstm_train_psgf"] = {**{k: v for k, v in psgf.items()
                                       if k != "history"}, "config": XLSTM_PSGF}
    for name, arch, conf in (("xlstm_train", XLSTM, XLSTM_TRAIN),
                             ("seamless_train", SEAMLESS, SEAMLESS_TRAIN)):
        rec = train_run(name, lambda a=arch, **k: TR.train(a, **k), flash_ops,
                        ssm_ops, reduced=False, log_every=1, **conf)
        cfg = get_config(arch)
        # the forward and its remat recompute
        want = flash_layers(cfg) * (2 if cfg.remat else 1) * conf["steps"]
        if rec["flash_route_launches"] != {"scalar": 0, "short": 0,
                                           "tensor_core": want}:
            raise RuntimeError(f"{name} flash launches {rec['flash_route_launches']}"
                               f" (want {want} tensor-core)")
        rec.update(per_step(rec, conf["steps"]))
        rec["tokens_per_s"] = conf["batch"] * conf["seq"] / (rec["warm_ms_per_step"] / 1e3)
        training[name] = {**{k: v for k, v in rec.items() if k != "history"},
                          "config": conf}
    log(json.dumps({"last_families_training": {**training, "card": card}}))

    block0, reduced, reduced_training = {}, {}, {}
    for arch in (XLSTM, SEAMLESS):
        free_device_memory()
        block0[arch] = last_block0_card_vs_cpu(arch)
        reduced[arch] = last_reduced_card_vs_cpu(arch)
        reduced_training[arch] = last_training_card_vs_cpu(TR, arch)
    return {"card": card, "activations": "bfloat16",
            "weights": "float32 from PRNGKey(0)", "models": models,
            "training": training, "flash_tensor_core": kernels,
            "block0_card_vs_cpu": block0, "reduced_card_vs_cpu": reduced,
            "reduced_training_card_vs_cpu": reduced_training,
            "flash_launches_prefill": sum(
                m["flash_route_launches_prefill"]["tensor_core"] for m in models),
            "flash_launches_training": training["seamless_train"]["flash_launches"]}


# ---------------------------------------------------------------------------
# Phase 13: card training of the moe and vlm families
# ---------------------------------------------------------------------------

INTERNVL, PHI, DEEPSEEK = "internvl2-2b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"
# (record, arch, layers kept (None: all), trainer's keywords): every width as
# published; internvl2 whole, its 256 patches + 1,792 tokens a 2,048-position
# sequence; phi3.5-moe at 2 of its 32 layers, the depth whose one-device
# estimate fits with Adam (launch.dryrun: ~55 GB; 3 layers ~76)
MOE_VLM_TRAIN = (
    ("internvl2_train", INTERNVL, None, dict(batch=4, seq=1792, steps=8)),
    ("phi35_train", PHI, 2, dict(batch=4, seq=2048, steps=8)),
)
# phi3.5-moe under PSGF-DP: two pods with their Adam moments and the global
# model, at the deepest cut whose dry-run estimate is within PSGF_PEAK_LIMIT
PHI_PSGF = dict(pods=2, sync_interval=4, batch=4, seq=512, steps=8)
PSGF_PEAK_LIMIT = 70e9
# flash at phi3.5's PSGF step: (B, S, H, KV, hd), bf16, causal
PHI_PSGF_ATTN = (4, 512, 32, 8, 128)
# deepseek-v2 trains at reduced() size only; its full-width estimate, one
# layer of 60 with its embedding and head at 1 x 2,048, says why
DEEPSEEK_FULL_ESTIMATE = dict(layers=1, batch=1, seq=2048)
# the reduced models on the card against the CPU in float32: (arch, seq);
# deepseek at 2,048 (dense MLA) and 4,096 (past the threshold: flash_mha's
# blockwise backward)
MOE_VLM_REDUCED = ((DEEPSEEK, 2048), (DEEPSEEK, 4096), (PHI, 64), (INTERNVL, 64))


def cut_config(arch, depth):
    """``get_config(arch)`` with ``num_layers`` cut to ``depth`` (None: as
    published)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg, num_layers=depth)


def peak_estimate(DR, cfg, batch, seq, pods=1) -> float:
    """The dry run's one-device peak estimate in bytes, logged."""
    est = DR.one_device_peak(cfg, batch, seq, pods)["peak_bytes"]
    log(f"dry-run estimate: {cfg.name} at {cfg.num_layers} layers, {pods} pod(s)"
        f" x {batch} x {seq}: one-device peak {est / 1e9:.2f} GB")
    return est


def cut_train_run(TR, name, arch, depth, flash_ops, ssm_ops, estimate, psgf, **kw):
    """``train`` (or ``train_psgf``) of ``arch`` cut to ``depth`` layers
    through ``train_run``, with the measured peak logged beside the
    estimate: the peak less what was allocated before the trainer ran is
    the trainer's own, which the estimate accounts."""
    trainer = TR.train_psgf if psgf else TR.train
    with patched(TR, "get_config", lambda a: cut_config(a, depth)):
        rec = train_run(name, lambda **k: trainer(arch, **k), flash_ops, ssm_ops,
                        reduced=False, **kw)
    own = rec["peak_memory_bytes"] - rec["base_memory_bytes"]
    log(f"{name}: peak {rec['peak_memory_bytes'] / 1e9:.2f} GB measured, "
        f"{rec['base_memory_bytes'] / 1e9:.2f} GB of it allocated before the "
        f"trainer, {own / 1e9:.2f} GB its own; {estimate / 1e9:.2f} GB estimated")
    rec.update(peak_estimate_bytes=estimate, peak_own_bytes=own,
               peak_measured_over_estimate=rec["peak_memory_bytes"] / estimate,
               peak_own_over_estimate=own / estimate)
    return rec


def profile_train_step(TR, cfg, batch, seq) -> dict:
    """One warm ``train`` step of ``cfg`` on the card under the profiler,
    split into forward, backward and optimizer (the backward's kernels come
    from autograd's thread and land in ``other``, renamed here)."""
    from repro_torch import random as R
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import Adam, one_cycle

    free_device_memory()
    fn, api, optimizer = build_train_step(cfg, Adam(lr=one_cycle(3e-4, 8)), "cuda")
    params = api.init_params(R.PRNGKey(0))
    opt = optimizer.init(params)
    b = TR.make_batch(cfg, 0, batch, seq, "cuda")
    fn(params, opt, b)                                          # warm
    prof = profile_spans(lambda: fn(params, opt, b), ("train.",))
    prof["stages"]["backward"] = prof["stages"].pop("other")
    del params, opt
    return prof


def check_flash_phi_psgf(ops, ref) -> dict:
    """Flash at phi3.5-moe's PSGF step (PHI_PSGF_ATTN, bf16, causal) against
    its plain version on the tensor-core route, timed beside the plain
    version and ``scaled_dot_product_attention``."""
    B, S, H, KV, hd = PHI_PSGF_ATTN
    q, k, v = attention_inputs(torch.Generator().manual_seed(SEED + 15),
                               B, S, S, H, KV, hd, torch.bfloat16)
    if route_of(ops, q, k) != "tensor_core":
        raise RuntimeError("flash at phi3.5-moe's PSGF shape is not routed to the "
                           "tensor cores")
    _, err, ratio = flash_case(ops, ref, "flash at phi3.5-moe's PSGF step",
                               q, k, v, True, None, None, BF16_TOL)
    return {"shape": list(PHI_PSGF_ATTN), "max_abs_err": err, "bound_ratio": ratio,
            **flash_times(ops, ref, q, k, v, None)}


def moe_vlm_training_card_vs_cpu(TR, layers, arch, seq) -> dict:
    """Two ``train`` steps of reduced ``arch`` in float32 on the card and on
    the CPU from the same key, batch 2 x ``seq``: losses finite and within
    TRAIN_CPU_TOL, and every MoE call's top-k experts equal (the forward's
    and the remat recompute's)."""
    import dataclasses

    real = TR._config

    def config(a, reduced):
        return dataclasses.replace(real(a, reduced), dtype="float32")

    losses, routes = {}, {}
    with patched(TR, "_config", config):
        for dev in ("cuda", "cpu"):
            routes[dev] = []
            with recording_routes(layers, routes[dev]):
                losses[dev] = TR.train(arch, steps=2, batch=2, seq=seq,
                                       log_every=100, device=dev)
    diff = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    if not (all(math.isfinite(x) for x in losses["cuda"])
            and all(d <= TRAIN_CPU_TOL * (1 + abs(b))
                    for d, b in zip(diff, losses["cpu"]))):
        raise RuntimeError(f"reduced {arch} at seq {seq}: losses card "
                           f"{losses['cuda']} vs CPU {losses['cpu']}")
    rg, rc = routes["cuda"], routes["cpu"]
    moe = cut_config(arch, None).family == "moe"
    if moe and not (rg and len(rg) == len(rc)
                    and all(torch.equal(a, b) for a, b in zip(rg, rc))):
        raise RuntimeError(f"reduced {arch} at seq {seq}: MoE top-k experts differ "
                           f"between the card and the CPU ({len(rg)} / {len(rc)} "
                           "calls)")
    return {"seq": seq, "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
            "losses_max_abs_err": max(diff),
            "moe_calls_routed_equal": len(rg) if moe else None}


def drive_moe_vlm_training(flash_ops, flash_ref, ssm_ops) -> dict:
    """Phase 13: ``train`` of internvl2-2b whole and phi3.5-moe at 2 layers
    (and a profiled warm step of the latter), ``train_psgf`` of phi3.5-moe at the deepest cut the dry run fits within
    PSGF_PEAK_LIMIT, each beside the dry run's one-device peak estimate;
    deepseek-v2's full-width estimate; the reduced models' training on the
    card against the CPU; flash at phi3.5-moe's PSGF shape."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as TR
    from repro_torch.models import decoder, layers
    from repro_torch.models.spec import spec_num_params

    card = card_info()
    kernel = check_flash_phi_psgf(flash_ops, flash_ref)
    training, launches = {}, 0
    for name, arch, depth, conf in MOE_VLM_TRAIN:
        cfg = cut_config(arch, depth)
        est = peak_estimate(DR, cfg, conf["batch"], conf["seq"])
        rec = cut_train_run(TR, name, arch, depth, flash_ops, ssm_ops, est, False,
                            log_every=1, **conf)
        want = cfg.num_layers * (2 if cfg.remat else 1) * conf["steps"]
        if rec["flash_route_launches"] != {"scalar": 0, "short": 0,
                                           "tensor_core": want}:
            raise RuntimeError(f"{name} flash launches {rec['flash_route_launches']}"
                               f" (want {want} tensor-core)")
        launches += rec["flash_launches"]
        rec.update(per_step(rec, conf["steps"]))
        positions = conf["seq"] + (cfg.vlm.num_patches if cfg.family == "vlm" else 0)
        rec["tokens_per_s"] = conf["batch"] * positions / (rec["warm_ms_per_step"] / 1e3)
        training[name] = {**{k: v for k, v in rec.items() if k != "history"},
                          "layers": cfg.num_layers, "config": conf}
        if cfg.family == "moe":
            training[name]["profile_step"] = profile_train_step(
                TR, cfg, conf["batch"], conf["seq"])
        log(json.dumps({"moe_vlm_train": {name: training[name], "card": card}}))

    pods, steps = PHI_PSGF["pods"], PHI_PSGF["steps"]
    estimates, depth = {}, 0
    while depth < cut_config(PHI, None).num_layers:
        est = peak_estimate(DR, cut_config(PHI, depth + 1), PHI_PSGF["batch"],
                            PHI_PSGF["seq"], pods)
        estimates[depth + 1] = est
        if est > PSGF_PEAK_LIMIT:
            break
        depth += 1
    if depth == 0:
        raise RuntimeError(f"phi3.5-moe PSGF: no depth fits {PSGF_PEAK_LIMIT / 1e9} "
                           f"GB by the dry run ({estimates})")
    cfg = cut_config(PHI, depth)
    psgf = cut_train_run(TR, "phi35_train_psgf", PHI, depth, flash_ops, ssm_ops,
                         estimates[depth], True, log_every=4, **PHI_PSGF)
    hist = psgf["history"]
    n_params = spec_num_params(decoder.model_spec(cfg))
    want_bytes = gate_bytes_from_keys(cfg, hist["sync_keys"], pods, 0.3, 0.2, 0.5)
    if (hist["wire_bytes"] != want_bytes
            or len(want_bytes) != steps // PHI_PSGF["sync_interval"]
            or not 0 < hist["psgf_bytes"] < hist["full_bytes"]
            or hist["full_bytes"] != 2.0 * pods * n_params * 4 * len(want_bytes)):
        raise RuntimeError(f"phi3.5-moe PSGF bytes {hist['wire_bytes']} (from the "
                           f"gates {want_bytes}), total {hist['psgf_bytes']} vs "
                           f"full {hist['full_bytes']}")
    want = depth * (2 if cfg.remat else 1) * steps * pods
    if psgf["flash_route_launches"] != {"scalar": 0, "short": 0, "tensor_core": want}:
        raise RuntimeError(f"phi3.5-moe PSGF flash launches "
                           f"{psgf['flash_route_launches']} (want {want} tensor-core)")
    launches += psgf["flash_launches"]
    psgf.update(per_step(psgf, steps, pods))
    psgf["tokens_per_s"] = (pods * PHI_PSGF["batch"] * PHI_PSGF["seq"]
                            / (psgf["warm_ms_per_step"] / 1e3))
    psgf["ms_per_sync"] = [t * 1e3 for t in hist["sync_s"]]
    psgf["psgf_over_full_bytes"] = hist["psgf_bytes"] / hist["full_bytes"]
    psgf["wire_bytes"] = hist["wire_bytes"]
    training["phi35_train_psgf"] = {
        **{k: v for k, v in psgf.items() if k != "history"}, "layers": depth,
        "params": n_params, "estimates_by_depth": estimates, "config": PHI_PSGF}
    log(json.dumps({"moe_vlm_train": {"phi35_train_psgf":
                                      training["phi35_train_psgf"], "card": card}}))

    full = DEEPSEEK_FULL_ESTIMATE
    deepseek_full = peak_estimate(DR, cut_config(DEEPSEEK, full["layers"]),
                                  full["batch"], full["seq"])
    if deepseek_full <= 80e9:
        raise RuntimeError(f"deepseek-v2 at {full}: the dry run estimates "
                           f"{deepseek_full / 1e9:.1f} GB, which would fit the card")
    reduced = {}
    for arch, seq in MOE_VLM_REDUCED:
        free_device_memory()
        reduced[f"{arch}@{seq}"] = moe_vlm_training_card_vs_cpu(TR, layers, arch, seq)
    return {"card": card, "activations": "bfloat16",
            "weights": "float32 from PRNGKey(0)", "training": training,
            "deepseek_full_width_estimate": {**full, "peak_bytes": deepseek_full},
            "reduced_training_card_vs_cpu": reduced,
            "flash_tensor_core": kernel, "flash_launches_training": launches}


# ---------------------------------------------------------------------------
# Phase 14: the sharded steps' collectives
# ---------------------------------------------------------------------------

# (a) qwen2-1.5b at full width, phase 9's `train` shape, over the (1, 1) host
# mesh as DTensors beside the plain step: (batch, seq, steps); the first
# step warms up, the median of the other three is the warm ms per step
SHARDED_TRAIN = dict(batch=4, seq=2048, steps=4)
# the sharded step against the plain one: the same ops on the same shards
# (every placement of a one-card mesh is whole), so any difference is the
# order of a reduction; 1e-5 on losses ~10
SHARDED_LOSS_TOL = 1e-5
# (b) accounted on this machine's CPU in a fake process group: the
# reference's perf_iters pair B (qwen2-72b on two pods) and the MoE's
# all-to-all path (phi3.5-moe on one pod), both train_4k at full width,
# per device; then benchmarks/psgf_dp_comm.py's table, qwen2-1.5b's bf16
# param tree on (2, 2, 2) over ("pod", "data", "model"), pods of 4 ranks;
# then (a)'s two steps on a (1, 1) mesh: the SHARDED_TRAIN step and a
# prefill of the same batch and length, whose per-device peaks (a) holds
# against the card's
SHARDED_PREFILL = dict(batch=4, seq=2048)
# the dry run's peak against the card's (PERF.md section 2): the train
# step's within 2% (a qwen2-1.5b train step on one card has come within
# 0.2% of its estimate), the prefill's within 5% (3.9 GB, where the CUDA
# allocator's 512-byte rounding and cuBLAS's workspace weigh more)
TRAIN_PEAK_RTOL = 0.02
PREFILL_PEAK_RTOL = 0.05
ACCOUNTED = (("qwen2-72b", "train_4k", True),
             ("phi3.5-moe-42b-a6.6b", "train_4k", False))
PSGF_COMM_SHARES = (0.5, 0.3, 0.2)
PSGF_COMM_FORWARD = 0.2
PSGF_COMM_DRAWS = range(5)
PSGF_LOCAL_STEP = dict(pods=2, batch=2, seq=64)
COLLECTIVES_TIMEOUT_S = 900


def sharded_train_child(workdir: str) -> dict:
    """Phase 14 (a), ``chip_smoke.py --collectives-child card DIR``: a real
    one-rank NCCL group on ``cuda:0`` and ``make_host_mesh(device="cuda")`` as a
    (1, 1) ``DeviceMesh``; qwen2-1.5b's plain ``train`` step and the same
    step built with ``mesh=`` over DTensors laid out by the train rules,
    each ``SHARDED_TRAIN["steps"]`` steps from params drawn from
    ``PRNGKey(0)`` (the same bits both times), run in turn with the first's
    state moved to the host before the second starts."""
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    import torch.distributed as dist

    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as M
    from repro_torch.launch.api import distribute_structs
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step, sharded_train_inputs
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import Adam, one_cycle
    from repro_torch.sharding.rules import make_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        workdir, "store"), rank=0, world_size=1)
    cfg = get_config("qwen2-1.5b")
    B, S, steps = (SHARDED_TRAIN[k] for k in ("batch", "seq", "steps"))
    host = M.make_host_mesh(device="cuda")
    dm = M.device_mesh(host, "cuda")
    optimizer = Adam(lr=one_cycle(3e-4, steps))
    out, finals = {}, {}
    for name, mesh in (("plain", None), ("sharded", dm)):
        free_device_memory()
        # the step's own peak: less what was allocated before its inputs
        # were made, from the peak's reset once they are (the init's own
        # temporaries are not the step's)
        base = torch.cuda.memory_allocated()
        fn, api, _ = build_train_step(cfg, optimizer, "cuda", mesh=mesh)
        params = api.init_params(R.PRNGKey(0))
        state = optimizer.init(params)
        if mesh is not None:
            p_st, o_st, b_st = sharded_train_inputs(
                cfg, InputShape("train", S, B, "train"), make_rules(host, "train"),
                optimizer)
            params = distribute_structs(p_st, dm, params)
            state = distribute_structs(o_st, dm, state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_ops.reset_launch_counts()
        losses, step_ms, records = [], [], []
        for step in range(steps):
            batch = make_batch(cfg, step, B, S, "cuda")
            if mesh is not None:
                batch = distribute_structs(b_st, dm, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cost.counting_collectives() as got:
                # the metrics alone: the params and moments stay bound to
                # params and state, and no other name keeps them past the run
                metrics = fn(params, state, batch)[2]
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if mesh is not None else loss)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            records += got
            losses.append(loss)
        out[name] = {"losses": losses, "ms_per_step": step_ms,
                     "warm_ms_per_step": statistics.median(step_ms[1:]),
                     "flash_route_launches": dict(flash_ops.ROUTE_LAUNCHES),
                     "flash_launches": flash_ops.LAUNCHES,
                     "collectives": cost.summarize_collectives(records),
                     "base_memory_bytes": base,
                     "peak_own_bytes": torch.cuda.max_memory_allocated() - base}
        leaves = pt.flatten_with_paths(params)
        if mesh is None:
            finals = {p: x.cpu() for p, x in leaves}
        else:
            out["max_abs_param_delta"] = max(
                float((x.full_tensor() - finals[p].cuda()).abs().max())
                for p, x in leaves)
        del params, state, leaves
    out["prefill"] = sharded_prefill(cfg, host, dm, flash_ops)
    dist.destroy_process_group()
    return out


def sharded_prefill(cfg, host, dm, flash_ops) -> dict:
    """Phase 14 (a)'s prefill: qwen2-1.5b's bf16 params (drawn from
    ``PRNGKey(0)`` in float32, then cast) and a SHARDED_PREFILL batch of
    ``make_batch``'s tokens as DTensors on the (1, 1) mesh, laid out by the
    serve rules; one prefill under ``no_grad``, its own peak measured as
    the train step's is."""
    from repro_torch import random as R
    from repro_torch.common import pytree_utils as pt
    from repro_torch.launch.api import distribute_structs
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_prefill_step, sharded_serve_inputs
    from repro_torch.launch.train import make_batch

    B, S = SHARDED_PREFILL["batch"], SHARDED_PREFILL["seq"]
    free_device_memory()
    base = torch.cuda.memory_allocated()
    fn, api, rules = build_prefill_step(cfg, "cuda", mesh=dm)
    params = pt.tree_map(lambda x: x.to(torch.bfloat16), api.init_params(R.PRNGKey(0)))
    p_st, b_st = sharded_serve_inputs(cfg, InputShape("prefill", S, B, "prefill"), rules)
    params = distribute_structs(p_st, dm, params)
    batch = distribute_structs(b_st, dm, {"tokens": make_batch(cfg, 0, B, S, "cuda")["tokens"]})
    free_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = fn(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    logits = logits.full_tensor()
    return {"base_memory_bytes": base,
            "peak_own_bytes": torch.cuda.max_memory_allocated() - base,
            "ms_first_call": ms, "logits_shape": list(logits.shape),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "flash_route_launches": dict(flash_ops.ROUTE_LAUNCHES)}


def accounting_child() -> dict:
    """Phase 14 (b), ``chip_smoke.py --collectives-child accounting``: on
    this machine's CPU, every tensor on ``meta``, in the dry run's fake
    process group (``launch.dryrun.accounting_mesh``): ``account_combo`` of
    each ``ACCOUNTED`` combo with its ``collectives``; then
    ``benchmarks/psgf_dp_comm.py``'s table as the port computes it, each
    sync's ``collective_bytes(pod_size=4)`` beside the wire bytes of its
    formula, and PSGF-DP's local step on the same mesh."""
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    from repro_torch.common import pytree_utils as pt
    from repro_torch.configs import get_config
    from repro_torch.core import psgf_dp as P
    from repro_torch.launch import cost
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.api import ModelApi, input_structs
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.optim import Adam

    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, shape_variant

    out = {"combos": {}}
    for arch, shape, multi in ACCOUNTED:
        t0 = time.perf_counter()
        rec = DR.account_combo(arch, shape, multi)
        coll = rec.get("collectives", {})
        if "error" in coll or rec["status"] != "ok":
            raise RuntimeError(f"{arch} x {shape}: {rec.get('status')} "
                               f"{coll.get('error')}")
        seconds = time.perf_counter() - t0
        # one layer once more under torch's own counter: the same ops
        one = dataclasses.replace(shape_variant(get_config(arch), SHAPES[shape]),
                                  num_layers=1)
        with CommDebugMode() as comm:
            mine = DR.step_collectives(one, SHAPES[shape],
                                       make_production_mesh(multi_pod=multi))["count"]
        theirs = sum(comm.get_comm_counts().values())
        if mine != theirs:
            raise RuntimeError(f"{arch}: {mine} collectives counted at one layer, "
                               f"CommDebugMode saw {theirs}")
        memory = rec["memory"]
        out["combos"][f"{arch}__{shape}__{rec['mesh']}"] = {
            "mesh_shape": rec["mesh_shape"], "collectives": coll,
            "count_one_layer": mine, "comm_debug_mode_one_layer": theirs,
            "memory": {k: v for k, v in memory.items() if k != "argument_bytes"},
            "cost": rec["cost"], "roofline": rec["roofline"],
            "extrapolated": "extrapolated" in rec, "seconds": seconds}

    t0 = time.perf_counter()
    mesh = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    dm = DR.accounting_mesh(mesh)
    cfg = get_config("qwen2-1.5b")
    api = ModelApi(cfg, "meta")
    tree = api.abstract_params(torch.bfloat16)
    pods = 2
    local = P.stack_for_pods(tree, pods, dm)
    glob = P.on_mesh(tree, dm)
    leaf_bytes = [x.numel() * x.element_size() for x in pt.leaves(tree)]
    table = {}
    _, _, stats = P.full_sync(local, pods)
    full = cost.collective_bytes(P.full_sync, local, pods, pod_size=4)
    if full["all-reduce"] != 2 * sum(leaf_bytes) or full["cross_pod"] != full["total"]:
        raise RuntimeError(f"full_sync collectives {full}, leaves {sum(leaf_bytes)} B")
    table["full_sync"] = {"collectives": full, "wire_bytes": stats["wire_bytes"]}
    for share in PSGF_COMM_SHARES:
        rng = np.random.default_rng(SEED)
        s_gates = P.sample_static_gates(rng, tree, share)
        f_gates = P.sample_static_gates(rng, tree, PSGF_COMM_FORWARD)
        selected = (True, False)
        _, _, stats = P.psgf_sync_static(local, glob, s_gates, f_gates, selected)
        got = cost.collective_bytes(P.psgf_sync_static, local, glob, s_gates,
                                    f_gates, selected, pod_size=4)
        shared = sum(b for b, g in zip(leaf_bytes, pt.leaves(s_gates)) if g)
        if (got.get("all-reduce", 0) != 2 * shared or got["total"] != 2 * shared
                or got["cross_pod"] != got["total"]):
            raise RuntimeError(f"psgf_sync_static at {share}: {got}, shared "
                               f"leaves {shared} B")
        # the benchmark's mean over its five mask draws (seeds 0-4): the
        # embedding is ~15% of this model's bytes, so one draw is coarse
        draws = []
        for seed in PSGF_COMM_DRAWS:
            rng = np.random.default_rng(seed)
            sg = P.sample_static_gates(rng, tree, share)
            fg = P.sample_static_gates(rng, tree, PSGF_COMM_FORWARD)
            draws.append(cost.collective_bytes(P.psgf_sync_static, local, glob, sg,
                                               fg, selected, pod_size=4)["total"])
        table[f"psgf_r{int(share * 100)}"] = {
            "collectives": got, "wire_bytes": stats["wire_bytes"],
            "shared_leaves": sum(map(bool, pt.leaves(s_gates))),
            "forwarded_leaves": sum(map(bool, pt.leaves(f_gates))),
            "fraction_of_full": got["total"] / full["total"],
            "draws_total": draws,
            "draws_mean_fraction_of_full": statistics.mean(draws) / full["total"]}
    # the local step: every rank's pods on its own shard, no collective
    n, b, sq = (PSGF_LOCAL_STEP[k] for k in ("pods", "batch", "seq"))
    params = P.stack_for_pods(api.abstract_params(), n, dm)
    optimizer = Adam(lr=lambda t: 1e-4)
    state = P.init_pod_opt_state(optimizer, params)
    batch = P.stack_for_pods(input_structs(cfg, InputShape("local", sq, b, "train")),
                             n, dm)
    step = P.make_local_train_step(api.loss_fn, optimizer, mesh=dm)
    local_step = cost.collective_bytes(step, params, state, batch, pod_size=4)
    if local_step["total"] != 0 or local_step["count"] != 0:
        raise RuntimeError(f"PSGF-DP's local step issued collectives: {local_step}")
    out["psgf_dp_comm"] = {"mesh": dict(mesh.shape), "pod_size": 4,
                           "params": "qwen2-1.5b, bfloat16", "seed": SEED,
                           "forward_ratio": PSGF_COMM_FORWARD, "table": table,
                           "local_step": {**local_step, "config": PSGF_LOCAL_STEP},
                           "seconds": time.perf_counter() - t0}
    out["one_by_one"] = account_one_by_one(DR, cost)
    return out


def account_one_by_one(DR, cost) -> dict:
    """Phase 14 (b)'s estimates of (a)'s steps: qwen2-1.5b's SHARDED_TRAIN
    step (Adam with its 1cycle, float32 moments) and a SHARDED_PREFILL
    prefill (bf16 params) over DTensors on a (1, 1) mesh of the accounting
    group, per device; their FLOPs against the global counts (equal on one
    rank); the plain step's ``one_device_peak`` beside them; the prefill
    counted once more on fake tensors (the dry run counts on meta ones:
    equal, on this torch too)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.optim import Adam, one_cycle

    t0 = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    mesh = AbstractMesh(("data", "model"), (1, 1))
    shapes = {"train": InputShape("train", SHARDED_TRAIN["seq"], SHARDED_TRAIN["batch"],
                                  "train"),
              "prefill": InputShape("prefill", SHARDED_PREFILL["seq"],
                                    SHARDED_PREFILL["batch"], "prefill")}
    optimizer = Adam(lr=one_cycle(3e-4, SHARDED_TRAIN["steps"]))
    out = {}
    for kind, shape in shapes.items():
        rec = DR.account_step(cfg, shape, mesh, optimizer=optimizer)
        if "error" in rec["memory"]:
            raise RuntimeError(f"(1, 1) {kind}: {rec['memory']['error']}")
        if rec["cost"]["flops"] != rec["cost"]["flops_global"]:
            raise RuntimeError(f"(1, 1) {kind}: {rec['cost']['flops']} FLOPs a device, "
                               f"{rec['cost']['flops_global']} in all")
        out[kind] = {"memory": {k: v for k, v in rec["memory"].items()
                                if k != "argument_bytes"},
                     "cost": rec["cost"], "roofline": rec["roofline"]}
    out["train"]["one_device_peak"] = DR.one_device_peak(
        cfg, SHARDED_TRAIN["batch"], SHARDED_TRAIN["seq"])["peak_bytes"]
    fn, args = DR.step_inputs(cfg, shapes["prefill"], mesh)
    with torch.no_grad():
        counts = [cost.account(fn, *args, fake=fake) for fake in (True, False)]
    if counts[0] != counts[1]:
        raise RuntimeError("the prefill's counts on fake and on meta tensors differ: "
                           f"{counts[0]['peak_bytes']} / {counts[1]['peak_bytes']}")
    out["fake_equals_meta"] = True
    out["seconds"] = time.perf_counter() - t0
    return out


def check_peaks(card: dict, estimates: dict) -> dict:
    """(a)'s peaks on the card against (b)'s per-device estimates: one
    line each (estimate, measured, ratio, the card's name and power limit);
    fails the phase where the train step's or the prefill's estimate is
    off by more than TRAIN_PEAK_RTOL / PREFILL_PEAK_RTOL of the measured
    peak. The plain step is reported beside ``one_device_peak``."""
    info = card_info()
    rows = {"sharded_train": (card["sharded"], estimates["train"]["memory"]["peak_bytes"],
                              TRAIN_PEAK_RTOL),
            "prefill": (card["prefill"], estimates["prefill"]["memory"]["peak_bytes"],
                        PREFILL_PEAK_RTOL),
            "plain_train": (card["plain"], estimates["train"]["one_device_peak"], None)}
    out, off = {}, []
    for name, (run, estimate, rtol) in rows.items():
        measured = run["peak_own_bytes"]
        ratio = estimate / measured
        log(f"phase 14 peak {name}: estimate {estimate / 1e9:.4f} GB, measured "
            f"{measured / 1e9:.4f} GB, estimate / measured {ratio:.5f} ({info}; "
            f"{run['base_memory_bytes'] / 1e9:.4f} GB allocated before)")
        out[name] = {"estimate_bytes": estimate, "measured_bytes": measured,
                     "estimate_over_measured": ratio, "rtol": rtol}
        if rtol is not None and abs(ratio - 1) > rtol:
            off.append(f"{name}: estimate {estimate} B against {measured} B "
                       f"measured, beyond {rtol}")
    if off:
        raise RuntimeError("phase 14 peaks: " + "; ".join(off))
    return out


def start_collectives_child(kind: str) -> tuple:
    """Start ``--collectives-child KIND`` (``card`` or ``accounting``) in a
    fresh interpreter of this script, its output into files of phase 14's
    working directory (files, not pipes: a child that filled a pipe would
    wait for this process to read it). Returns ``(process, stdout,
    stderr)`` for :func:`finish_collectives_child`."""
    workdir = os.path.join(ROOT, "build", "chip_smoke_collectives")
    if kind == "accounting":                   # the first of the two
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
    files = [open(os.path.join(workdir, f"{kind}.{ext}"), "w+")
             for ext in ("out", "err")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--collectives-child",
         kind, workdir], env=env, stdout=files[0], stderr=files[1], text=True)
    return proc, *files


def finish_collectives_child(kind: str, started: tuple) -> dict:
    """Wait for a child of :func:`start_collectives_child` (killing it past
    ``COLLECTIVES_TIMEOUT_S``), relay the end of its stderr; its report."""
    proc, out, err = started
    try:
        proc.wait(timeout=COLLECTIVES_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    for line in stderr.splitlines()[-12:]:
        log(f"  [{kind}] {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"phase 14 {kind} child exited {proc.returncode}")
    return json.loads(stdout.strip().splitlines()[-1])


def drive_collectives(accounting: tuple) -> dict:
    """Phase 14: (b), started with phase 13 (``accounting``, from
    :func:`start_collectives_child`: on the CPU, beside phase 13's runs on
    the card), then (a), each in a fresh interpreter of this script
    (``--collectives-child``), so that neither process group meets another
    one or phase 10's, and (a)'s times are taken alone; returns both
    reports and checks (a): the sharded step's losses within
    SHARDED_LOSS_TOL of the plain step's, the same tensor-core flash
    launches (two a layer and step, the forward and its remat recompute),
    no collective bytes."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    reports = {"accounting": finish_collectives_child("accounting", accounting)}
    # then the card child, with no CPU-heavy accounting beside it
    reports["card"] = finish_collectives_child(
        "card", start_collectives_child("card"))
    card = reports["card"]
    plain, sharded = card["plain"], card["sharded"]
    cfg = get_config("qwen2-1.5b")
    want = cfg.num_layers * (2 if cfg.remat else 1) * SHARDED_TRAIN["steps"]
    delta = max(abs(a - b) for a, b in zip(plain["losses"], sharded["losses"]))
    if not (all(math.isfinite(x) for x in sharded["losses"])
            and delta <= SHARDED_LOSS_TOL):
        raise RuntimeError(f"sharded step losses {sharded['losses']} vs plain "
                           f"{plain['losses']}")
    for name, run in (("plain", plain), ("sharded", sharded)):
        if run["flash_route_launches"] != {"scalar": 0, "short": 0,
                                           "tensor_core": want}:
            raise RuntimeError(f"{name} step flash launches "
                               f"{run['flash_route_launches']} (want {want})")
    if sharded["collectives"]["total"] != 0:
        raise RuntimeError(f"the (1, 1) mesh's step sent bytes: "
                           f"{sharded['collectives']}")
    card["max_abs_loss_delta"] = delta
    prefill = card["prefill"]
    if not prefill["logits_finite"] or prefill["flash_route_launches"] != {
            "scalar": 0, "short": 0, "tensor_core": cfg.num_layers}:
        raise RuntimeError(f"the (1, 1) prefill: {prefill}")
    card["peaks"] = check_peaks(card, reports["accounting"]["one_by_one"])
    return {"card": card_info(), "sharded_train": card,
            "accounting": reports["accounting"],
            "flash_launches": sharded["flash_launches"],
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 15: a local mesh, several shards of one process
# ---------------------------------------------------------------------------

LOCAL_SERVE_REQUESTS = 256  # phase 15 (2): as phase 4, 3 channels each


def mesh_launches(launches, captured, run) -> dict:
    """A ``MeshRun``'s kernel launches: the counts read after it
    (``launches``, every eager call) plus, for a while run, each captured
    segment's calls (``counting_captures``: every shard's four segments in
    order) times its replays past the capture."""
    from repro_torch.core.fl.partition import MeshRun

    segments = MeshRun.SEGMENTS
    launches = dict(launches)
    for i, (_, calls) in enumerate(captured):
        name = segments[i % len(segments)]
        for k in launches:
            launches[k] += calls[k] * (run["replays"][name] - 1)
    return launches


def local_mesh_fl(E, R, mix_ops, flash_ops, devices, want) -> dict:
    """Phase 15 (1) over ``devices``: phase 10's nn5 cell (its inputs from
    phase 10's workdir) with ``client_mesh=Mesh("clients", devices)``, the
    ``scan`` and the ``while`` driver, each run twice (the second warm),
    every kernel count set to 0 just before each run and read after it (a
    while run's launches are each captured segment's calls times its
    replays, plus the eager first round); each run's digest must equal
    ``want`` (phase 10's one-process scan run) bit for bit."""
    from repro_torch.launch.distributed import block_range
    from repro_torch.launch.mesh import Mesh

    _, model, _, _, fl, kw = host_cell(E, data=False)
    z = np.load(os.path.join(ROOT, "build", "chip_smoke_distributed",
                             "inputs.npz"))
    tr, te = z["train"], z["test"]
    blocks = [block_range(HOST_K, i, DIST_PROCESSES)
              for i in range(DIST_PROCESSES)]
    mesh = Mesh("clients", devices)
    cards = sorted(set(devices), key=str)
    counts = lambda: {"psgf_mix_batch": mix_ops.LAUNCHES,  # noqa: E731
                      "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}
    out = {}
    for driver in ("scan", "while"):
        runs = []
        for _ in range(2):
            free_device_memory()
            for d in cards:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
            mix_ops.LAUNCHES = 0               # every kernel count, just before
            flash_ops.reset_launch_counts()
            with counting_captures(E, counts) as captured:
                t0 = time.perf_counter()
                h = E.run_fl(model.cfg, fl, tr, te, R.PRNGKey(SEED),
                             driver=driver, device=devices[0],
                             client_mesh=mesh, **kw)
                wall = time.perf_counter() - t0
            run = h["mesh_run"]
            launches = mesh_launches(counts(), captured, run)   # ... and after
            digest = run_digest(h, blocks)
            same = {k: digest[k] == want[k] for k in want}
            if not all(same.values()):
                raise RuntimeError(f"local mesh {driver} over {devices} != "
                                   f"the one-process scan run: {same}")
            if not (run["sharded"] and run["shards"] == len(devices)):
                raise RuntimeError(f"local mesh {driver}: {run}")
            if not all(launches.values()):
                raise RuntimeError(f"local mesh {driver}: a kernel never "
                                   f"launched: {launches}")
            ex, rounds = h["exchange"], h["rounds_run"]
            runs.append({
                "run_s": wall, "ms_per_round": 1e3 * wall / rounds,
                "rounds": rounds, "warmup_s": run["warmup_s"],
                "capture_s": run["capture_s"],
                # a while run's rounds after its eager first one and the
                # capture (the end-of-chunk evaluations included)
                "ms_per_replayed_round": (
                    1e3 * (run["run_s"] - run["warmup_s"] - run["capture_s"])
                    / (rounds - 1) if run["graphs"] else None),
                "graphs_per_shard": run["graphs"], "replays": run["replays"],
                "peak_device_bytes": max(torch.cuda.max_memory_allocated(d)
                                         for d in cards),
                "launches": launches,
                "merge": {"bytes": ex["merge"]["bytes"], "s": ex["merge"]["s"]},
                "gather": {"bytes": ex["gather"]["bytes"],
                           "s": ex["gather"]["s"]}})
            del h
        out[driver] = {"cold": runs[0], "warm": runs[1], "bitwise": same}
        log(f"phase 15 {driver} over {[str(d) for d in devices]}: "
            f"{runs[1]['ms_per_round']:.1f} ms a round of the warm run "
            f"({runs[1]['ms_per_replayed_round']} replayed), launches "
            f"{runs[1]['launches']}")
    return out


def local_mesh_serving(flash_ops, devices) -> dict:
    """Phase 15 (2) over ``devices``: phase 5's generation-0 manifest served
    by a plain server and by ``shard_batch=True`` over a batch mesh of
    ``devices`` (``launch.mesh.make_batch_mesh`` patched): a full bucket of
    each cluster, each block bitwise the plain server's forward of that
    block and the bucket within ``SERVE_TOL`` of the plain server's; the
    same traffic through both servers' queues; one ``reload``."""
    from repro_torch.core.tasks import (read_routing_manifest,
                                        update_routing_manifest)
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve_forecast import (ForecastServer,
                                                   serve_requests)

    root = os.path.join(ROOT, "build", "chip_smoke_local_mesh")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "build", "chip_smoke_train"), root)
    kw = dict(denormalize=True, device=devices[0], max_batch=32)
    plain = ForecastServer.from_manifest(root, **kw)
    with patched(M, "make_batch_mesh",
                 lambda axis="batch", device=None: M.Mesh(axis, devices)):
        sharded = ForecastServer.from_manifest(root, shard_batch=True, **kw)
    n = len(devices)

    def check_bucket(x, cluster, plain_cluster):
        got = sharded.predict(x, cluster=cluster)
        want = plain.predict(x, cluster=plain_cluster)
        block = x.shape[0] // n
        blocks = [bool(np.array_equal(
            got[i * block:(i + 1) * block],
            plain.predict(x[i * block:(i + 1) * block], cluster=plain_cluster)))
            for i in range(n)]
        err = float(np.max(np.abs(got - want)))
        if not (all(blocks) and np.isfinite(got).all()
                and np.allclose(got, want, atol=SERVE_TOL, rtol=SERVE_TOL)):
            raise RuntimeError(f"sharded bucket of cluster {cluster}: blocks "
                               f"{blocks}, max |err| {err}")
        return {"blocks_bitwise": blocks, "max_abs_err": err,
                "bucket_bitwise": bool(np.array_equal(got, want))}

    L = plain.forecaster.cfg.look_back
    x = np.random.default_rng(SEED).standard_normal(
        (32, 3, L)).astype(np.float32)
    buckets = {c: check_bucket(x, c, c) for c in sorted(plain.engines)}
    if not np.array_equal(sharded.predict(x[:1], cluster=0),
                          plain.predict(x[:1], cluster=0)):
        raise RuntimeError("a bucket of 1 on the sharded server differs")
    traffic = {}
    for name, server in (("plain", plain), ("sharded", sharded)):
        server.warmup(channels=3)
        for d in set(devices):
            torch.cuda.synchronize(d)
        flash_ops.reset_launch_counts()        # every kernel count, just before
        rep = serve_requests(server, LOCAL_SERVE_REQUESTS, 3,
                             stations=server.routable_stations())
        for d in set(devices):
            torch.cuda.synchronize(d)
        launches = flash_ops.ROUTE_LAUNCHES["short"]   # ... and just after
        if launches < rep["batches"] or flash_ops.LAUNCHES != launches:
            raise RuntimeError(f"{name} server: {flash_ops.ROUTE_LAUNCHES} "
                               f"flash launches for {rep['batches']} batches")
        latency = latency_quantiles(server)
        traffic[name] = {"forecasts_per_sec": rep["forecasts_per_sec"],
                         "latency_s_p50": latency[0.5],
                         "latency_s_p99": latency[0.99],
                         "batches": rep["batches"], "flash_short": launches}
    policy, mapping = next(iter(read_routing_manifest(root)[1]["policies"]
                                .items()))
    gen, _ = update_routing_manifest(root, policy, {0: mapping["1"]})
    if not sharded.reload() or sharded.generation != gen:
        raise RuntimeError("the sharded server did not reload")
    engine = sharded.engines[0]
    shards_built = sorted({k[2] if len(k) == 3 else 0 for k in engine._free})
    if len(engine.shards) != n or shards_built != list(range(n)):
        raise RuntimeError(f"reload built shards {shards_built} of {n}")
    reloaded = check_bucket(x, 0, 1)           # cluster 1's checkpoint now
    for server in (plain, sharded):
        server.close()
    return {"devices": [str(d) for d in devices], "buckets": buckets,
            "traffic": traffic, "reload": {"generation": gen,
                                           "shards_built": shards_built,
                                           **reloaded}}


def drive_local_mesh(mix_ops, flash_ops, want, one_process) -> dict:
    """Phase 15: the client axis and serving's batch axis over a local mesh
    of two shards of ``cuda:0`` (each on its own stream), then over
    ``cuda:0`` and ``cuda:1`` where the machine has two GPUs. ``want`` and
    ``one_process`` are phase 10's one-process scan run's digest and
    record."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E

    t0 = time.perf_counter()
    card = torch.device("cuda", 0)
    meshes = [(card, card)]
    if torch.cuda.device_count() > 1:
        meshes.append((card, torch.device("cuda", 1)))
    else:
        log("phase 15: no run across distinct GPUs was made: "
            f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    out = {"card": card_info(), "runs": [],
           "one_process_scan_ms_per_round":
               1e3 * one_process["run_s"] / HOST_ROUNDS}
    for devices in meshes:
        free_device_memory()
        out["runs"].append({"devices": [str(d) for d in devices],
                            "fl": local_mesh_fl(E, R, mix_ops, flash_ops,
                                                devices, want),
                            "serving": local_mesh_serving(flash_ops, devices)})
    out["distinct_gpus"] = len(meshes) > 1
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 16: one process a GPU
# ---------------------------------------------------------------------------

# (a) / (b): qwen2-1.5b at published widths and full depth (28 layers), the
# plain trainer and server in this process against ``launch.train`` /
# ``launch.serve``'s ``main`` in the children that ``--processes N`` starts
# (``distributed.launch_processes``): each joins its NCCL group, one GPU a
# rank, and runs on the host mesh over it
HOST_MESH_TRAIN = dict(steps=3, batch=4, seq=2048)
HOST_MESH_SERVE = dict(batch=4, prompt_len=2048, gen=16)
HOST_MESH_ARGV = {
    "train": ["--arch", "qwen2-1.5b", "--full", "--device", "cuda",
              "--steps", "3", "--batch", "4", "--seq", "2048"],
    "serve": ["--arch", "qwen2-1.5b", "--no-reduced", "--device", "cuda",
              "--batch", "4", "--prompt-len", "2048", "--gen", "16"]}
# (c): phase 10's nn5 cell over two gloo processes on this card, each with a
# client mesh of two shards of cuda:0 (four shards of 64 cohort rows, the
# client chunk). Memory, reckoned first: two shards of one process peaked at
# 22.81 GB with all 2,048 rows (PR 26); a process here holds half of them
# (3.4 GB less of w, m and v) and its process-level transport in host
# memory, so two processes take ~39 GB of the 80 beside this one's
# leftovers: K stays 2,048, no cut beyond phase 10's
HYBRID_PROCESSES, HYBRID_SHARDS = 2, 2
# where the machine has several GPUs: (a), (b) and (c) once more, one
# process a GPU over NCCL
HOST_MESH_GPUS = 2
HOST_MESH_TIMEOUT_S = 600
# across GPUs the batch is split over "data": the first step's loss and the
# prefill's logits are held to the plain run's within what splitting the
# batch in two moves them on this card (split_readings), plus the two-rank
# CPU test's 1e-6 relative for the order of the mean
SPLIT_RTOL = 1e-6


def spawn_children(D, n, args, workdir) -> list:
    """``n`` fresh interpreters of this script with ``args``, one group
    (a file store in ``workdir``); their JSON reports (last stdout line)."""
    procs = D.spawn_processes(
        n, [sys.executable, os.path.abspath(__file__), *args],
        env=D.child_env(), timeout=HOST_MESH_TIMEOUT_S,
        coordinator="file://" + os.path.join(workdir, f"store_{time.time_ns()}"))
    reports = []
    for i, r in enumerate(procs):
        if r.returncode != 0:
            at = max(r.stderr.rfind("Traceback"), 0)    # an error's message
            log(f"--- {args[0]} child {i} stderr ---\n{r.stderr[at:at + 4000]}"  # may be long
                f"\n...\n{r.stderr[-2000:]}")
            raise RuntimeError(f"{args[0]} child {i} exited {r.returncode}")
        reports.append(json.loads(r.stdout.strip().splitlines()[-1]))
    return reports


def zoo_part(part: str, call, flash_ops) -> dict:
    """``call(history)``, ``launch.train.train`` or ``launch.serve.serve``
    of qwen2-1.5b at full width (``part``), with flash's counts set to 0
    just before and read just after; its own peak (less what was allocated
    before it) and times; a serve's ``logits`` stay a tensor."""
    dev = torch.device("cuda", torch.cuda.current_device())
    free_device_memory()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    flash_ops.reset_launch_counts()
    hist = {}
    t0 = time.perf_counter()
    got = call(hist)
    torch.cuda.synchronize(dev)
    out = {"wall_s": time.perf_counter() - t0,
           "peak_own_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "base_memory_bytes": base, "flash_launches": flash_ops.LAUNCHES,
           "flash_route_launches": dict(flash_ops.ROUTE_LAUNCHES)}
    if part == "train":
        # finite; not "falling" as check_losses asks: over 3 steps the 1cycle
        # schedule peaks at step 2, where the loss rises (phase 9's step 2
        # too); what this phase holds is the mesh run's losses equal to the
        # plain one's
        if not all(math.isfinite(x) for x in got):
            raise RuntimeError(f"phase 16 train: losses {got} not finite")
        out.update(losses=got, ms_per_step=[1e3 * x for x in hist["step_s"]],
                   warm_ms_per_step=1e3 * statistics.median(hist["step_s"][1:]))
    else:
        out.update(tokens=got["tokens"].tolist(), logits=got["logits"],
                   **{k: got[k] for k in ("init_s", "prefill_ms",
                                          "decode_ms_per_token")})
    free_device_memory()
    return out


def host_mesh_child(part: str, workdir: str) -> None:
    """Phase 16 (a) or (b) in one child of ``--processes N`` (``python -m
    chip_smoke --host-mesh-child PART DIR``, started by
    ``distributed.launch_processes``): ``launch.train.main`` or
    ``launch.serve.main`` with the phase's flags, which joins the group
    (NCCL, one GPU a rank) and runs on the host mesh over it. The entry
    point that ``main`` calls is measured where it is called, inside the
    group (``zoo_part``). Writes ``PART_RANK.json`` and a serve's logits
    (``logits_RANK.pt``) into ``DIR``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import distributed as D
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module = TR if part == "train" else SV
    entry, report = getattr(module, part), {}

    def measured(*args, **kw):
        got = []

        def call(hist):
            if part == "train":
                kw["history"] = hist
            got.append(entry(*args, **kw))
            return got[0]
        report.update(zoo_part(part, call, flash_ops),
                      process=D.process_index(), processes=D.process_count(),
                      backend=D.backend(), device=str(D.device()),
                      mesh=list(make_host_mesh(device="cuda").axis_sizes))
        return got[0]

    setattr(module, part, measured)
    module.main(HOST_MESH_ARGV[part])
    rank = report["process"]
    if part == "serve":
        torch.save(report.pop("logits"),
                   os.path.join(workdir, f"logits_{rank}.pt"))
    with open(os.path.join(workdir, f"{part}_{rank}.json"), "w") as f:
        json.dump(report, f)


def launch_zoo(D, n: int, workdir: str) -> list:
    """(a) and (b) as ``--processes n`` runs them: ``launch_processes``
    starts ``n`` children of this script (``host_mesh_child``), each part
    in a group of its own; every rank's ``{"train", "serve"}``."""
    os.chdir(ROOT)                        # python -m chip_smoke
    workdir = os.path.join(workdir, f"zoo_{n}")
    os.makedirs(workdir)
    for part in ("train", "serve"):
        code = D.launch_processes(n, "chip_smoke",
                                  ["--host-mesh-child", part, workdir], "cuda")
        if code:
            raise RuntimeError(f"phase 16 {part} over {n} process(es) "
                               f"exited {code}")
    ranks = []
    for i in range(n):
        rank = {}
        for part in ("train", "serve"):
            with open(os.path.join(workdir, f"{part}_{i}.json")) as f:
                rank[part] = json.load(f)
            got = [rank[part][k] for k in ("backend", "processes", "process", "mesh")]
            if got != ["nccl", n, i, [n, 1]]:
                raise RuntimeError(f"phase 16 {part} rank {i}: backend, "
                                   f"processes, rank, mesh {got}")
        rank["serve"]["logits"] = torch.load(
            os.path.join(workdir, f"logits_{i}.pt"))
        ranks.append(rank)
    return ranks


def split_readings(TR) -> dict:
    """What splitting the batch in two moves on this card, in the plain
    steps at phase 16's shapes and weights (``PRNGKey(0)``): the first
    step's loss (whole batch against the mean of its halves') and the
    prefill's last-position logits (max abs)."""
    from repro_torch import random as R
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.launch.steps import build_prefill_step, build_train_step

    dev = torch.device("cuda", 0)
    cfg = TR._config("qwen2-1.5b", reduced=False)
    fn, api, _ = build_train_step(cfg, None, dev)
    params = api.init_params(R.PRNGKey(0))
    batch = TR.make_batch(cfg, 0, HOST_MESH_TRAIN["batch"],
                          HOST_MESH_TRAIN["seq"], dev)
    half = HOST_MESH_TRAIN["batch"] // 2

    def loss(rows):
        return float(fn.gradients(params, {k: v[rows] for k, v in batch.items()})[1]["loss"])
    whole = loss(slice(None))
    split = (loss(slice(0, half)) + loss(slice(half, None))) / 2
    prefill, _, _ = build_prefill_step(cfg, dev)
    B, P, G = (HOST_MESH_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    toks = torch.from_numpy(synthetic_tokens(0, B, P, cfg.vocab_size)).to(dev)
    with torch.inference_mode():
        def last(rows):
            return prefill(params, {"tokens": toks[rows]},
                           cache_len=P + G)[0][:, -1].float()
        gap = torch.cat([last(slice(0, half)), last(slice(half, None))]) - last(slice(None))
    out = {"loss": abs(split - whole), "prefill_logits": float(gap.abs().max())}
    del params, batch
    free_device_memory()
    return out


def check_zoo_same(plain, ranks, readings=None) -> dict:
    """The mesh runs (``ranks``, one report each) against the plain run's,
    flash all tensor-core. Every rank returns the same global losses,
    tokens and logits. On one rank (no ``readings``) they equal the plain
    run's bit for bit, the logits of the prefill and of every decode step
    too, with as many launches. Across GPUs (the batch split over
    ``"data"``, bf16 activations) the first step's loss and the prefill's
    logits lie within ``readings`` (``split_readings``) plus SPLIT_RTOL of
    the plain run's; the later steps and the decode, which compound the
    split, are held across the ranks alone."""
    mesh = ranks[0]
    lp, lm = plain["train"]["losses"], mesh["train"]["losses"]
    gp, gm = plain["serve"]["logits"], mesh["serve"]["logits"]
    checks = {"ranks_agree": all(
        r["train"]["losses"] == lm
        and r["serve"]["tokens"] == mesh["serve"]["tokens"]
        and torch.equal(r["serve"]["logits"], gm) for r in ranks)}
    checks["logits_shape"] = gm.shape == gp.shape == (
        HOST_MESH_SERVE["batch"], HOST_MESH_SERVE["gen"] + 1, gp.shape[-1])
    if readings is None:
        checks["losses"] = lp == lm
        checks["tokens"] = plain["serve"]["tokens"] == mesh["serve"]["tokens"]
        checks["logits"] = torch.equal(gp, gm)
    else:
        checks["first_loss"] = (abs(lm[0] - lp[0])
                                <= readings["loss"] + SPLIT_RTOL * abs(lp[0]))
        first = (gm[:, 0].float() - gp[:, 0].float()).abs().max()
        checks["prefill_logits"] = float(first) <= (
            readings["prefill_logits"]
            + SPLIT_RTOL * float(gp[:, 0].float().abs().max()))
    for part in ("train", "serve"):
        routes = mesh[part]["flash_route_launches"]
        checks[f"{part}_tensor_core"] = (
            routes["tensor_core"] == mesh[part]["flash_launches"] > 0)
        if readings is None:
            checks[f"{part}_launches"] = (mesh[part]["flash_launches"]
                                          == plain[part]["flash_launches"])
    if not all(checks.values()):
        raise RuntimeError(f"phase 16 host mesh != the plain run: {checks}")
    return {**checks, "logits_max_abs_err": float(
        (gm.float() - gp.float()).abs().max())}


def without_logits(run) -> dict:
    return {p: {k: v for k, v in run[p].items() if k not in ("tokens", "logits")}
            for p in ("train", "serve")}


def hybrid_child(workdir: str, device: str) -> dict:
    """Phase 16 (c) in one process (``chip_smoke.py --hybrid-child DIR
    DEVICE``): joins the group on ``DEVICE`` (gloo where the processes share
    ``cuda:0``, NCCL where each has a GPU), then phase 10's cell over a
    client mesh of two shards a process, ``scan`` and ``while``, every
    kernel count set to 0 just before each run and read just after."""
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.psgf_mix import ops as mix_ops
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import Mesh, make_client_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not D.initialize_distributed(device=device):
        raise RuntimeError("hybrid child: no process group configured")
    dev = D.device()
    _, model, _, _, fl, kw = host_cell(E, data=False)
    z = np.load(os.path.join(workdir, "inputs.npz"))
    tr, te = z["train"], z["test"]
    # two shards a process: its local GPUs (make_client_mesh(multi_host=True):
    # two where the host has a GPU for each), else its group device twice
    own = make_client_mesh(multi_host=True, device=device).devices
    mesh = Mesh("clients", (own * HYBRID_SHARDS)[:HYBRID_SHARDS],
                D.process_index(), D.process_count(), D.backend())
    counts = lambda: {"psgf_mix_batch": mix_ops.LAUNCHES,  # noqa: E731
                      "flash_short": flash_ops.ROUTE_LAUNCHES["short"]}
    out = {"process": D.process_index(), "backend": D.backend(),
           "device": str(dev), "runs": {}}
    for driver in ("scan", "while"):
        free_device_memory()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        D.sync(driver)                          # both start together
        mix_ops.LAUNCHES = 0
        flash_ops.reset_launch_counts()
        with counting_captures(E, counts) as captured:
            t0 = time.perf_counter()
            h = E.run_fl(model.cfg, fl, tr, te, R.PRNGKey(SEED), driver=driver,
                         device=dev, client_mesh=mesh, **kw)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        run = h["mesh_run"]
        ex, rounds = h["exchange"], h["rounds_run"]
        lo, hi = h["owned_rows"]
        level = lambda e: {k: {"bytes": e[k]["bytes"], "s": e[k]["s"]}  # noqa: E731
                           for k in ("merge", "gather")}
        out["runs"][driver] = {
            "digest": run_digest(h, [(0, hi - lo)]), "owned_rows": [lo, hi],
            "run_s": wall, "ms_per_round": 1e3 * wall / rounds,
            "ms_per_replayed_round": (
                1e3 * (run["run_s"] - run["warmup_s"] - run["capture_s"])
                / (rounds - 1) if run["graphs"] else None),
            "warmup_s": run["warmup_s"], "capture_s": run["capture_s"],
            "mesh_run": {k: run[k] for k in ("processes", "shards", "backend",
                                             "devices", "graphs", "replays")},
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": mesh_launches(counts(), captured, run),
            "local": level(ex), "across": level(ex["across"])}
        del h
    D.sync("done")
    D.shutdown_distributed()
    return out


def check_hybrid(reports, want, blocks, backend) -> dict:
    """Every process's runs bitwise phase 10's one-process scan (``want``),
    on the mesh asked for, every kernel launched."""
    same = {}
    for i, rep in enumerate(reports):
        if rep["backend"] != backend:
            raise RuntimeError(f"hybrid process {i}: backend {rep['backend']}")
        for driver, run in rep["runs"].items():
            got = run["digest"]
            checks = {k: got[k] == want[k] for k in
                      ("losses", "comm", "rmse", "final_rmse", "rounds",
                       "w_global_sha")}
            checks["rows"] = run["owned_rows"] == list(blocks[i])
            checks["w_clients_block_sha"] = (got["w_clients_sha"][0]
                                             == want["w_clients_sha"][i])
            m = run["mesh_run"]
            checks["mesh"] = (m["processes"], m["shards"]) == (
                HYBRID_PROCESSES, HYBRID_SHARDS)
            same[f"process_{i}/{driver}"] = checks
            if not all(checks.values()):
                raise RuntimeError(f"hybrid process {i} {driver} != the "
                                   f"one-process scan: {checks}")
            if not all(run["launches"].values()):
                raise RuntimeError(f"hybrid process {i} {driver}: a kernel "
                                   f"never launched: {run['launches']}")
    return same


def drive_host_mesh(mix_ops, flash_ops, want) -> dict:
    """Phase 16: one process a GPU. (a) and (b) plain in this process, then
    as ``--processes 1`` runs them, on a one-rank NCCL group's (1, 1) mesh:
    losses, tokens and logits equal; (c) phase 10's cell over two gloo
    processes x two shards of ``cuda:0``, ``scan`` and ``while``, bitwise
    ``want`` (phase 10's one-process scan); (d) the FL smoke at one process
    under NCCL. Where the machine has two GPUs, (a), (b) and (c) again with
    one process a GPU over NCCL."""
    from repro_torch.launch import distributed as D
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as TR

    t0 = time.perf_counter()
    workdir = os.path.join(ROOT, "build", "chip_smoke_host_mesh")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    out = {"card": card_info()}
    plain = {
        "train": zoo_part("train", lambda hist: TR.train(
            "qwen2-1.5b", reduced=False, device="cuda", log_every=100,
            history=hist, **HOST_MESH_TRAIN), flash_ops),
        "serve": zoo_part("serve", lambda hist: SV.serve(
            "qwen2-1.5b", reduced=False, device="cuda", **HOST_MESH_SERVE),
            flash_ops)}
    out["plain"] = without_logits(plain)
    t1 = time.perf_counter()
    one = launch_zoo(D, 1, workdir)
    mesh = one[0]
    out["one_rank"] = {**without_logits(mesh), "launch_s": time.perf_counter() - t1}
    out["one_rank_same"] = check_zoo_same(plain, one)
    log(f"phase 16 (a)/(b): --processes 1 (one NCCL rank), losses, tokens "
        f"and logits bitwise the plain run's; train "
        f"{mesh['train']['warm_ms_per_step']:.1f} ms a step "
        f"(plain {plain['train']['warm_ms_per_step']:.1f})")

    inputs = os.path.join(ROOT, "build", "chip_smoke_distributed", "inputs.npz")
    shutil.copy(inputs, os.path.join(workdir, "inputs.npz"))
    blocks = [D.block_range(HOST_K, i, HYBRID_PROCESSES)
              for i in range(HYBRID_PROCESSES)]
    # (d) starts first and runs beside (c): a group of its own (NCCL, its
    # own rendezvous), its output into files (a full pipe would stall it)
    t1 = time.perf_counter()
    smoke_files = [open(os.path.join(workdir, f"smoke.{ext}"), "w+")
                   for ext in ("out", "err")]
    smoke = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--smoke",
         "--num-processes", "1", "--device", "cuda"], env=D.child_env(),
        stdout=smoke_files[0], stderr=smoke_files[1], text=True)
    try:
        t2 = time.perf_counter()
        hybrid = spawn_children(D, HYBRID_PROCESSES,
                                ["--hybrid-child", workdir, "cuda:0"], workdir)
        out["hybrid"] = {"spawn_s": time.perf_counter() - t2,
                         "bitwise": check_hybrid(hybrid, want, blocks, "gloo"),
                         "processes": hybrid}
        smoke.wait(timeout=max(1.0, HOST_MESH_TIMEOUT_S
                               - (time.perf_counter() - t1)))
    finally:
        if smoke.poll() is None:
            smoke.kill()
            smoke.wait()
    for r in hybrid:
        for run in r["runs"].values():
            run.pop("digest")
    for f in smoke_files:
        f.seek(0)
    smoke_out, smoke_err = (f.read() for f in smoke_files)
    for f in smoke_files:
        f.close()
    if smoke.returncode != 0:
        log(f"--- smoke stderr ---\n{smoke_err[-6000:]}")
        raise RuntimeError(f"phase 16 (d): the smoke exited {smoke.returncode}")
    summary = json.loads(smoke_out.strip().splitlines()[-2])
    if summary["backend"] != "nccl" or not summary["bitwise_to_one_process"]:
        raise RuntimeError(f"phase 16 (d): {summary}")
    out["smoke"] = {**summary, "s": time.perf_counter() - t1,
                    "beside": "(c)"}

    gpus = torch.cuda.device_count()
    if gpus >= HOST_MESH_GPUS:
        readings = split_readings(TR)
        many = launch_zoo(D, HOST_MESH_GPUS, workdir)
        out["gpus"] = {"readings": readings,
                       "ranks": [without_logits(r) for r in many],
                       "same": check_zoo_same(plain, many, readings)}
        across = spawn_children(D, HYBRID_PROCESSES,
                                ["--hybrid-child", workdir, "cuda"], workdir)
        out["gpus"]["hybrid_bitwise"] = check_hybrid(across, want, blocks,
                                                     "nccl")
    else:
        log(f"phase 16: no run across distinct GPUs was made: "
            f"torch.cuda.device_count() = {gpus}")
    out["distinct_gpus"] = gpus >= HOST_MESH_GPUS
    out["launches"] = {
        "flash_tensor_core": {p: mesh[p]["flash_route_launches"]["tensor_core"]
                              for p in ("train", "serve")},
        "hybrid": {d: {k: [r["runs"][d]["launches"][k] for r in hybrid]
                       for k in ("psgf_mix_batch", "flash_short")}
                   for d in ("scan", "while")}}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 17: the zoo's float32 prefills through the general flash route
# ---------------------------------------------------------------------------

# configs with dtype="float32", as the reference's
# examples/long_context_decode.py builds them: published widths and depths
FP32_PREFILLS = (("hymba-1.5b", 32), ("qwen2-1.5b", 28))     # arch, layers
FP32_PREFILL = dict(batch=4, prompt_len=2048)
# the general kernel's design, for the kernels line (its source note says why)
GENERAL_DESIGN = (
    "3xTF32 mma.sync m16n8k8 (operands split into a TF32 high part and the "
    "rest; bf16 exact in TF32), a block per (batch row, kv head) and 64 or "
    "128 rows of the flattened (position, head of the group) axis, 16 x MW "
    "rows a warp (MW 2 at hd 64 / 128), a 2-stage cp.async K/V ring (64 "
    "keys a tile at hd 64, 16 at hd 128, 32 below), softmax once a tile by "
    "quad shuffles, query tiles in reverse (longest first), tiles outside "
    "the mask never loaded")


def general_ptxas(build) -> dict:
    """``-Xptxas -v``'s registers and spills of the general kernel per dtype
    and head dim; raises if a float32 entry at hd 64 or 128 (the float32
    prefills') spills."""
    report = build.parse_ptxas(build.build_log("flash_attention"))
    out = {}
    for name, entry in report.items():
        dtype = "bfloat16" if "nv_bfloat16" in name else "float32"
        for hd in (8, 16, 32, 64, 128):
            if f"Li{hd}E" in name:
                out[f"{dtype}_hd{hd}"] = entry
    main = [out.get(f"float32_hd{hd}", {}) for hd in (64, 128)]
    if len(out) != 10 or any(e.get("spill_stores", 1) or e.get("spill_loads", 1)
                             for e in main):
        raise RuntimeError(f"general kernel's ptxas report: {out}")
    log(json.dumps({"general_ptxas": out}))
    return out


def fp32_prefill(flash_ops, ssm_ops, arch, layers) -> dict:
    """One float32 prefill of ``arch`` at full width (4 x 2,048) through
    ``ModelApi.prefill`` on the card, its flash calls on the general route
    (every count set to 0 just before and read just after), beside the same
    prefill with ``attn_impl="chunked"`` (``flash_mha`` in torch ops, no
    flash kernel) from the same params: last-position logits within
    ``HYBRID_CPU_TOL``; warm prefill ms and peak memory of each."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if cfg.num_layers != layers:
        raise RuntimeError(f"{arch} has {cfg.num_layers} layers, not {layers}")
    B, S = FP32_PREFILL["batch"], FP32_PREFILL["prompt_len"]
    api = ModelApi(cfg, "cuda")
    t0 = time.perf_counter()
    params = api.init_params(R.PRNGKey(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    runs = {"flash": lambda: api.prefill(params, {"tokens": tokens}, cache_len=S),
            "chunked": lambda: decoder.prefill(cfg, params, tokens,
                                               attn_impl="chunked", cache_len=S)}
    out, logits = {"model": arch, "layers": layers, "batch": B, "prompt_len": S,
                   "activations": cfg.dtype, "init_s": init_s}, {}
    with torch.inference_mode():
        for name, fn in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_ops.reset_launch_counts()         # every count, just before
            ssm_ops.LAUNCHES = 0
            t0 = time.perf_counter()
            lg, cache = fn()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            routes = dict(flash_ops.ROUTE_LAUNCHES)  # ... and just after
            ssm = ssm_ops.LAUNCHES
            peak = torch.cuda.max_memory_allocated()
            logits[name] = lg[:, -1].float()
            del lg, cache
            want = {"scalar": layers if name == "flash" else 0,
                    "tensor_core": 0, "short": 0}
            if routes != want:
                raise RuntimeError(f"{arch} float32 prefill ({name}): flash "
                                   f"launches {routes}, want {want}")
            warm = [host_ms(fn) for _ in range(3)]
            out[name] = {"flash_route_launches": routes, "ssm_scan_launches": ssm,
                         "prefill_ms_first": first_ms,
                         "prefill_ms": statistics.median(warm),
                         "prefill_ms_runs": warm, "peak_memory_bytes": peak}
    got, ref_logits = logits["flash"], logits["chunked"]
    err = float((got - ref_logits).abs().max())
    if not (got.shape == (B, cfg.vocab_size) and torch.isfinite(got).all()
            and torch.allclose(got, ref_logits, atol=HYBRID_CPU_TOL,
                               rtol=HYBRID_CPU_TOL)):
        raise RuntimeError(f"{arch} float32 prefill: logits vs chunked max "
                           f"|err| {err}")
    out.update(logits_max_abs_err=err,
               logits_max_abs=float(ref_logits.abs().max()))
    del params, logits, got, ref_logits
    return out


def drive_float32_prefills(flash_ops, ssm_ops) -> dict:
    """Phase 17: ``fp32_prefill`` of each of ``FP32_PREFILLS``."""
    t0 = time.perf_counter()
    runs = []
    for arch, layers in FP32_PREFILLS:
        free_device_memory()
        runs.append(fp32_prefill(flash_ops, ssm_ops, arch, layers))
        log(json.dumps({"float32_prefill": runs[-1]}))
    return {"runs": runs, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 18: the paper's comparison on the card
# ---------------------------------------------------------------------------

# (a) Table I: the reference's centralized loop (benchmarks/table1.py's
# train_eval, written over the port's functions) for its five forecasters
# at the paper's widths (d_model 128, 16 heads, d_ff 256), flash attention
# on, on its two datasets. Cut to horizon 96 (the reference's full mode also
# runs 192, its quick mode 24) and to 200 steps a run (its quick count; full
# 1,500). On the card the step is captured once as a CUDA graph after one
# eager step and replayed, as table1.py jits it.
TABLE1_DATASETS = (("ett-like", "ett_like", 2), ("weather-like", "weather_like", 3))
TABLE1_MODELS = (("logtst", "logtst_config", 128),
                 ("patchtst64", "patchtst_config", 512),
                 ("patchtst42", "patchtst_config", 336),
                 ("mlpformer", "mlpformer_config", 128),
                 ("idformer", "idformer_config", 128))
TABLE1_HORIZON = 96
TABLE1_STEPS = 200
TABLE1_BATCH = 128
TABLE1_LR = 1e-3
# each forecaster's params at horizon 96, from the JAX package's num_params
TABLE1_PARAMS = {"logtst/15": 453_858, "patchtst/63": 1_181_922,
                 "patchtst/41": 908_770, "mlpformer": 388_530,
                 "idformer": 387_810}
# the first steps on the card against the same steps on the CPU, from the
# same params and batches: cuBLAS and the CPU sum the matmuls in other
# orders and the flash kernel's online softmax rounds otherwise than the
# dense one (ulps a step), and one_cycle's ramp keeps lr at ~4e-5 there, so
# Adam's sign-like first steps cannot move a loss by 1e-4 relative
TABLE1_CPU_STEPS = 5
TABLE1_CPU_RTOL = 1e-4

# (b) Tables II-III: benchmarks/table23.py's quick grid, every entry with the
# fused psgf_mix downlink, through run_experiment on the full nn5 and ev
# tasks (pooled FL over 64 / 58 stations) with the while driver, at its
# settings, uncut: max_rounds 120, patience 8, eval every 20. Patience
# stopped nn5's runs at 80-100 rounds and ev's at 40-80 on the H100
# (PERF.md, the paper's comparison); the phase holds that it stops at least
# one row of each task before max_rounds
GRID = (("online", {}),
        ("pso", {"share_ratio": 0.5}), ("pso", {"share_ratio": 0.3}),
        ("psgf", {"share_ratio": 0.5, "forward_ratio": 0.2}),
        ("psgf", {"share_ratio": 0.3, "forward_ratio": 0.2}),
        ("psgf_topk", {"share_ratio": 0.3, "forward_ratio": 0.2}))
GRID_SPEC = dict(select_ratio=0.5, local_steps=4, batch_size=32,
                 max_rounds=120, patience=8, eval_every=20, driver="while")


def table1_train(F, pt, O, ops, cfg, params, x, y, batches, device):
    """Adam with ``one_cycle(TABLE1_LR, TABLE1_STEPS)`` over ``batches`` (a
    ``(steps, batch)`` index array into ``x`` / ``y``) on ``device``,
    written into ``params``. On the CPU every step is eager. On the card
    the first step runs eagerly on a side stream (the capture's warm-up)
    and the step is captured once as a CUDA graph and replayed for the
    rest, as table1.py jits it. Returns each step's loss and the flash
    calls by route that the capture counted (each replay launches them
    again; the wrappers count only the capture)."""
    opt = O.Adam(lr=O.one_cycle(TABLE1_LR, TABLE1_STEPS))
    state = opt.init(params)
    xs, ys, order = (torch.from_numpy(a).to(device) for a in (x, y, batches))
    idx = order[0].clone()

    def step():
        (loss, _), grads = pt.value_and_grad(
            lambda p: (F.mse_loss(cfg, p, xs[idx], ys[idx]), {}), params)
        opt.update_(params, grads, state)
        return loss

    if device == "cpu":
        losses = []
        for row in order:
            idx.copy_(row)
            losses.append(step())
        return torch.stack(losses).tolist(), {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        losses = [step()]
    torch.cuda.current_stream().wait_stream(side)
    graph, before = torch.cuda.CUDAGraph(), dict(ops.ROUTE_LAUNCHES)
    with torch.cuda.graph(graph):
        loss = step()
    captured = {r: n - before[r] for r, n in ops.ROUTE_LAUNCHES.items()}
    for row in order[1:]:
        idx.copy_(row)
        graph.replay()
        losses.append(loss.clone())
    return torch.stack(losses).tolist(), captured


def flash_backward_profile(ops, ref) -> dict:
    """One training step of Table I's PatchTST/63 (ett-like's first
    ``TABLE1_BATCH`` windows, weights from ``torch.Generator`` seeded
    ``SEED``) under ``torch.profiler``, the flash backward (the plain
    version's gradient in torch ops, from autograd's thread) in its own
    span, and that backward alone at the step's shape, timed."""
    from torch.profiler import record_function

    from repro_torch.common import pytree_utils as pt
    from repro_torch.core import forecast as F
    from repro_torch.data.synthetic import ett_like
    from repro_torch.data.windowing import table1_windows

    cfg = F.patchtst_config(look_back=512, horizon=TABLE1_HORIZON,
                            use_flash_attn=True)
    params = F.init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    x, y = table1_windows(ett_like(seed=2), cfg.look_back, TABLE1_HORIZON)

    backward = ops.flash_attention_ref_backward

    def spanned(*args, **kw):
        with record_function("flash.backward"):
            return backward(*args, **kw)

    xb, yb = (torch.from_numpy(a[:TABLE1_BATCH]).cuda() for a in (x, y))
    step = lambda: pt.value_and_grad(  # noqa: E731
        lambda p: (F.mse_loss(cfg, p, xb, yb), {}), params)
    with patched(ops, "flash_attention_ref_backward", spanned):
        step()
        prof = profile_spans(step, ("flash.", "train."))
    hd = cfg.d_model // cfg.num_heads
    q, k, v = attention_inputs(torch.Generator().manual_seed(SEED), TABLE1_BATCH,
                               cfg.num_tokens, cfg.num_tokens, cfg.num_heads,
                               cfg.num_heads, hd, torch.float32)
    do = torch.randn_like(q)
    alone = timed_ms(lambda: ref.flash_attention_ref_backward(q, k, v, do,
                                                              causal=False))
    return {"model": cfg.name, "step": prof, "backward_alone_ms": alone,
            "backward_calls_per_step": cfg.mixers.count("attn"),
            "shape": [TABLE1_BATCH, cfg.num_tokens, cfg.num_heads, hd]}


def table1_run(F, pt, O, ops, mix_ops, dname, series, mname, cfg_fn,
               look_back) -> dict:
    """One Table I row: ``mname`` trained ``TABLE1_STEPS`` steps on the card
    from random weights (``torch.Generator`` seeded ``SEED``) and evaluated
    on the last 20% of the windows; the first ``TABLE1_CPU_STEPS`` steps
    again on the CPU from the same params and batches."""
    from repro_torch.data.windowing import table1_windows

    cfg = getattr(F, cfg_fn)(look_back=look_back, horizon=TABLE1_HORIZON,
                             use_flash_attn=True)
    if (cfg.d_model, cfg.num_heads, cfg.d_ff) != (128, 16, 256):
        raise RuntimeError(f"{cfg.name} is not at the paper's widths")
    params_n = F.num_params(cfg)
    if params_n != TABLE1_PARAMS[cfg.name]:
        raise RuntimeError(f"{cfg.name}: {params_n} params, want "
                           f"{TABLE1_PARAMS[cfg.name]}")
    x, y = table1_windows(series, look_back, TABLE1_HORIZON)
    n_tr = int(0.8 * len(x))
    rng = np.random.default_rng(0)
    batches = np.stack([rng.integers(0, n_tr, size=TABLE1_BATCH)
                        for _ in range(TABLE1_STEPS)])
    params = F.init_params(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    start = pt.tree_map(lambda t: t.cpu(), params)
    torch.cuda.synchronize()
    ops.reset_launch_counts()                  # every count, just before
    mix_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    losses, captured = table1_train(F, pt, O, ops, cfg, params, x[:n_tr],
                                    y[:n_tr], batches, "cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        err = (F.forward(cfg, params, torch.from_numpy(x[n_tr:]).cuda())
               - torch.from_numpy(y[n_tr:]).cuda())
        mse, mae = float(torch.mean(err * err)), float(torch.mean(err.abs()))
    eval_s = time.perf_counter() - t0
    replays = TABLE1_STEPS - 1                 # ... and just after, the
    routes = {r: n + captured[r] * (replays - 1)   # capture counted once
              for r, n in ops.ROUTE_LAUNCHES.items()}
    flash = ops.LAUNCHES + sum(captured.values()) * (replays - 1)
    mix = mix_ops.LAUNCHES
    del err
    attn = cfg.mixers.count("attn")
    want = {"short": (TABLE1_STEPS + 1) * attn, "scalar": 0, "tensor_core": 0}
    if routes != want or flash != want["short"]:
        raise RuntimeError(f"{dname} {cfg.name}: flash launches {routes}, "
                           f"want {want}")
    t0 = time.perf_counter()
    cpu_losses, _ = table1_train(F, pt, O, ops, cfg, start, x[:n_tr],
                                 y[:n_tr], batches[:TABLE1_CPU_STEPS], "cpu")
    cpu_s = time.perf_counter() - t0
    card = losses[:TABLE1_CPU_STEPS]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu_losses))
    if not loss_rel <= TABLE1_CPU_RTOL:
        raise RuntimeError(f"{dname} {cfg.name}: first losses card {card} vs "
                           f"CPU {cpu_losses} ({loss_rel} relative)")
    if not (math.isfinite(mse) and math.isfinite(mae)
            and all(map(math.isfinite, losses))):
        raise RuntimeError(f"{dname} {cfg.name}: mse {mse}, mae {mae}")
    row = {"dataset": dname, "horizon": TABLE1_HORIZON, "model": cfg.name,
           "key": mname, "params": params_n, "mse": mse, "mae": mae,
           "train_s": train_s, "eval_s": eval_s, "cpu_steps_s": cpu_s,
           "steps": TABLE1_STEPS, "graph_replays": replays,
           "captured_flash_calls": captured["short"],
           "train_rows": n_tr, "test_rows": len(x) - n_tr,
           "loss_first": losses[0], "loss_last": losses[-1],
           "first_losses_card": card, "first_losses_cpu": cpu_losses,
           "first_losses_max_rel_err": loss_rel,
           "flash_route_launches": routes, "psgf_mix_launches": mix}
    log(f"table1 {dname} {cfg.name}: params {params_n}, mse {mse:.4f}, "
        f"mae {mae:.4f}, train {train_s:.2f} s, eval {eval_s:.2f} s, flash "
        f"launches {routes}, psgf_mix launches {mix}, first {TABLE1_CPU_STEPS} "
        f"losses within {loss_rel:.2e} of the CPU")
    return row


def drive_table1(ops, mix_ops) -> dict:
    """Phase 18 (a): every forecaster of ``TABLE1_MODELS`` on each dataset
    of ``TABLE1_DATASETS`` through ``table1_run``, then table1.py's claim
    (LoGTST's mse beside PatchTST's at their parameter ratio) as a
    report."""
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core import forecast as F
    from repro_torch import optim as O
    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    rows, claim = [], {}
    for dname, gen, seed in TABLE1_DATASETS:
        series = getattr(synthetic, gen)(seed=seed)
        for mname, cfg_fn, look_back in TABLE1_MODELS:
            free_device_memory()
            rows.append(table1_run(F, pt, O, ops, mix_ops, dname, series,
                                   mname, cfg_fn, look_back))
        by = {r["key"]: r for r in rows if r["dataset"] == dname}
        lo = by["logtst"]
        claim[dname] = {
            key: {"patchtst_mse": by[key]["mse"], "logtst_mse": lo["mse"],
                  "mse_difference": lo["mse"] - by[key]["mse"],
                  "param_ratio": lo["params"] / by[key]["params"]}
            for key in ("patchtst64", "patchtst42")}
        for key, c in claim[dname].items():
            log(f"table1 claim {dname}: logtst/15 mse {c['logtst_mse']:.4f} "
                f"beside {by[key]['model']} {c['patchtst_mse']:.4f} "
                f"({c['mse_difference']:+.4f}) at {c['param_ratio']:.1%} of "
                f"its params")
    return {"rows": rows, "claim": claim,
            "flash_launches": sum(r["flash_route_launches"]["short"] for r in rows),
            "seconds": time.perf_counter() - t0}


def pareto(rows):
    """Fig. 6's front (benchmarks/fig6.py's rule): the rows that no other
    row beats in rmse at no more comm, by comm."""
    return sorted((r for r in rows if not any(
        o is not r and o["comm_params"] <= r["comm_params"] and o["rmse"] < r["rmse"]
        for o in rows)), key=lambda r: r["comm_params"])


@contextlib.contextmanager
def recording_replays(E, log_):
    """Append, at the end of each while run's ``launch``, its graphs'
    replays keyed by ``id(graph)`` to ``log_``."""
    launch = E._WhileRun.launch

    def recorded(self):
        launch(self)
        log_.append({id(g): self.replays[n] for n, g in self.graphs.items()})

    E._WhileRun.launch = recorded
    try:
        yield log_
    finally:
        E._WhileRun.launch = launch


def drive_policy_grid(ops, mix_ops) -> dict:
    """Phase 18 (b): ``GRID`` on the full ``nn5`` and ``ev`` tasks through
    ``run_experiment(driver="while")`` at full width, flash on; per row the
    kernels' launches (the calls outside the graphs, plus each graph's
    captured calls times its replays); patience must stop a row of each
    task before ``max_rounds``; Fig. 6's front per task."""
    from repro_torch.core.fl import engine as E
    from repro_torch.core.tasks import (ExperimentSpec, get_task,
                                        run_experiment, task_forecaster)

    def counts():
        return {"psgf_mix_batch": mix_ops.LAUNCHES, "flash": ops.LAUNCHES,
                **{f"flash_{r}": n for r, n in ops.ROUTE_LAUNCHES.items()}}

    t0 = time.perf_counter()
    out = {"grid": [[p, o] for p, o in GRID], "tasks": {}}
    grid = tuple((p, {**o, "use_pallas_mix": True}) for p, o in GRID)
    max_rounds = GRID_SPEC["max_rounds"]
    for which in ("nn5", "ev"):
        task = get_task(which, quick=False)
        model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
        spec = ExperimentSpec(task=task, model=model, grid=grid, **GRID_SPEC)
        rows, replays = [], []
        free_device_memory()
        torch.cuda.synchronize()
        mix_ops.LAUNCHES = 0                  # every count, just before
        ops.reset_launch_counts()
        seen = [counts(), 0, 0]               # counts, captures, runs read

        with counting_captures(E, counts) as captured, \
                recording_replays(E, replays):
            def on_row(row):
                now = counts()
                new = captured[seen[1]:]
                rep = replays[seen[2]] if seen[2] < len(replays) else {}
                launches = {k: now[k] - seen[0][k] + sum(
                    c[k] * (rep.get(g, 1) - 1) for g, c in new) for k in now}
                seen[:] = [now, len(captured), len(replays)]
                row = dict(row, launches=launches,
                           graphs=[{"replays": rep.get(g), "captured_calls": c}
                                   for g, c in new])
                rows.append(row)
                log(f"grid {which} {row['policy']}: comm {row['comm_params']:.4e}, "
                    f"rmse {row['rmse']:.4f}, rounds {row['rounds']}, train "
                    f"{row['train_s']} s, launches psgf_mix "
                    f"{launches['psgf_mix_batch']} flash {launches['flash']}")

            t1 = time.perf_counter()
            res = run_experiment(spec, on_row=on_row, device="cuda")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
        if len(res["rows"]) != len(GRID) or len(rows) != len(GRID):
            raise RuntimeError(f"grid {which}: {len(res['rows'])} rows")
        for row in rows:
            n = row["launches"]
            if not (n["psgf_mix_batch"] > 0 and n["flash"] > 0
                    and n["flash_short"] == n["flash"]
                    and math.isfinite(row["rmse"]) and row["comm_params"] > 0):
                raise RuntimeError(f"grid {which} row {row}")
        stopped = [r["policy"] for r in rows if r["rounds"] < max_rounds]
        if not stopped:
            raise RuntimeError(f"grid {which}: patience stopped no row before "
                               f"{max_rounds} rounds: "
                               f"{[r['rounds'] for r in rows]}")
        front = pareto(rows)
        log(f"grid {which} pareto front (comm, rmse, rounds): "
            + ", ".join(f"{r['policy']} {r['comm_params']:.3e} {r['rmse']:.4f} "
                        f"{r['rounds']}r" for r in front))
        out["tasks"][which] = {
            "stations": task.num_clients, "look_back": task.look_back,
            "horizon": task.horizon, "params": model.num_params(),
            "max_rounds": max_rounds, "stopped_by_patience": stopped,
            "rows": rows,
            "pareto": [r["policy"] for r in front], "seconds": run_s,
            "launches": {k: sum(r["launches"][k] for r in rows)
                         for k in rows[0]["launches"]}}
    out["spec"] = GRID_SPEC
    out["seconds"] = time.perf_counter() - t0
    return out


def policy_rounds_card_vs_cpu() -> dict:
    """Phase 18 (b'): for each policy of ``GRID`` (its first entry, the
    fused downlink on), one round of phase 5's smallest cluster (10
    stations) on the card against the same round on the CPU
    (``card_vs_cpu_round``); then psgf_topk's masks (``masks.topk_mask``: a
    stable descending sort, ties to the lowest index) from the same tied
    and untied scores on both."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.core.fl import masks as M
    from repro_torch.core.tasks import get_task, task_forecaster

    t0 = time.perf_counter()
    task = get_task("ev", quick=False, clusters=3, num_days=420,
                    min_cluster_clients=4)
    model = task_forecaster(task, "logtst", quick=False, use_flash_attn=True)
    series = task.series()
    labels = task.cluster_labels(series, device="cuda")
    firsts = {}
    for policy, overrides in GRID:
        firsts.setdefault(policy, {**overrides, "use_pallas_mix": True})
    rounds = {}
    for policy, overrides in firsts.items():
        rounds[policy] = card_vs_cpu_round(E, R, task, series, labels, model,
                                           (policy, overrides), SEED)
        log(f"phase 18 round {policy} card vs CPU: bitwise "
            f"{all(rounds[policy]['bitwise'].values())}, w_global max |err| "
            f"{rounds[policy]['w_global_max_abs_err']:.3e}, uplink gate flips "
            f"{rounds[policy]['uplink_gate_flips']}")
    gen = torch.Generator().manual_seed(SEED)
    D = MIX_D
    scores = {"tied": torch.randint(0, 64, (27, D), generator=gen).float(),
              "untied": torch.rand(27, D, generator=gen),
              "all_equal": torch.zeros(27, D)}
    topk = {}
    for name, s in scores.items():
        for ratio in (0.3, 0.2):
            k = max(1, int(D * ratio))
            same = torch.equal(M.topk_mask(s, k), M.topk_mask(s.cuda(), k).cpu())
            topk[f"{name}_{ratio}"] = same
    if not all(topk.values()):
        raise RuntimeError(f"psgf_topk masks card vs CPU: {topk}")
    return {"task": "ev full, 3 DTW clusters (phase 5's)", "rounds": rounds,
            "topk_mask_bitwise": topk, "seconds": time.perf_counter() - t0}


PAPER_TIMEOUT_S = 600


def host_probe() -> dict:
    """What an eager step's host time depends on in this process: the
    median microseconds of one small eager op on the card (5 x 2,000
    ``add_``), live Python objects, threads, torch's CPU threads and the
    torch-function and dispatch modes, the profiler and sync debug mode."""
    import threading

    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    t = torch.zeros(16, device="cuda")
    per = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            t.add_(1.0)
        torch.cuda.synchronize()
        per.append(1e6 * (time.perf_counter() - t0) / 2000)
    return {"us_per_eager_op": statistics.median(per),
            "python_objects": len(gc.get_objects()),
            "gc_counts": list(gc.get_count()),
            "threads": threading.active_count(),
            "torch_threads": torch.get_num_threads(),
            "function_modes": len(_get_current_function_mode_stack()),
            "dispatch_modes": len(_get_current_dispatch_mode_stack()),
            "profiler_enabled": bool(torch.autograd.profiler._is_profiler_enabled),
            "sync_debug_mode": torch.cuda.get_sync_debug_mode(),
            "grad_enabled": torch.is_grad_enabled()}


def paper_child(workdir: str) -> None:
    """Phase 18 in a fresh interpreter of this script (``chip_smoke.py
    --paper-child DIR``): Table I (``drive_table1``), the per-policy rounds
    against the CPU (``policy_rounds_card_vs_cpu``), the grid
    (``drive_policy_grid``) and last the profiled PatchTST/63 step
    (``flash_backward_profile``: the profiler may leave the process's
    launches slower), one after the other, each resetting and reading the
    kernels' counts around its own runs, with ``host_probe`` before each
    stage and at the end; its lines go to this script's output, its
    report to ``DIR/report.json``."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.psgf_mix import ops as mix_ops

    torch.backends.cuda.matmul.allow_tf32 = False     # as phase 1 pins them
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    probes = {"start": host_probe()}
    out = {"host_probe": probes, "table1": drive_table1(ops, mix_ops)}
    log(f"phase 18 (a): {out['table1']['seconds']:.1f} s")
    probes["after_table1"] = host_probe()
    out["policy_rounds"] = policy_rounds_card_vs_cpu()
    probes["after_rounds"] = host_probe()
    out["policy_grid"] = drive_policy_grid(ops, mix_ops)
    log(f"phase 18 (b): {out['policy_grid']['seconds']:.1f} s")
    probes["after_grid"] = host_probe()
    free_device_memory()
    out["profile_step"] = flash_backward_profile(ops, ref)
    probes["after_profile"] = host_probe()
    log("phase 18 eager op host us: " + ", ".join(
        f"{k} {v['us_per_eager_op']:.2f}" for k, v in probes.items()))
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "report.json"), "w") as f:
        json.dump(out, f)


def drive_paper_comparison() -> dict:
    """Phase 18 in one fresh interpreter of this script (``--paper-child``,
    killed past ``PAPER_TIMEOUT_S``), alone on the card: in this
    long-lived process, after the earlier phases, Table I's eager steps
    took 1.5-1.8x as long on the H100 (PERF.md), so ``host_probe`` is
    taken here and there. Returns its report."""
    t0 = time.perf_counter()
    probe = host_probe()
    log(f"phase 18 eager op host us in this process: "
        f"{probe['us_per_eager_op']:.2f}")
    workdir = os.path.join(ROOT, "build", "chip_smoke_paper")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--paper-child", workdir], env=env,
                          timeout=PAPER_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 18 child exited {proc.returncode}")
    with open(os.path.join(workdir, "report.json")) as f:
        out = json.load(f)
    return {"card": card_info(), "host_probe_here": probe, **out,
            "child_seconds": out["seconds"],
            "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--distributed-child"]:        # phase 10's children
        print(json.dumps(distributed_child(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--host-mesh-child"]:          # phase 16's children
        host_mesh_child(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--hybrid-child"]:
        print(json.dumps(hybrid_child(sys.argv[2], sys.argv[3])))
        return 0
    if sys.argv[1:2] == ["--paper-child"]:              # phase 18's child
        paper_child(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--collectives-child"]:        # phase 14's children
        kind = sys.argv[2]
        print(json.dumps(sharded_train_child(sys.argv[3]) if kind == "card"
                         else accounting_child()))
        return 0
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
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    # 1. card
    started = time.perf_counter()

    def ended(phase: int):
        log(f"phase {phase} ended at {time.perf_counter() - started:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_info())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    ended(1)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t0:.1f}s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line:       # which kernel the lines below are
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    tc_ptxas = tensor_core_ptxas(_build)
    gen_ptxas = general_ptxas(_build)
    ended(2)

    # 3. kernels against their plain versions
    record = check_flash_attention(ops, ref, FLASH_ATTN_TOL)
    train_errs = check_flash_training(ops, ref, FLASH_ATTN_TOL)
    record["max_abs_err"] = max(
        [record["max_abs_err"]] + [e for n, e in train_errs.items()
                                   if not n.startswith("vmap_grad")])
    mix_record = check_psgf_mix(mix_ops, mix_ref)
    ended(3)

    # 4. the serving path
    serving = drive_serving(ops)
    serving_routes = serving["flash_route_launches"]
    record["launches"] = serving["flash_attention_launches"]
    log(json.dumps({"serving": serving}))
    ended(4)

    # 5. the training path
    training = drive_training(mix_ops, ops)
    mix_record["launches"] = training["launches"]["psgf_mix_batch"]
    mix_record["k1_psgf_mix"]["launches"] = training["launches"]["psgf_mix"]
    record["launches_training"] = training["launches"]["flash_attention"]
    log(json.dumps({"training": training}))
    ended(5)

    # 6. hymba-1.5b hybrid serving
    ssm_record = check_ssm_scan(ssm_ops, ssm_ref)
    record["hybrid_prefill"] = check_flash_hymba(ops, ref)
    hybrid = drive_hybrid_serving(ssm_ops, ops)
    ssm_record["launches"] = hybrid["launches_prefill"]["ssm_scan"]
    record["hybrid_prefill"]["launches"] = hybrid["launches_prefill"]["flash_attention"]
    log(json.dumps({"hybrid_serving": hybrid}))
    ended(6)

    # 7. the while and host FL drivers
    drivers = drive_training_drivers(mix_ops, ops)
    log(json.dumps({"training_drivers": drivers}))
    on_while = drivers["while_launches_run_B"]
    on_host = drivers["host_vs_loop"]["host"]["launches"]
    record["launches_while_run_B"] = on_while["flash_short"]
    record["launches_host"] = on_host["flash_short"]
    mix_record["launches_while_run_B"] = on_while["psgf_mix_batch"]
    mix_record["launches_host"] = on_host["psgf_mix_batch"]
    ended(7)

    # 8. the flywheel behind the gateway
    flywheel = drive_flywheel(mix_ops, ops)
    log(json.dumps({"flywheel": flywheel}))
    record["launches_flywheel"] = flywheel["launches"]["flash_attention"]
    mix_record["launches_flywheel"] = flywheel["launches"]["psgf_mix_batch"]
    ended(8)

    # 9. zoo training: qwen2-1.5b with PSGF-DP, hymba's ssm_scan gradient
    zoo = drive_zoo_training(ops, ref, ssm_ops, ssm_ref)
    log(json.dumps({"zoo_training": zoo}))
    record["launches_zoo_training"] = zoo["launches"]["flash_attention"]
    ssm_record["launches_zoo_training"] = zoo["launches"]["ssm_scan"]
    ssm_record["training_grads"] = zoo["ssm_scan_training_grads"]
    ended(9)

    # 10. PSGF-Fed across two processes on this card
    torch.cuda.empty_cache()
    distributed = drive_distributed(
        mix_ops, ops, drivers["host_vs_loop"]["host_digest"])
    scan_digest = distributed.pop("one_process_scan_digest")
    log(json.dumps({"distributed": distributed}))
    record["launches_distributed"] = {
        run: n["flash_short"] for run, n in distributed["launches"].items()}
    mix_record["launches_distributed"] = {
        run: n["psgf_mix_batch"] for run, n in distributed["launches"].items()}
    ended(10)

    # 11. the zoo's vlm and moe families at full width
    free_device_memory()
    zoo_families = drive_zoo_families(ops, ref)
    log(json.dumps({"zoo_families": zoo_families}))
    record["launches_zoo_families"] = zoo_families["flash_launches_prefill"]
    ended(11)

    # 12. the zoo's last two families, xlstm-125m and seamless-m4t-large-v2
    free_device_memory()
    last = drive_last_families(ops, ref, ssm_ops)
    log(json.dumps({"zoo_last_families": last}))
    record["launches_zoo_last_families"] = last["flash_launches_prefill"]
    record["launches_zoo_last_families_training"] = last["flash_launches_training"]
    ended(12)

    # 13. card training of the moe and vlm families, phase 14's CPU-only
    # accounting child running beside it
    free_device_memory()
    accounting = start_collectives_child("accounting")
    try:
        moe_vlm = drive_moe_vlm_training(ops, ref, ssm_ops)
    except BaseException:
        accounting[0].kill()
        accounting[0].wait()
        raise
    log(json.dumps({"zoo_moe_vlm_training": moe_vlm}))
    record["launches_zoo_moe_vlm_training"] = moe_vlm["flash_launches_training"]
    ended(13)

    # 14. the sharded steps' collectives: the (1, 1) mesh on the card, the
    # production meshes' accounting on the CPU
    free_device_memory()
    collectives = drive_collectives(accounting)
    log(json.dumps({"collectives": collectives}))
    log(f"phase 14: {collectives['seconds']:.1f} s")
    record["launches_zoo_sharded_training"] = collectives["flash_launches"]
    ended(14)

    # 15. a local mesh: the client axis and serving's batch axis over shards
    # of this process
    free_device_memory()
    local = drive_local_mesh(mix_ops, ops, scan_digest,
                             distributed["one_process_scan"])
    log(json.dumps({"local_mesh": local}))
    log(f"phase 15: {local['seconds']:.1f} s")
    record["launches_local_mesh"] = [
        {"devices": r["devices"],
         **{d: r["fl"][d]["warm"]["launches"]["flash_short"]
            for d in ("scan", "while")},
         "serving": r["serving"]["traffic"]["sharded"]["flash_short"]}
        for r in local["runs"]]
    mix_record["launches_local_mesh"] = [
        {"devices": r["devices"],
         **{d: r["fl"][d]["warm"]["launches"]["psgf_mix_batch"]
            for d in ("scan", "while")}}
        for r in local["runs"]]
    ended(15)

    # 16. one process a GPU: the zoo's train and serve on the host mesh of
    # a one-rank NCCL group, the FL client mesh across two processes with
    # two shards each, the FL smoke under NCCL
    free_device_memory()
    host_mesh = drive_host_mesh(mix_ops, ops, scan_digest)
    log(json.dumps({"host_mesh": host_mesh}))
    log(f"phase 16: {host_mesh['seconds']:.1f} s")
    record["launches_host_mesh"] = host_mesh["launches"]["flash_tensor_core"]
    record["launches_hybrid_mesh"] = {
        d: n["flash_short"] for d, n in host_mesh["launches"]["hybrid"].items()}
    mix_record["launches_hybrid_mesh"] = {
        d: n["psgf_mix_batch"] for d, n in host_mesh["launches"]["hybrid"].items()}
    ended(16)

    # 17. the zoo's float32 prefills at full width through the general
    # flash route
    free_device_memory()
    fp32 = drive_float32_prefills(ops, ssm_ops)
    log(json.dumps({"float32_prefills": fp32}))
    log(f"phase 17: {fp32['seconds']:.1f} s")
    fp32_launches = {r["model"]: r["flash"]["flash_route_launches"]["scalar"]
                     for r in fp32["runs"]}
    ended(17)

    # 18. the paper's comparison: Table I's forecasters and Tables II-III's
    # policy grid, in a child process
    free_device_memory()
    paper = drive_paper_comparison()
    log(json.dumps({"paper_comparison": paper}))
    log(f"phase 18: {paper['seconds']:.1f} s")
    ended(18)
    grid_launches = {which: t["launches"]
                     for which, t in paper["policy_grid"]["tasks"].items()}

    # flash attention's record is the serving path's (the short route); the
    # scalar kernel's numbers are from the same inputs with its route forced,
    # the tensor-core route's from its hybrid_prefill entry
    tc = record["hybrid_prefill"]
    general = tc.pop("general_float32")
    record["routes"] = {
        "short": {"source": record["source"],
                  "max_abs_err": record["max_abs_err"],
                  "launches_serving": record["launches"],
                  "launches_training": record["launches_training"],
                  "launches_while_run_B": record["launches_while_run_B"],
                  "launches_host": record["launches_host"],
                  "launches_flywheel": record["launches_flywheel"],
                  "launches_distributed": record["launches_distributed"],
                  "launches_local_mesh": record["launches_local_mesh"],
                  "launches_hybrid_mesh": record["launches_hybrid_mesh"],
                  "launches_table1": paper["table1"]["flash_launches"],
                  "launches_policy_grid": {w: n["flash_short"]
                                           for w, n in grid_launches.items()},
                  "ms": record["ms"],
                  "ms_training_shape": record["training_shape"]["ms"]},
        "scalar": {"source": "src/repro_torch/csrc/flash_attention.cu",
                   "launches_float32_prefills": fp32_launches,
                   "launches_serving": serving_routes["scalar"],
                   "launches_training": training["flash_routes"]["scalar"],
                   "ms": record["serving_shape"]["scalar_ms"],
                   "ms_training_shape": record["training_shape"]["scalar_ms"],
                   "max_abs_err": max(record["serving_shape"]["scalar_max_abs_err"],
                                      record["training_shape"]["scalar_max_abs_err"]),
                   "plain_ms": record["plain_ms"],
                   "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
                   "library_ms": record["library_ms"]},
        "tensor_core": {"source": tc["source"], "design": TENSOR_CORE_DESIGN,
                        "ptxas": tc_ptxas, "launches": tc["launches"],
                        "launches_zoo_training": record["launches_zoo_training"],
                        "ms": tc["ms"], "max_abs_err": tc["max_abs_err"],
                        "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
                        "bound_by": tc["bound_by"],
                        "library_ms": tc["library_ms"],
                        "qwen2_training": zoo["flash_qwen2"],
                        "launches_zoo_families": record["launches_zoo_families"],
                        "zoo_families": zoo_families["flash_tensor_core"],
                        "launches_zoo_last_families":
                            record["launches_zoo_last_families"],
                        "launches_zoo_last_families_training":
                            record["launches_zoo_last_families_training"],
                        "zoo_last_families": last["flash_tensor_core"],
                        "launches_zoo_moe_vlm_training":
                            record["launches_zoo_moe_vlm_training"],
                        "launches_zoo_sharded_training":
                            record["launches_zoo_sharded_training"],
                        "launches_host_mesh": record["launches_host_mesh"],
                        "zoo_moe_vlm_training": moe_vlm["flash_tensor_core"]},
    }
    # the general route (kernel_route "scalar") on its own main path, phase
    # 17: its ms and bounds at hymba's float32 call, qwen2's beside it
    main_call = general["hymba-1.5b prefill"]
    general_record = {
        "name": "flash_attention_general",
        "route": "cuda",
        "kernel_route": "scalar",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:114",
        "tpu_kernel": "src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel",
        "design": GENERAL_DESIGN,
        "shape": main_call["shape"], "dtype": "float32",
        "launches": sum(fp32_launches.values()),
        "launches_by_prefill": fp32_launches,
        "max_abs_err": max(max(c["max_abs_err"] for c in general.values()),
                           max(record.pop("general_case_errs").values())),
        **{key: main_call[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_operations_by",
            "library_ms", "library_call", "library_backend")},
        "calls": general,
        "ptxas": gen_ptxas,
    }
    mix_record["launches_policy_grid"] = {w: n["psgf_mix_batch"]
                                          for w, n in grid_launches.items()}
    k1_record = mix_record.pop("k1_psgf_mix")
    log(json.dumps({"kernels": [record, mix_record, k1_record, ssm_record,
                                general_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
