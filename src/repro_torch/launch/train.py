"""Training launcher (counterpart of ``repro.launch.train``).

Two modes, as the reference's:
  * ``train``: one model, Adam with a 1cycle schedule, synthetic Zipf tokens;
    under an initialized process group on the reference's host mesh
    (``launch.mesh.make_host_mesh``: one device a rank, the batch split over
    ``"data"``), the step over DTensors; without one the plain step on one
    device, which is the ``(1, 1)`` mesh's bit for bit;
  * ``train_psgf`` (``--sync psgf``): ``--pods`` replicas train on different
    data and exchange partial parameter subsets every ``--sync-interval``
    steps through the FL engine's gate/aggregate/distribute core
    (``core/psgf_dp.py``). On one card the pods are a leading axis; like the
    reference's, it uses no mesh.

``--processes N`` starts N processes, one device a rank
(``launch.distributed.launch_processes``: NCCL on the card, one GPU a rank;
gloo on the CPU), each of which joins the group and runs ``train``; so does
torch's own launcher (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``). Only process 0 prints and writes the checkpoint.

Weights come from ``PRNGKey(0)`` (float32; activations in the config's
type), batches from ``synthetic_tokens`` with the reference's seeds: step s,
or pod p at step s from ``s * pods + p``. Every entry point takes ``device``
(default ``"cuda"``, which raises without a GPU).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --device cpu --steps 8 --batch 2 --seq 32               # reduced config
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --full --sync psgf --pods 2 --sync-interval 4 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --device cpu --steps 4 --batch 4 --seq 32 --processes 2  # gloo mesh
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import random as R
from repro_torch.checkpoint import save_checkpoint
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import psgf_dp as P
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch import distributed as D
from repro_torch.launch.api import ModelApi, distribute_structs, input_shape
from repro_torch.launch.mesh import global_value, host_mesh
from repro_torch.launch.steps import build_train_step, sharded_train_inputs
from repro_torch.models import decoder, encdec
from repro_torch.optim import Adam, one_cycle
from repro_torch.sharding.rules import make_rules


def _config(arch: str, reduced: bool):
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(cfg, step: int, batch: int, seq: int, device=DEFAULT_DEVICE):
    """``{"tokens", "labels"}`` (batch, seq) int32: ``synthetic_tokens(step,
    batch, seq + 1, vocab)`` shifted by one; a ``vlm`` batch also has
    ``img_embeds`` from ``PRNGKey(step)`` (``decoder.image_embeds``), an
    ``audio`` batch ``src_embeds`` (batch, seq, d) from ``PRNGKey(step)``
    (``encdec.source_embeds``)."""
    dev = resolve_device(device)
    toks = torch.from_numpy(synthetic_tokens(step, batch, seq + 1,
                                             cfg.vocab_size)).to(dev)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["img_embeds"] = decoder.image_embeds(
            cfg, batch, R.PRNGKey(step, device=dev))
    if cfg.family == "audio":
        out["src_embeds"] = encdec.source_embeds(
            cfg, batch, seq, R.PRNGKey(step, device=dev))
    return out


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 64,
          reduced: bool = True, lr: float = 3e-4, ckpt_dir: str | None = None,
          log_every: int = 10, device=DEFAULT_DEVICE, history: dict | None = None):
    """Returns the per-step losses. A given ``history`` dict receives
    ``step_s`` (host seconds per step, each ending in a device sync).

    Under an initialized process group (``launch.distributed``) every rank
    draws the same weights and batches, keeps only its shards of them
    (``distribute_structs`` by the train rules on ``launch.mesh.host_mesh``) and
    returns the global mean loss of each step; process 0 alone prints and
    writes the checkpoint, from the whole tensors, in the one-process
    format."""
    dm, host, dev = host_mesh(device)
    cfg = _config(arch, reduced)
    optimizer = Adam(lr=one_cycle(lr, steps))
    fn, api, optimizer = build_train_step(cfg, optimizer, dev, mesh=dm)
    params = api.init_params(R.PRNGKey(0))
    opt_state = optimizer.init(params)
    if dm is not None:
        ps, os_, bs = sharded_train_inputs(
            cfg, input_shape(cfg, "train", batch, seq),
            make_rules(host, "train"), optimizer)
        params = distribute_structs(ps, dm, params)
        opt_state = distribute_structs(os_, dm, opt_state)
    history = {} if history is None else history
    history["step_s"] = []
    talk = D.is_main()

    losses = []
    _sync(dev)
    t0 = time.time()
    for step in range(steps):
        ts = time.perf_counter()
        b = make_batch(cfg, step, batch, seq, dev)
        if dm is not None:
            b = distribute_structs(bs, dm, b)
        params, opt_state, metrics = fn(params, opt_state, b)
        losses.append(float(global_value(metrics["loss"])))
        history["step_s"].append(time.perf_counter() - ts)
        if talk and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d}  loss {losses[-1]:.4f}  ({time.time()-t0:.1f}s)",
                  flush=True)
    if ckpt_dir:
        whole = {}
        for path, leaf in pt.flatten_with_paths(params):
            leaf = global_value(leaf)             # every rank joins the gather
            if talk:
                whole[path] = leaf
        if talk:
            save_checkpoint(ckpt_dir, steps, {"params": pt.unflatten(whole)},
                            extra={"arch": arch, "final_loss": losses[-1]})
    return losses


def train_psgf(arch: str, steps: int = 50, batch: int = 8, seq: int = 64,
               reduced: bool = True, lr: float = 3e-4,
               ckpt_dir: str | None = None, log_every: int = 10,
               pods: int = 2, sync_interval: int = 4,
               share_ratio: float = 0.3, forward_ratio: float = 0.2,
               select_ratio: float = 0.5, device=DEFAULT_DEVICE,
               history: dict | None = None):
    """PSGF-DP training: ``pods`` model replicas train on DIFFERENT data with
    ``sync_interval`` local steps between partial syncs (paper eqs. 4-6 at
    leaf granularity; see ``core/psgf_dp.py``), and a last sync after
    trailing steps. Prints the sync wire bytes beside the full-sync
    baseline's and returns the per-step losses (the mean over pods).

    A given ``history`` dict receives ``step_s`` and ``sync_s`` (host
    seconds, each ending in a device read), ``sync_keys`` (each sync's key
    as two ints), ``wire_bytes`` (per sync), ``psgf_bytes`` and
    ``full_bytes``."""
    dev = resolve_device(device)
    cfg = _config(arch, reduced)
    api = ModelApi(cfg, dev)
    optimizer = Adam(lr=one_cycle(lr, steps))
    key = R.PRNGKey(0, device=dev)
    glob = api.init_params(key)
    local = P.stack_for_pods(glob, pods)
    opt_state = P.init_pod_opt_state(optimizer, local)
    step = P.make_local_train_step(api.loss_fn, optimizer)
    dp_cfg = P.PSGFDPConfig(share_ratio=share_ratio, forward_ratio=forward_ratio,
                            select_ratio=select_ratio, sync_interval=sync_interval)
    history = {} if history is None else history
    history.update(step_s=[], sync_s=[], sync_keys=[], wire_bytes=[])

    losses = []
    psgf_bytes = full_bytes = 0.0

    def sync():
        nonlocal key, local, glob, psgf_bytes, full_bytes
        ts = time.perf_counter()
        key, sk = R.split(key)
        local, glob, stats = P.psgf_sync(local, glob, sk, dp_cfg, pods)
        wire = float(stats["wire_bytes"])
        history["sync_s"].append(time.perf_counter() - ts)
        history["sync_keys"].append([int(w) for w in sk.tolist()])
        history["wire_bytes"].append(wire)
        psgf_bytes += wire
        full_bytes += 2.0 * pods * pt.tree_size_bytes(glob)

    _sync(dev)
    t0 = time.time()
    for s in range(steps):
        ts = time.perf_counter()
        # different data per pod: offset the synthetic-batch seed by pod index
        per_pod = [make_batch(cfg, s * pods + p, batch, seq, dev) for p in range(pods)]
        stacked = {k: torch.stack([b[k] for b in per_pod]) for k in per_pod[0]}
        local, opt_state, loss = step(local, opt_state, stacked)
        losses.append(float(loss.mean()))
        history["step_s"].append(time.perf_counter() - ts)
        if (s + 1) % dp_cfg.sync_interval == 0:
            sync()
        if s % log_every == 0 or s == steps - 1:
            print(f"step {s:5d}  loss {losses[-1]:.4f}  "
                  f"sync_bytes {psgf_bytes:.3e}  ({time.time()-t0:.1f}s)",
                  flush=True)
    if steps % dp_cfg.sync_interval != 0:
        # fold the trailing local steps into the global model before
        # reporting / checkpointing; otherwise they would be discarded
        sync()
    history.update(psgf_bytes=psgf_bytes, full_bytes=full_bytes)
    if full_bytes:
        print(f"PSGF sync wire bytes: {psgf_bytes:.3e} vs full-sync "
              f"{full_bytes:.3e} (saving {1 - psgf_bytes / full_bytes:.0%})",
              flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": glob},
                        extra={"arch": arch, "final_loss": losses[-1],
                               "sync": "psgf", "pods": pods})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="alias for --no-reduced")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sync", choices=["none", "psgf"], default="none",
                    help="psgf: pods train locally, partial-share every "
                         "--sync-interval steps (engine-backed PSGF-DP)")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--sync-interval", type=int, default=4)
    ap.add_argument("--share-ratio", type=float, default=0.3)
    ap.add_argument("--forward-ratio", type=float, default=0.2)
    ap.add_argument("--select-ratio", type=float, default=0.5)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--processes", type=int, default=None,
                    help="start N processes, one device a rank (NCCL on "
                         "the card: N GPUs; gloo on the CPU), that train "
                         "on the host mesh over them")
    args = ap.parse_args(argv)
    if args.processes is not None:
        if args.sync == "psgf":
            ap.error("--sync psgf runs on one device (no mesh, as the "
                     "reference's); drop --processes")
        code = D.launch_processes(args.processes, "repro_torch.launch.train",
                                  sys.argv[1:] if argv is None else argv,
                                  args.device)
        if code:
            raise SystemExit(code)
        return None
    if args.sync == "psgf":
        losses = train_psgf(args.arch, args.steps, args.batch, args.seq,
                            args.reduced, args.lr, args.ckpt_dir,
                            pods=args.pods, sync_interval=args.sync_interval,
                            share_ratio=args.share_ratio,
                            forward_ratio=args.forward_ratio,
                            select_ratio=args.select_ratio, device=args.device)
    else:
        joined = D.join_group(args.device)   # under --processes / torch's launcher
        talk = D.is_main()                   # asked while the group stands
        try:
            losses = train(args.arch, args.steps, args.batch, args.seq,
                           args.reduced, args.lr, args.ckpt_dir,
                           device=args.device)
        finally:
            if joined:
                D.shutdown_distributed()
        if not talk:
            return losses
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
