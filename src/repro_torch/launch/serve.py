"""Serving launcher: batched prefill + autoregressive decode (counterpart of
``repro.launch.serve``), on one device, or under an initialized process
group on the reference's host mesh over its ranks (``--processes N``, or
torch's own launcher; see ``launch.train``).

Usage (any arch of ``configs.ARCH_IDS``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --device cpu --batch 2 --prompt-len 48 --gen 8        # reduced config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --no-reduced --device cuda --batch 4 --prompt-len 2048 --gen 32

The prefill and decode steps come from ``launch.steps.build_prefill_step``
/ ``build_serve_step``, as the reference's do: without a group, without a
mesh (one device runs the whole model); under one, over DTensors laid out
by the serve rules on ``launch.mesh.host_mesh``, every rank with the same
weights, prompt and tokens (each next token is picked from the whole
logits). Weights are float32
from ``PRNGKey(0)`` (as the reference's ``serve``), activations in the
config's type; the prompt is ``synthetic_tokens(0, ...)``. A ``vlm`` model
gets ``0.1 * normal(PRNGKey(0))`` patch embeddings (B, num_patches, d) in
front of the prompt, and decodes from position ``prompt_len + num_patches``;
an ``audio`` (encoder-decoder) model gets ``0.1 * normal(PRNGKey(0))``
source frames (B, prompt_len, d) and takes the prompt as its target prefix.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch import distributed as D
from repro_torch.launch.api import distribute_structs, input_shape
from repro_torch.launch.mesh import global_value, host_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      sharded_serve_inputs)
from repro_torch.models import decoder, encdec
from repro_torch.models.spec import spec_num_params


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          reduced: bool = True, greedy: bool = True, device=DEFAULT_DEVICE):
    """Prefill a synthetic prompt batch and decode ``gen`` tokens.

    Returns ``{"tokens": (batch, gen) int array, "logits", "params": count,
    "init_s", "prefill_ms", "decode_ms_per_token"}`` (host clock around work
    that ends in a device sync); ``logits`` (batch, gen + 1, vocab), on the
    CPU, are the last position's of the prefill and of each decode step,
    which pick the tokens. ``greedy=False`` samples from the softmax with a
    ``torch.Generator`` seeded 0."""
    dm, _, dev = host_mesh(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    prefill_fn, api, rules = build_prefill_step(cfg, dev, mesh=dm)
    serve_fn, _, _ = build_serve_step(cfg, dev, mesh=dm)

    t0 = time.perf_counter()
    params = api.init_params(R.PRNGKey(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(synthetic_tokens(0, batch, prompt_len,
                                             cfg.vocab_size)).to(dev)
    inputs = {"tokens": toks}
    npatch = 0
    if cfg.family == "vlm":
        npatch = cfg.vlm.num_patches
        inputs["img_embeds"] = decoder.image_embeds(
            cfg, batch, R.PRNGKey(0, device=dev))
    if cfg.family == "audio":
        inputs["src_embeds"] = encdec.source_embeds(
            cfg, batch, prompt_len, R.PRNGKey(0, device=dev))
    start = prompt_len + npatch
    sampler = None if greedy else torch.Generator(dev).manual_seed(0)
    token = None
    if dm is not None:
        params_s, inputs_s = sharded_serve_inputs(
            cfg, input_shape(cfg, "prefill", batch, prompt_len), rules,
            dtype=None)
        params = distribute_structs(params_s, dm, params)
        inputs = distribute_structs(inputs_s, dm, inputs)
        token = sharded_serve_inputs(
            cfg, InputShape("decode", start + gen, batch, "decode"), rules,
            dtype=None)[1]["token"]

    picked = []

    def pick(logits):
        last = global_value(logits[:, -1, :]).clone()
        picked.append(last)
        if greedy:
            tok = torch.argmax(last, dim=-1)[:, None]
        else:
            probs = torch.softmax(last.to(torch.float32), dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)
        return tok if token is None else token.to_dtensor(dm, tok)

    # DTensor's views (a layer's weights unbound from the stack) cannot
    # take inference tensors' version counters: no_grad on the mesh
    with torch.inference_mode() if dm is None else torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, inputs, cache_len=start + gen)
        _sync(dev)
        t_pref = time.perf_counter() - t0
        out_tokens = []
        tok = pick(logits)
        t0 = time.perf_counter()
        for i in range(gen):
            out_tokens.append(global_value(tok))
            logits, cache = serve_fn(params, cache, tok, start + i)
            tok = pick(logits)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    gen_arr = torch.cat(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    if D.is_main():
        print(f"prefill {prompt_len} toks x{batch}: {t_pref*1e3:.1f} ms;"
              f" decode {gen} steps: {t_dec*1e3:.1f} ms"
              f" ({t_dec/max(gen, 1)*1e3:.2f} ms/tok) on {dev}"
              f" over {D.process_count()} process(es)")
        print("generated (first row):", gen_arr[0][:16])
    return {"tokens": gen_arr, "logits": torch.stack(picked, 1).cpu(),
            "params": spec_num_params(api.mod.model_spec(cfg)),
            "init_s": init_s, "prefill_ms": t_pref * 1e3,
            "decode_ms_per_token": t_dec / max(gen, 1) * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--processes", type=int, default=None,
                    help="start N processes, one device a rank (NCCL on "
                         "the card: N GPUs; gloo on the CPU), that serve "
                         "on the host mesh over them")
    args = ap.parse_args(argv)
    if args.processes is not None:
        code = D.launch_processes(args.processes, "repro_torch.launch.serve",
                                  sys.argv[1:] if argv is None else argv,
                                  args.device)
        if code:
            raise SystemExit(code)
        return None
    joined = D.join_group(args.device)   # under --processes / torch's launcher
    try:
        return serve(args.arch, args.batch, args.prompt_len, args.gen,
                     args.reduced, greedy=not args.sample, device=args.device)
    finally:
        if joined:
            D.shutdown_distributed()


if __name__ == "__main__":
    main()
