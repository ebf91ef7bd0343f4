"""Serving launcher: batched prefill + autoregressive decode on one device
(counterpart of ``repro.launch.serve``).

Usage (any arch of ``configs.ARCH_IDS``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --device cpu --batch 2 --prompt-len 48 --gen 8        # reduced config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --no-reduced --device cuda --batch 4 --prompt-len 2048 --gen 32

The prefill and decode steps come from ``launch.steps.build_prefill_step``
/ ``build_serve_step``, as the reference's do, without a mesh: one card
runs the whole model. Weights are float32
from ``PRNGKey(0)`` (as the reference's ``serve``), activations in the
config's type; the prompt is ``synthetic_tokens(0, ...)``. A ``vlm`` model
gets ``0.1 * normal(PRNGKey(0))`` patch embeddings (B, num_patches, d) in
front of the prompt, and decodes from position ``prompt_len + num_patches``;
an ``audio`` (encoder-decoder) model gets ``0.1 * normal(PRNGKey(0))``
source frames (B, prompt_len, d) and takes the prompt as its target prefix.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import decoder, encdec
from repro_torch.models.spec import spec_num_params


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          reduced: bool = True, greedy: bool = True, device=DEFAULT_DEVICE):
    """Prefill a synthetic prompt batch and decode ``gen`` tokens.

    Returns ``{"tokens": (batch, gen) int array, "params": count, "init_s",
    "prefill_ms", "decode_ms_per_token"}`` (host clock around work that ends
    in a device sync). ``greedy=False`` samples from the softmax with a
    ``torch.Generator`` seeded 0."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    prefill_fn, api, _ = build_prefill_step(cfg, dev)
    serve_fn, _, _ = build_serve_step(cfg, dev)

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

    def pick(logits):
        if greedy:
            return torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        probs = torch.softmax(logits[:, -1, :].to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, inputs, cache_len=start + gen)
        _sync(dev)
        t_pref = time.perf_counter() - t0
        out_tokens = []
        tok = pick(logits)
        t0 = time.perf_counter()
        for i in range(gen):
            out_tokens.append(tok)
            logits, cache = serve_fn(params, cache, tok, start + i)
            tok = pick(logits)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    gen_arr = torch.cat(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    print(f"prefill {prompt_len} toks x{batch}: {t_pref*1e3:.1f} ms;"
          f" decode {gen} steps: {t_dec*1e3:.1f} ms"
          f" ({t_dec/max(gen, 1)*1e3:.2f} ms/tok) on {dev}")
    print("generated (first row):", gen_arr[0][:16])
    return {"tokens": gen_arr,
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
    args = ap.parse_args(argv)
    return serve(args.arch, args.batch, args.prompt_len, args.gen, args.reduced,
                 greedy=not args.sample, device=args.device)


if __name__ == "__main__":
    main()
