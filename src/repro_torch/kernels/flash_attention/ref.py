"""Plain PyTorch version of the flash-attention kernel: the same function,
computed densely.

It computes what ``repro/kernels/flash_attention/kernel.py::_kernel``
computes — GQA heads (``kv = h // (H / KV)``), ``scale = 1/sqrt(hd)``, fp32
arithmetic, the ``kv_len`` padding mask, causal ``k <= q`` and the one-sided
window ``k > q - window`` (applied whether or not ``causal``), masked
probabilities exactly 0, and ``acc / max(l, 1e-30)`` so a row with no valid
key is 0 — as ``where(mask, exp(s - max), 0) / max(sum, 1e-30)`` over the
whole ``(Sq, Skv)`` score matrix.

The wrapper (``ops.flash_attention``) runs it for CPU tensors, the tests
hold it against the JAX package, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card. Its autograd is the kernel's backward.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Skv: int, *, causal: bool, window, kv_len,
                   device=None) -> torch.Tensor:
    """``(Sq, Skv)`` bool mask of the (query, key) pairs that attend."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = (kp < (Skv if kv_len is None else kv_len)).expand(Sq, Skv)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, kv_len=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0.
    Returns (B, Sq, H, hd) in q.dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.to(torch.float32).reshape(B, Sq, KV, G, hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) * (1.0 / math.sqrt(hd))
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p, vf)
    return o.reshape(B, Sq, H, hd).to(q.dtype)
