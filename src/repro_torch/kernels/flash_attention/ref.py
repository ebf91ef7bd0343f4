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
against it on the card. :func:`flash_attention_ref_backward` is the
kernel's backward: the same masks, its gradients written out.
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


def _probs(q, k, causal, window, kv_len):
    """fp32 ``(B, KV, G, Sq, Skv)`` attention probabilities, the fp32
    ``(B, Sq, KV, G, hd)`` queries and the scale."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, Sq, KV, H // KV, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.to(torch.float32)) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          kv_len=kv_len, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30), qf, scale


def attention_ref(q, k, v, *, causal=True, window=None):
    """The reference's oracle (``repro.kernels.flash_attention.ref``):
    dense GQA softmax attention with masked scores set to ``NEG_INF``
    before the softmax, so a row with no valid key averages every value
    where :func:`flash_attention_ref` gives 0. q: (B, Sq, H, hd); k, v:
    (B, Skv, KV, hd). Returns (B, Sq, H, hd) in q.dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.to(torch.float32)) / math.sqrt(hd)
    mask = attention_mask(Sq, Skv, causal=causal, window=window, kv_len=None,
                          device=q.device)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None, kv_len=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H % KV == 0.
    Returns (B, Sq, H, hd) in q.dtype."""
    p, _, _ = _probs(q, k, causal, window, kv_len)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(q.shape).to(q.dtype)


def flash_attention_ref_backward(q, k, v, do, *, causal=True, window=None,
                                 kv_len=None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref` for the
    output cotangent ``do``, written out (``dV = P^T dO``, ``dS = P * (dP -
    rowsum(dP * P))``, ``dQ = dS K * scale``, ``dK = dS^T Q * scale``, summed
    over each kv head's query group) in plain torch ops, so ``torch.func``
    transforms can run through it. Masked entries have ``P = 0`` and get no
    gradient; a row with no valid key has ``P = 0`` throughout and none
    either."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    p, qf, scale = _probs(q, k, causal, window, kv_len)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(torch.float32).reshape(B, Sq, KV, H // KV, hd)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
