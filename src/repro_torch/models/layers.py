"""Neural-net layers of the model zoo (counterpart of ``repro.models.layers``)
for every family — ``dense`` (qwen2, mistral, command-r), ``vlm``
(internvl2), ``moe`` (phi3.5-moe, deepseek-v2 with MLA), ``hybrid``
(hymba), ``ssm`` (xLSTM's mLSTM / sLSTM cells) and the encoder-decoder
``audio`` (seamless: the ungated MLP and :func:`cross_attention`) — their
decode and their training: plain functions over the reference's params
dict, with its names, shapes and layouts (q/k/v ``(B, S, H, hd)``, caches
keyed as in JAX).

Routing to the kernels:

  * :func:`self_attention` — ``attn_impl`` ``"auto"`` and ``"pallas"`` run
    the CUDA flash-attention kernel for CUDA tensors
    (``kernels.flash_attention.ops``), at every length, and the same
    wrapper's plain version for ``meta`` tensors (the dry run's); on the CPU
    ``"auto"`` runs :func:`gqa_attend` up to :data:`CHUNKED_ATTN_THRESHOLD`
    tokens and the long-sequence path above it (``"pallas"`` the kernel
    wrapper's plain
    version); ``"full"`` is dense on any device; ``"chunked"`` is the
    long-sequence path on any device: :func:`flash_mha` with
    ``cfg.attn_custom_vjp``, else :func:`chunked_attend`;
  * :func:`mla_attention` — dense up to :data:`CHUNKED_ATTN_THRESHOLD`
    tokens, the long-sequence path above it, on any device (its q/k head
    dim, nope + rope = 192, is none of the kernel's);
  * :func:`ssm_apply` — ``impl`` ``"auto"`` and ``"pallas"`` run
    ``kernels.ssm_scan.ops.ssm_scan`` (the CUDA kernel on the card, its plain
    version on the CPU); ``"xla"`` is the reference's own ``lax.scan`` step
    order, ``dt*x`` formed in the input type (``layers.py:723`` there).

:func:`flash_mha` and :func:`chunked_attend` are the reference's jnp
double scans (no Pallas kernel) as two Python loops over blocks; the MoE
expert products are einsums, as there. Weights are float32 and cast to the
activation type at each use, as the reference does (``.astype(x.dtype)``);
the embedding table is gathered first and the rows cast, which gives the
same values without casting the whole table. The xLSTM cells' ``lax.scan``
over time is a Python loop over positions in torch ops (the reference has
no kernel for them), and :func:`cross_attention` is dense, as there.

Over DTensors (a step built with a mesh, ``launch.steps``) the same
functions run the same ops. Where DTensor's own sharding rules would pick
a layout that a later view cannot take, or have no rule, the layout is
fixed per mesh dimension and the op runs on each rank's local shards
(``kernels._sharded``): the head projections and matmuls
(:func:`proj_heads`, :func:`merge_heads`, :func:`matmul`), the embedding,
every attention, the MoE routing and experts, the xLSTM recurrences and
the loss (:func:`_vocab_parallel_nll`); a dimension that must be whole is
redistributed explicitly (:func:`whole_dims`), so each collective shows in
``launch.cost.collective_bytes``. On plain tensors every path is the one
above, op for op.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._sharded import is_dtensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import ArraySpec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def norm_spec(d):
    return {"scale": ArraySpec((d,), ("act_embed",), init="ones")}


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Computed
    in float32, then cast back to x's type."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window)
# ---------------------------------------------------------------------------

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
CHUNKED_ATTN_THRESHOLD = 2048  # the reference switches to chunked above this Sq
ATTN_IMPLS = ("auto", "full", "pallas", "chunked")


def attention_spec(cfg: ModelConfig):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    spec = {
        "wq": ArraySpec((d, H, hd), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": ArraySpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": ArraySpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": ArraySpec((H, hd, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        spec["bq"] = ArraySpec((H, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ArraySpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ArraySpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _qkv(params, x, cfg: ModelConfig):
    q = proj_heads(x, params["wq"].to(x.dtype))
    k = proj_heads(x, params["wk"].to(x.dtype))
    v = proj_heads(x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive mask bias (..., Sq, Sk) from absolute positions. Padded key
    slots carry k_pos == int32 max and are always excluded."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    allowed = torch.broadcast_to(kp < INT32_MAX,
                                 torch.broadcast_shapes(qp.shape, kp.shape))
    if causal:
        allowed = allowed & (kp <= qp)
    if window is not None:
        allowed = allowed & (kp > qp - window)
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


def gqa_attend(q, k, v, bias):
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd); bias: broadcastable (B,1,Sq,Sk).

    Materializes (B,KV,G,Sq,Sk) scores; the probabilities are rounded to
    q's type before the PV product, as in the reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    hd_v = v.shape[3]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd) + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, hd_v)


def _pad_blocks(q, k, v, q_pos, k_pos, block_q, block_k):
    """Pad q to whole query blocks (``q_pos`` -1) and k / v to whole key
    blocks (``k_pos`` int32 max, always masked), then split into blocks:
    q (B, nq, bq, KV, G, hd), k (B, nk, bk, KV, hd), v (B, nk, bk, KV,
    hd_v), positions (nq, bq) and (nk, bk)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    G = H // KV
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    pad_q, pad_k = (-Sq) % bq, (-Sk) % bk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=INT32_MAX)
    nq, nk = q.shape[1] // bq, k.shape[1] // bk
    return (q.reshape(B, nq, bq, KV, G, hd), k.reshape(B, nk, bk, KV, hd),
            v.reshape(B, nk, bk, KV, hd_v), q_pos.reshape(nq, bq),
            k_pos.reshape(nk, bk))


def _online_step(qblk, kblk, vblk, qp, kp, m, l, acc, scale, causal, window):
    """One key block of the online softmax: the running max ``m``, row sum
    ``l`` and accumulator ``acc`` (float32) after keys ``kblk``."""
    s = torch.einsum("bskgd,btkd->bkgst", qblk, kblk).to(torch.float32) * scale
    s = s + _mask_bias(qp, kp, causal, window)[None, None, None]
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgst,btkd->bkgsd", p.to(qblk.dtype), vblk).to(torch.float32)
    return m_new, l_new, acc_new


def _query_block(qblk, kb, vb, qp, kpb, scale, causal, window, remat=False):
    """Online softmax of one query block over every key block. Returns
    (out (B, KV, G, bq, hd_v) in q's type, lse (B, KV, G, bq) float32)."""
    B, bq, KV, G, _ = qblk.shape
    f32 = torch.float32
    m = torch.full((B, KV, G, bq), NEG_INF, dtype=f32, device=qblk.device)
    l = torch.zeros((B, KV, G, bq), dtype=f32, device=qblk.device)
    acc = torch.zeros((B, KV, G, bq, vb.shape[-1]), dtype=f32, device=qblk.device)
    for j in range(kb.shape[1]):
        args = (qblk, kb[:, j], vb[:, j], qp, kpb[j], m, l, acc, scale,
                causal, window)
        if remat:
            m, l, acc = checkpoint(_online_step, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = _online_step(*args)
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(qblk.dtype)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


def _join_query_blocks(outs, B, Sq, H):
    """[(B, KV, G, bq, f)] per query block -> (B, Sq, H, f)."""
    out = torch.stack(outs, dim=1)               # (B, nq, KV, G, bq, f)
    nq, bq, f = out.shape[1], out.shape[4], out.shape[5]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * bq, H, f)
    return out[:, :Sq]


def chunked_attend(q, k, v, q_pos, k_pos, causal=True, window=None,
                   block_q: int = 512, block_k: int = 512,
                   remat_inner: bool = True):
    """Flash-style online-softmax attention in torch ops, the reference's
    double ``lax.scan`` as two loops over blocks: memory O(block_q *
    block_k) per step instead of O(Sq * Sk). q: (B,Sq,H,hd), k: (B,Sk,KV,hd),
    v: (B,Sk,KV,hd_v); q_pos: (Sq,), k_pos: (Sk,) absolute positions.

    ``remat_inner`` runs each key-block step under ``torch.utils.checkpoint``
    when gradients are on (the reference's ``jax.checkpoint``), so the
    backward keeps no (bq x bk) tiles; it changes no value."""
    B, Sq, H, hd = q.shape
    qb, kb, vb, qpb, kpb = _pad_blocks(q, k, v, q_pos, k_pos, block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    remat = remat_inner and torch.is_grad_enabled()
    outs = [_query_block(qb[:, i], kb, vb, qpb[i], kpb, scale, causal, window,
                         remat)[0] for i in range(qb.shape[1])]
    return _join_query_blocks(outs, B, Sq, H)


class _FlashMHA(torch.autograd.Function):
    """The reference's custom-VJP ``flash_mha``: the forward is the online
    softmax and saves ``(q, k, v, out, lse)`` only; the backward recomputes
    each (query block, key block) probability tile from the saved ``lse``
    (the flash backward, Dao et al.), so no O(Sq * Sk) tensor is kept."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, block_q, block_k):
        B, Sq, H, hd = q.shape
        qb, kb, vb, qpb, kpb = _pad_blocks(q, k, v, q_pos, k_pos, block_q,
                                           block_k)
        scale = 1.0 / math.sqrt(hd)
        outs, lses = zip(*[_query_block(qb[:, i], kb, vb, qpb[i], kpb, scale,
                                        causal, window)
                           for i in range(qb.shape[1])])
        out = _join_query_blocks(list(outs), B, Sq, H)
        lse = _join_query_blocks([x[..., None] for x in lses], B, Sq, H)[..., 0]
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.mask = (causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        causal, window, block_q, block_k = ctx.mask
        f32 = torch.float32
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        hd_v, G = v.shape[3], H // KV
        qb, kb, vb, qpb, kpb = _pad_blocks(q, k, v, q_pos, k_pos, block_q,
                                           block_k)
        nq, bq, nk, bk = qb.shape[1], qb.shape[2], kb.shape[1], kb.shape[2]
        scale = 1.0 / math.sqrt(hd)
        pad_q = nq * bq - Sq

        def qblocks(a):          # (B, Sq, H, f) -> (B, nq, bq, KV, G, f)
            a = F.pad(a, (0, 0, 0, 0, 0, pad_q)) if pad_q else a
            return a.reshape(B, nq, bq, KV, G, a.shape[-1])

        dob, ob = qblocks(dout), qblocks(out)
        # lse and D_i = rowsum(dout * out), each (B, nq, KV, G, bq)
        lseb = qblocks(lse[..., None])[..., 0].permute(0, 1, 3, 4, 2)
        Db = torch.sum(dob.to(f32) * ob.to(f32), dim=-1).permute(0, 1, 3, 4, 2)
        dk = torch.zeros((B, nk, bk, KV, hd), dtype=f32, device=q.device)
        dv = torch.zeros((B, nk, bk, KV, hd_v), dtype=f32, device=q.device)
        dqs = []
        for i in range(nq):
            qblk, doblk = qb[:, i], dob[:, i]
            lse_q, D_q = lseb[:, i], Db[:, i]
            dq_blk = torch.zeros((B, bq, KV, G, hd), dtype=f32, device=q.device)
            for j in range(nk):
                kblk, vblk = kb[:, j], vb[:, j]
                s = torch.einsum("bskgd,btkd->bkgst", qblk, kblk).to(f32) * scale
                s = s + _mask_bias(qpb[i], kpb[j], causal, window)[None, None, None]
                p = torch.exp(s - lse_q[..., None])
                dp = torch.einsum("bskgd,btkd->bkgst", doblk, vblk).to(f32)
                ds = p * (dp - D_q[..., None]) * scale
                dq_blk = dq_blk + torch.einsum("bkgst,btkd->bskgd",
                                               ds.to(kblk.dtype), kblk)
                dk[:, j] += torch.einsum("bkgst,bskgd->btkd",
                                         ds.to(qblk.dtype), qblk)
                dv[:, j] += torch.einsum("bkgst,bskgd->btkd",
                                         p.to(doblk.dtype), doblk)
            dqs.append(dq_blk)
        dq = torch.stack(dqs, dim=1).reshape(B, nq * bq, H, hd)[:, :Sq]
        dk = dk.reshape(B, nk * bk, KV, hd)[:, :Sk]
        dv = dv.reshape(B, nk * bk, KV, hd_v)[:, :Sk]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def flash_mha(q, k, v, q_pos, k_pos, causal=True, window=None,
              block_q: int = 512, block_k: int = 512):
    """Long-sequence attention with the flash backward (the reference's
    ``flash_mha``, ``jax.custom_vjp``). q: (B,Sq,H,hd), k: (B,Sk,KV,hd),
    v: (B,Sk,KV,hd_v) with ``hd_v`` free (MLA: 192 / 128); q_pos (Sq,),
    k_pos (Sk,). Returns (B, Sq, H, hd_v) in q's type."""
    return _FlashMHA.apply(q, k, v, q_pos, k_pos, causal, window, block_q,
                           block_k)


def _attend(fn, q, k, v, *batch_args, whole=()):
    """``fn(q, k, v, *batch_args, *whole)``, an attention; over DTensors on
    each rank's shards (``kernels._sharded.attention_local``: the batch or
    the heads split, anything else made whole first; ``batch_args`` split
    as q's batch, ``whole`` whole on every rank)."""
    if not is_dtensor(q):
        return fn(q, k, v, *batch_args, *whole)
    from repro_torch.kernels import _sharded

    return _sharded.attention_local(fn, q, k, v, *batch_args, whole=whole)


def _long_attention(q, k, v, pos1d, cfg: ModelConfig, causal, window):
    """The reference's path above :data:`CHUNKED_ATTN_THRESHOLD`."""
    if cfg.attn_custom_vjp:
        return flash_mha(q, k, v, pos1d, pos1d, causal, window)
    return chunked_attend(q, k, v, pos1d, pos1d, causal=causal, window=window,
                          remat_inner=cfg.attn_remat_inner)


def self_attention(params, x, positions, cfg: ModelConfig, *, causal=True,
                   window=None, attn_impl: str = "auto", return_kv=False):
    """Full-sequence self-attention (prefill). x: (B,S,d); positions (S,).

    With ``return_kv`` also returns the roped k and v (B,S,KV,hd), which
    prefill lays into the cache (the reference recomputes them)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    S = x.shape[1]
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pos1d = positions[0] if positions.dim() == 2 else positions

    def attend(q, k, v):
        if attn_impl == "chunked" or (attn_impl == "auto"
                                      and S > CHUNKED_ATTN_THRESHOLD):
            return _long_attention(q, k, v, pos1d, cfg, causal, window)
        bias = _mask_bias(pos1d, pos1d, causal, window)[None, None]
        return gqa_attend(q, k, v, bias)

    # meta tensors (the dry run) take the card's route; the kernel's
    # wrapper takes DTensors itself
    on_card = q.device.type in ("cuda", "meta")
    if attn_impl == "pallas" or (attn_impl == "auto" and on_card):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal, window=window)
    else:
        out = _attend(attend, q, k, v)
    out = merge_heads(out, params["wo"].to(x.dtype))
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------------
# KV cache (ring buffer for sliding-window; slot_pos track validity)
# ---------------------------------------------------------------------------


def kv_cache_shape(cfg: ModelConfig, batch: int, cache_len: int):
    """Physical cache length honours the sliding window if smaller."""
    phys = cache_len if cfg.attention_window is None else min(cfg.attention_window, cache_len)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": (cfg.num_layers, batch, phys, KV, hd),
        "v": (cfg.num_layers, batch, phys, KV, hd),
        "slot_pos": (cfg.num_layers, phys),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    shp = kv_cache_shape(cfg, batch, cache_len)
    return {
        "k": torch.zeros(shp["k"], dtype=dtype, device=device),
        "v": torch.zeros(shp["v"], dtype=dtype, device=device),
        "slot_pos": torch.full(shp["slot_pos"], -1, dtype=torch.int32,
                               device=device),
    }


def decode_attention(params, x, layer_cache, pos: int, cfg: ModelConfig):
    """Single-token decode. x: (B,1,d); layer_cache: dict(k, v, slot_pos)
    for THIS layer (k/v: (B,P,KV,hd)); pos: int absolute position.

    Returns (out (B,1,d), layer_cache). The cache is updated IN PLACE (the
    reference returns an updated copy): position ``pos`` goes to slot
    ``pos % P``, so decoding never copies the cache."""
    q, k, v = _qkv(params, x, cfg)
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    P = layer_cache["k"].shape[1]
    slot = pos % P
    ck, cv, spos = layer_cache["k"], layer_cache["v"], layer_cache["slot_pos"]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    spos[slot] = pos
    valid = spos >= 0
    if cfg.attention_window is not None:
        valid = valid & (spos > pos - cfg.attention_window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    out = _attend(lambda q, k, v, b: gqa_attend(q, k, v, b), q, ck, cv,
                  whole=(bias,))
    out = merge_heads(out, params["wo"].to(x.dtype))
    return out, layer_cache


def cross_attention(params, x, kv_k, kv_v, src_valid, cfg: ModelConfig):
    """The decoder's attention over the frozen encoder K/V (no rope, no
    mask but ``src_valid``). x: (B,S,d); kv_k, kv_v: (B,Ssrc,KV,hd);
    src_valid: (B,Ssrc) bool. Dense on every device, as in the reference."""
    q = proj_heads(x, params["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    def attend(q, k, v, valid):
        bias = torch.where(valid[:, None, None, :], 0.0, NEG_INF).to(torch.float32)
        return gqa_attend(q, k, v, bias)

    out = _attend(attend, q, kv_k, kv_v, src_valid)
    return merge_heads(out, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d: int, f: int, gated: bool = True):
    """The gated (SwiGLU) MLP of the decoder families and the MoE's shared
    experts, or with ``gated=False`` the encoder-decoder's GELU MLP with
    biases."""
    if gated:
        return {
            "w_gate": ArraySpec((d, f), ("embed", "mlp"), init="scaled"),
            "w_up": ArraySpec((d, f), ("embed", "mlp"), init="scaled"),
            "w_down": ArraySpec((f, d), ("mlp", "embed"), init="scaled"),
        }
    return {
        "w_up": ArraySpec((d, f), ("embed", "mlp"), init="scaled"),
        "b_up": ArraySpec((f,), ("mlp",), init="zeros"),
        "w_down": ArraySpec((f, d), ("mlp", "embed"), init="scaled"),
        "b_down": ArraySpec((d,), ("act_embed",), init="zeros"),
    }


def mlp_apply(params, x, gated: bool = True):
    if gated:
        g = F.silu(matmul(x, params["w_gate"].to(x.dtype)))
        u = matmul(x, params["w_up"].to(x.dtype))
        return matmul(g * u, params["w_down"].to(x.dtype))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(matmul(x, params["w_up"].to(x.dtype)) + params["b_up"].to(x.dtype),
               approximate="tanh")
    return matmul(h, params["w_down"].to(x.dtype)) + params["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (group-limited one-hot dispatch, GShard/Switch style)
# ---------------------------------------------------------------------------

MOE_GROUP_SIZE = 256  # tokens per dispatch group; bounds one-hot memory


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    spec = {
        "router": ArraySpec((d, m.num_experts), ("embed", "experts"), init="scaled"),
        "w_gate": ArraySpec((m.num_experts, d, fe), ("experts", "embed", "mlp"), init="scaled"),
        "w_up": ArraySpec((m.num_experts, d, fe), ("experts", "embed", "mlp"), init="scaled"),
        "w_down": ArraySpec((m.num_experts, fe, d), ("experts", "mlp", "embed"), init="scaled"),
    }
    if m.num_shared:
        spec["shared"] = mlp_spec(d, m.num_shared * fe)
    return spec


def moe_capacity(cfg: ModelConfig, group_size: int) -> int:
    """Slots per expert in a dispatch group of ``group_size`` tokens."""
    m = cfg.moe
    return max(1, int(math.ceil(group_size * m.top_k / m.num_experts
                                * m.capacity_factor)))


def moe_route(probs, top_k: int, cap: int, dtype):
    """The reference's routing of router probabilities ``probs`` (G, gs, E)
    float32, written out so it can be inspected. Returns a dict:

      * ``gate_idx`` (G, gs, K): top-k experts, descending, ties to the lower
        index as ``jax.lax.top_k`` (a stable descending sort);
      * ``gate_vals`` (G, gs, K): their probabilities renormalised to sum 1;
      * ``positions`` / ``keep`` (G, gs, K): each slot's place in its expert's
        queue, from a cumsum over the group's tokens, choice k after every
        kept choice before k; a slot at or past ``cap`` is dropped;
      * ``counts`` (G, E) int32: kept slots per expert;
      * ``dispatch`` (G, gs, E, cap) in ``dtype`` and ``combine`` float32:
        the one-hot dispatch and its gate-weighted combine."""
    G, gs, E = probs.shape
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    i32 = torch.int32
    counts = torch.zeros((G, E), dtype=i32, device=probs.device)
    dispatch = torch.zeros((G, gs, E, cap), dtype=dtype, device=probs.device)
    combine = torch.zeros((G, gs, E, cap), dtype=torch.float32, device=probs.device)
    positions, keeps = [], []
    for kk in range(top_k):
        idx = gate_idx[..., kk]                                  # (G, gs)
        oh = F.one_hot(idx, E).to(i32)                           # (G, gs, E)
        pos_in_e = torch.cumsum(oh, dim=1, dtype=i32) - oh + counts[:, None, :]
        mypos = torch.gather(pos_in_e, -1, idx[..., None])[..., 0]
        keep = mypos < cap
        pos_oh = F.one_hot(torch.where(keep, mypos, cap).long(),
                           cap + 1).to(dtype)[..., :cap]
        d_k = oh.to(dtype)[..., None] * pos_oh[:, :, None, :]   # (G, gs, E, cap)
        dispatch = dispatch + d_k
        combine = combine + d_k.to(torch.float32) * gate_vals[..., kk][..., None, None]
        counts = counts + torch.sum(oh * keep[..., None].to(i32), dim=1, dtype=i32)
        positions.append(mypos)
        keeps.append(keep)
    return {"gate_idx": gate_idx, "gate_vals": gate_vals,
            "positions": torch.stack(positions, dim=-1),
            "keep": torch.stack(keeps, dim=-1), "counts": counts,
            "dispatch": dispatch, "combine": combine}


_ROUTE_KEYS = ("gate_idx", "gate_vals", "positions", "keep", "counts",
               "dispatch", "combine")


def _route(probs, top_k: int, cap: int, dtype):
    """:func:`moe_route`; over a DTensor, on each rank's groups: a group's
    tokens and the experts made whole (the sort and the queue's cumsum
    need them), the groups kept split, every output split as they are."""
    if not is_dtensor(probs):
        return moe_route(probs, top_k, cap, dtype)
    from torch.distributed.tensor.experimental import local_map

    probs = whole_dims(probs, [1, 2])
    pl = list(probs.placements)

    def local(p):
        r = moe_route(p, top_k, cap, dtype)
        return tuple(r[k] for k in _ROUTE_KEYS)

    out = local_map(local, out_placements=tuple([pl] * len(_ROUTE_KEYS)),
                    in_placements=(pl,), device_mesh=probs.device_mesh)(probs)
    return dict(zip(_ROUTE_KEYS, out))


def _experts(xg, dispatch, combine, w_gate, w_up, w_down):
    """The experts' gated MLPs over their capacity slots: tokens (G,gs,d)
    dispatched to (G,E,cap,d), through each expert, combined back."""
    xe = torch.einsum("gsd,gsec->gecd", xg, dispatch)  # (G,E,cap,d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate))
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    ye = torch.einsum("gecf,efd->gecd", h * u, w_down)
    return torch.einsum("gsec,gecd->gsd", combine, ye)


def _experts_sharded(xg, dispatch, combine, w_gate, w_up, w_down):
    """:func:`_experts` over DTensors, on each rank's groups and experts:
    per mesh dimension, the groups stay split where the tokens are, the
    experts where the weights split them (each rank takes its experts'
    slots of the dispatch, no data moved); the weights' other splits (the
    FSDP ``embed``) are made whole first. The combine's output is then a
    pending sum over the expert split, whose reduction DTensor issues
    where the next op needs it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import _sharded

    mesh = xg.device_mesh
    rows = []
    for i, (xp, wp) in enumerate(zip(xg.placements, w_gate.placements)):
        if xp.is_shard(0):      # groups: x, dispatch, combine, y; weights' grads summed
            rows.append((Shard(0), Shard(0), Replicate(), Shard(0),
                         Shard(0), Partial()))
        elif wp.is_shard(0):    # experts
            rows.append((Replicate(), Shard(2), Shard(0), Partial(),
                         Partial(), Shard(0)))
        else:
            rows.append((Replicate(),) * 6)
    x_in, route_in, w_in, y_out, x_grad, w_grad = (tuple(r[j] for r in rows)
                                                   for j in range(6))
    return _sharded.run_local(
        _experts, mesh, (xg, dispatch, combine, w_gate, w_up, w_down),
        (x_in, route_in, route_in, w_in, w_in, w_in), y_out,
        (x_grad, route_in, route_in, w_grad, w_grad, w_grad))


def _shards(x, dim: int) -> int:
    """How many pieces a DTensor's placements cut dimension ``dim`` into."""
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard(dim))


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B,S,d) -> (y (B,S,d), aux_loss scalar float32).

    The tokens are cut into groups of ``min(256, T)``, the last padded with
    zero tokens (routed like any other, and counted in the aux loss's
    means, as in the reference); each expert takes at most
    :func:`moe_capacity` tokens of a group."""
    m = cfg.moe
    B, S, d = x.shape
    E = m.num_experts
    T = B * S
    gs = min(MOE_GROUP_SIZE, T)
    xt = x.reshape(T, d)
    pad = (-T) % gs
    if is_dtensor(xt) and (pad or (T + pad) // gs % _shards(xt, 0)):
        # the groups cut the token axis where its shards do not end
        xt = whole_dims(xt, [0])
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(-1, gs, d)
    router = params["router"].to(x.dtype)
    logits = (torch.einsum("gsd,de->gse", xg, router) if not is_dtensor(xg)
              else matmul(xg, router)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    route = _route(probs, m.top_k, moe_capacity(cfg, gs), x.dtype)

    w = tuple(params[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down"))
    if is_dtensor(xg):
        y = _experts_sharded(xg, route["dispatch"], route["combine"].to(x.dtype),
                             *w)
    else:
        y = _experts(xg, route["dispatch"], route["combine"].to(x.dtype), *w)
    y = y.reshape(-1, d)[:T].reshape(B, S, d)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=(0, 1))
    top1 = F.one_hot(route["gate_idx"][..., 0], E).to(torch.float32)
    fe_frac = torch.mean(top1, dim=(0, 1))
    aux = E * torch.sum(fe_frac * me) * m.router_aux_weight

    if m.num_shared:
        y = y + mlp_apply(params["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig):
    a = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = a.nope_head_dim
    return {
        "wq_a": ArraySpec((d, a.q_lora_rank), ("embed", "lora"), init="scaled"),
        "q_norm": norm_spec(a.q_lora_rank),
        "wq_b": ArraySpec((a.q_lora_rank, H, qk + a.rope_head_dim),
                          ("lora", "heads", "head_dim"), init="scaled"),
        "wkv_a": ArraySpec((d, a.kv_lora_rank + a.rope_head_dim), ("embed", "lora"), init="scaled"),
        "kv_norm": norm_spec(a.kv_lora_rank),
        "wk_b": ArraySpec((a.kv_lora_rank, H, qk), ("lora", "heads", "head_dim"), init="scaled"),
        "wv_b": ArraySpec((a.kv_lora_rank, H, a.v_head_dim),
                          ("lora", "heads", "head_dim"), init="scaled"),
        "wo": ArraySpec((H, a.v_head_dim, d), ("heads", "head_dim", "embed"), init="scaled"),
    }


def _mla_qkv_latent(params, x, cfg: ModelConfig):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora),
    k_rope (B,S,1,rope)), before rope."""
    a = cfg.mla
    cq = rms_norm(matmul(x, params["wq_a"].to(x.dtype)), params["q_norm"]["scale"],
                  cfg.norm_eps)
    q = proj_heads(cq, params["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :a.nope_head_dim], q[..., a.nope_head_dim:]
    ckv_full = matmul(x, params["wkv_a"].to(x.dtype))
    c_kv = rms_norm(ckv_full[..., :a.kv_lora_rank], params["kv_norm"]["scale"],
                    cfg.norm_eps)
    k_rope = ckv_full[..., a.kv_lora_rank:][:, :, None, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params, x, positions, cfg: ModelConfig, *, window=None,
                  return_latent=False):
    """MLA over the full sequence (train / prefill), K and V materialised
    per head: dense up to :data:`CHUNKED_ATTN_THRESHOLD` tokens (KV = H),
    the long-sequence path above it. With ``return_latent`` also returns
    ``c_kv`` (B,S,kv_lora) and the roped ``k_rope`` (B,S,1,rope), the
    absorbed decode's cache entries."""
    a = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(params, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k_nope = proj_heads(c_kv, params["wk_b"].to(x.dtype))
    v = proj_heads(c_kv, params["wv_b"].to(x.dtype))
    H = cfg.num_heads
    k_rope_h = k_rope.expand(*k_rope.shape[:2], H, a.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    pos1d = positions[0] if positions.dim() == 2 else positions

    def attend(q, k, v):
        if x.shape[1] > CHUNKED_ATTN_THRESHOLD:
            return _long_attention(q, k, v, pos1d, cfg, True, window)
        bias = _mask_bias(pos1d, pos1d, True, window)[None, None]
        return gqa_attend(q, k, v, bias)

    out = _attend(attend, q, k, v)
    out = merge_heads(out, params["wo"].to(x.dtype))
    return (out, c_kv, k_rope) if return_latent else out


def mla_cache_shape(cfg: ModelConfig, batch: int, cache_len: int):
    a = cfg.mla
    phys = cache_len if cfg.attention_window is None else min(cfg.attention_window, cache_len)
    return {
        "c_kv": (cfg.num_layers, batch, phys, a.kv_lora_rank),
        "k_rope": (cfg.num_layers, batch, phys, a.rope_head_dim),
        "slot_pos": (cfg.num_layers, phys),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    shp = mla_cache_shape(cfg, batch, cache_len)
    return {
        "c_kv": torch.zeros(shp["c_kv"], dtype=dtype, device=device),
        "k_rope": torch.zeros(shp["k_rope"], dtype=dtype, device=device),
        "slot_pos": torch.full(shp["slot_pos"], -1, dtype=torch.int32,
                               device=device),
    }


def mla_decode_attention(params, x, layer_cache, pos: int, cfg: ModelConfig):
    """Absorbed-matrix MLA decode: W_UK is folded into the query and W_UV
    applied after the probabilities, so attention runs in the kv_lora-wide
    latent and the cache holds only (kv_lora + rope) per token. x: (B,1,d);
    layer_cache: dict(c_kv (B,P,kv_lora), k_rope (B,P,rope), slot_pos (P,)).

    Returns (out (B,1,d), layer_cache), the cache updated IN PLACE (slot
    ``pos % P``), as :func:`decode_attention`."""
    a = cfg.mla
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv_latent(params, x, cfg)
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    k_rope_new = apply_rope(k_rope_new, posb, cfg.rope_theta)
    ckv, krope, spos = (layer_cache["c_kv"], layer_cache["k_rope"],
                        layer_cache["slot_pos"])
    slot = pos % ckv.shape[1]
    ckv[:, slot] = c_kv_new[:, 0]
    krope[:, slot] = k_rope_new[:, 0, 0]
    spos[slot] = pos
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, params["wk_b"].to(x.dtype))
    s_nope = torch.einsum("bshl,btl->bhst", q_lat, ckv)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, krope)
    scale = 1.0 / math.sqrt(a.nope_head_dim + a.rope_head_dim)
    scores = (s_nope + s_rope).to(torch.float32) * scale
    valid = spos >= 0
    if cfg.attention_window is not None:
        valid = valid & (spos > pos - cfg.attention_window)
    scores = scores + torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btl->bshl", probs, ckv)            # (B,1,H,kv_lora)
    out = torch.einsum("bshl,lhk->bshk", o_lat, params["wv_b"].to(x.dtype))
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return out, layer_cache


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hymba's parallel heads)
# ---------------------------------------------------------------------------

SSM_IMPLS = ("auto", "pallas", "xla")


def ssm_spec(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    dt_rank = s.dt_rank or max(1, d // 16)
    return {
        "w_in": ArraySpec((d, 2 * d_inner), ("embed", "mlp"), init="scaled"),
        "conv_w": ArraySpec((s.conv_kernel, d_inner), ("conv", "mlp"), init="scaled"),
        "conv_b": ArraySpec((d_inner,), ("mlp",), init="zeros"),
        "w_x": ArraySpec((d_inner, dt_rank + 2 * s.state_dim), ("mlp", "lora"), init="scaled"),
        "w_dt": ArraySpec((dt_rank, d_inner), ("lora", "mlp"), init="scaled"),
        "b_dt": ArraySpec((d_inner,), ("mlp",), init="zeros"),
        "A_log": ArraySpec((d_inner, s.state_dim), ("mlp", "ssm_state"), init="zeros"),
        "D": ArraySpec((d_inner,), ("mlp",), init="ones"),
        "w_out": ArraySpec((d_inner, d), ("mlp", "embed"), init="scaled"),
    }


def _ssm_inputs(params, x, cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(1, cfg.d_model // 16)
    xz = matmul(x, params["w_in"].to(x.dtype))
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    return xs, z, d_inner, dt_rank


def _ssm_gates(params, xs_conv, cfg, dt_rank):
    s = cfg.ssm
    dtype = xs_conv.dtype
    proj = matmul(xs_conv, params["w_x"].to(dtype))
    dt_in = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank: dt_rank + s.state_dim]
    Cmat = proj[..., dt_rank + s.state_dim:]
    dt = F.softplus(matmul(dt_in, params["w_dt"].to(dtype)) + params["b_dt"].to(dtype))
    A = -torch.exp(params["A_log"].to(torch.float32))  # (d_inner, N)
    return dt, Bmat, Cmat, A


def _ssm_scan_xla(xc, dt, Bm, Cm, A):
    """The reference's ``lax.scan`` path, step by step in its order:
    ``dt_t * xc_t`` in the input type, then cast to float32."""
    f32 = torch.float32
    h = torch.zeros(xc.shape[0], xc.shape[2], A.shape[1], dtype=f32,
                    device=xc.device)
    ys = []
    for t in range(xc.shape[1]):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[..., None].to(f32) * A)
        dBx = (dt_t * xc[:, t])[..., None].to(f32) * Bm[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(xc.dtype)


def ssm_apply(params, x, cfg: ModelConfig, *, impl: str = "auto",
              return_state=False):
    """Full-sequence selective scan. x: (B,S,d) -> (B,S,d).

    ``impl`` ``"auto"``/``"pallas"`` run the ssm_scan kernel wrapper;
    ``"xla"`` the reference's scan order. With ``return_state`` also returns
    the decode state ``{"h": final state (B,d_inner,N) float32, "conv": the
    last K-1 in-projected inputs (B,K-1,d_inner)}`` (kernel paths only)."""
    if impl not in SSM_IMPLS:
        raise ValueError(f"impl {impl!r} not in {SSM_IMPLS}")
    s = cfg.ssm
    xs, z, d_inner, dt_rank = _ssm_inputs(params, x, cfg)
    # causal depthwise conv
    K = s.conv_kernel
    S = xs.shape[1]
    xs_pad = F.pad(xs, (0, 0, K - 1, 0))
    conv_w = params["conv_w"].to(x.dtype)  # (K, d_inner)
    xc = xs_pad[:, 0:S, :] * conv_w[0]
    for i in range(1, K):
        xc = xc + xs_pad[:, i: i + S, :] * conv_w[i]
    xc = F.silu(xc + params["conv_b"].to(x.dtype))
    dt, Bm, Cm, A = _ssm_gates(params, xc, cfg, dt_rank)

    if impl == "xla":
        if return_state:
            raise ValueError("return_state needs impl 'auto' or 'pallas'")
        y = _ssm_scan_xla(xc, dt, Bm, Cm, A)
    else:
        from repro_torch.kernels.ssm_scan import ops as ssm_ops
        y = ssm_ops.ssm_scan(xc.contiguous(), dt.contiguous(), Bm.contiguous(),
                             Cm.contiguous(), A.contiguous(),
                             return_state=return_state)
        if return_state:
            y, h = y

    y = y + xc * params["D"].to(x.dtype)
    y = y * F.silu(z)
    out = matmul(y, params["w_out"].to(x.dtype))
    if return_state:
        return out, {"h": h, "conv": xs[:, -(K - 1):, :]}
    return out


def ssm_state_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return {
        "h": (cfg.num_layers, batch, d_inner, s.state_dim),
        "conv": (cfg.num_layers, batch, s.conv_kernel - 1, d_inner),
    }


def ssm_decode(params, x, state, cfg: ModelConfig):
    """Single-step SSM decode. x: (B,1,d); state: dict(h (B,d_inner,N),
    conv (B,K-1,d_inner)). Returns (out (B,1,d), new state)."""
    f32 = torch.float32
    xs, z, d_inner, dt_rank = _ssm_inputs(params, x, cfg)
    xs1 = xs[:, 0, :]  # (B, d_inner)
    hist = torch.cat([state["conv"], xs1[:, None, :]], dim=1)  # (B,K,d_inner)
    conv_w = params["conv_w"].to(x.dtype)
    xc = torch.einsum("bkd,kd->bd", hist, conv_w) + params["conv_b"].to(x.dtype)
    xc = F.silu(xc)[:, None, :]  # (B,1,d_inner)
    dt, Bm, Cm, A = _ssm_gates(params, xc, cfg, dt_rank)
    dA = torch.exp(dt[:, 0, :, None].to(f32) * A)
    dBx = (dt[:, 0] * xc[:, 0])[..., None].to(f32) * Bm[:, 0, None, :]
    h = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].to(f32)).to(x.dtype)
    y = y + xc[:, 0] * params["D"].to(x.dtype)
    y = (y * F.silu(z[:, 0]))[:, None, :]
    out = matmul(y, params["w_out"].to(x.dtype))
    return out, {"h": h, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# xLSTM cells (mLSTM matrix memory + sLSTM scalar memory) [arXiv:2405.04517]
# ---------------------------------------------------------------------------
#
# The reference scans each cell over time; here a Python loop over the
# positions runs one step function, shared with decode. Each step keeps the
# reference's float32 order: m_new = max(logsigmoid(f) + m, i), then
# exp(i - m_new) and exp(logsigmoid(f) + m - m_new), with m starting at
# -1e30. ``torch.maximum`` against a 0-d one (not ``clamp``) splits a tie's
# gradient in half as ``jnp.maximum`` does: the sLSTM normaliser n is
# exactly 1 at the first position.

M_INIT = -1e30


def _mlstm_dims(cfg: ModelConfig):
    """(H, d_inner, head dim) of the mLSTM: its head dim is d_inner / H,
    not ``cfg.head_dim``."""
    H = cfg.num_heads
    di = int(cfg.xlstm.proj_factor * cfg.d_model) // H * H
    return H, di, di // H


def mlstm_spec(cfg: ModelConfig):
    d = cfg.d_model
    H, di, dh = _mlstm_dims(cfg)
    return {
        "w_up": ArraySpec((d, 2 * di), ("embed", "mlp"), init="scaled"),
        "wq": ArraySpec((di, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "wk": ArraySpec((di, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "wv": ArraySpec((di, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "w_if": ArraySpec((di, H, 2), ("mlp", "heads", None), init="scaled"),
        "b_if": ArraySpec((H, 2), ("heads", None), init="zeros"),
        "w_down": ArraySpec((di, d), ("mlp", "embed"), init="scaled"),
    }


def _mlstm_inputs(params, x, H):
    """Up-projection and gates, all positions at once: (z, q, k, v float32
    (B,S,H,dh), i_pre, logsigmoid(f_pre) float32 (B,S,H)); q, k, v and the
    gate pre-activations are formed in x's type, as in the reference."""
    di = params["w_down"].shape[0]
    dh = di // H
    up = matmul(x, params["w_up"].to(x.dtype))
    xm, z = up[..., :di], up[..., di:]
    q = proj_heads(xm, params["wq"].to(x.dtype)) / math.sqrt(dh)
    k = proj_heads(xm, params["wk"].to(x.dtype)) / math.sqrt(dh)
    v = proj_heads(xm, params["wv"].to(x.dtype))
    gif = (proj_heads(xm, params["w_if"].to(x.dtype))
           + params["b_if"].to(x.dtype))
    f32 = torch.float32
    return (z, q.to(f32), k.to(f32), v.to(f32), gif[..., 0].to(f32),
            pointwise(F.logsigmoid, gif[..., 1].to(f32)))


def _mlstm_step(state, q_t, k_t, v_t, i_t, lf_t, one):
    """One position: state (C (B,H,dh,dh), n (B,H,dh), m (B,H)) float32 ->
    (new state, h_t (B,H,dh) float32)."""
    C, n, m = state
    a = lf_t + m
    m_new = torch.maximum(a, i_t)
    ig = torch.exp(i_t - m_new)
    fg = torch.exp(a - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * (
        v_t[..., :, None] * k_t[..., None, :])
    n = fg[..., None] * n + ig[..., None] * k_t
    num = torch.einsum("bhvk,bhk->bhv", C, q_t)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)), one)
    return (C, n, m_new), num / den[..., None]


def _mlstm_out(params, h, z, x):
    """h (B,S,H,dh) float32 -> the block's output (B,S,d) in x's type."""
    h = h.to(x.dtype).reshape(*z.shape)
    return matmul(h * F.silu(z), params["w_down"].to(x.dtype))


def mlstm_apply(params, x, cfg: ModelConfig, return_state=False):
    """Full-sequence mLSTM (stabilised exponential gating). x: (B,S,d) ->
    (B,S,d); with ``return_state`` also the final ``{"C", "n", "m"}``
    (the reference's prefill gets it from a second scan)."""
    H, _, dh = _mlstm_dims(cfg)
    z, q, k, v, i_pre, lf = _mlstm_inputs(params, x, H)
    if is_dtensor(q):
        from repro_torch.kernels import _sharded

        hs, *state = _sharded.heads_local(_mlstm_scan, (q, k, v, i_pre, lf), (),
                                          ("bsh", "bh", "bh", "bh"))
    else:
        hs, *state = _mlstm_scan(q, k, v, i_pre, lf)
    out = _mlstm_out(params, hs, z, x)
    if return_state:
        return out, dict(zip(("C", "n", "m"), state))
    return out


def _mlstm_scan(q, k, v, i_pre, lf):
    """The mLSTM over every position from a zero state: (h (B,S,H,dh), C,
    n, m) float32."""
    B, _, H, dh = q.shape
    dev, f32 = q.device, torch.float32
    state = (torch.zeros((B, H, dh, dh), dtype=f32, device=dev),
             torch.zeros((B, H, dh), dtype=f32, device=dev),
             torch.full((B, H), M_INIT, dtype=f32, device=dev))
    one = torch.ones((), dtype=f32, device=dev)
    hs = []
    for t in range(q.shape[1]):
        state, h_t = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                 lf[:, t], one)
        hs.append(h_t)
    return (torch.stack(hs, dim=1), *state)


def mlstm_state_shape(cfg: ModelConfig, batch: int):
    H, _, dh = _mlstm_dims(cfg)
    return {"C": (batch, H, dh, dh), "n": (batch, H, dh), "m": (batch, H)}


def mlstm_decode(params, x, state, cfg: ModelConfig):
    """One position. x: (B,1,d); state: dict(C, n, m). Returns (out
    (B,1,d), new state)."""
    H = cfg.num_heads
    z, q, k, v, i_pre, lf = _mlstm_inputs(params, x, H)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    new, h = _mlstm_step((state["C"], state["n"], state["m"]), q[:, 0], k[:, 0],
                         v[:, 0], i_pre[:, 0], lf[:, 0], one)
    return _mlstm_out(params, h[:, None], z, x), dict(zip(("C", "n", "m"), new))


def slstm_spec(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    return {
        # input projections for i,f,z,o gates
        "w_gates": ArraySpec((d, H, 4 * dh), ("embed", "heads", "head_dim"), init="scaled"),
        "b_gates": ArraySpec((H, 4 * dh), ("heads", "head_dim"), init="zeros"),
        # recurrent (block-diagonal per head) projections
        "r_gates": ArraySpec((H, dh, 4 * dh), ("heads", "head_dim", None), init="scaled"),
        "w_down": ArraySpec((d, d), ("embed", "act_embed"), init="scaled"),
    }


def _promoted_einsum(eq, a, b):
    """``jnp.einsum`` of mixed types: both operands cast to their promoted
    type (``torch.einsum`` refuses mixed types)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _slstm_weights(params, x):
    """The reference's ``wp``: float32 params stay float32, others take x's
    type; the cell's products then run in the promoted type."""
    return {k: v if v.dtype == torch.float32 else v.to(x.dtype)
            for k, v in params.items()}


def _slstm_gx(wp, x):
    """The input half of every position's gates, (B,S,H,4dh)."""
    dt = torch.promote_types(x.dtype, wp["w_gates"].dtype)
    return proj_heads(x.to(dt), wp["w_gates"].to(dt)) + wp["b_gates"]


def _slstm_step(wp, carry, gx_t, one):
    """One position: carry (c, n float32, h in x's type, m float32), each
    (B,H,dh); gx_t (B,H,4dh) -> new carry (h_new in h's type)."""
    c, n, h, m = carry
    gr = _promoted_einsum("bhd,hdk->bhk", h, wp["r_gates"])
    g = (gx_t + gr).to(torch.float32)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(g, 4, dim=-1)
    a = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(a, i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(a - m_new)
    c = fg * c + ig * torch.tanh(z_pre)
    n = fg * n + ig
    h_new = (torch.sigmoid(o_pre) * c / torch.maximum(n, one)).to(h.dtype)
    return c, n, h_new, m_new


def slstm_apply(params, x, cfg: ModelConfig, return_state=False):
    """Full-sequence sLSTM. x: (B,S,d) -> (B,S,d); with ``return_state``
    also the final ``{"c", "n", "h", "m"}``."""
    B, S = x.shape[0], x.shape[1]
    wp = _slstm_weights(params, x)
    gx = _slstm_gx(wp, x)

    def scan(gx, r_gates):
        return _slstm_scan(gx, r_gates, x.dtype)

    if is_dtensor(gx):
        from repro_torch.kernels import _sharded

        hs, *carry = _sharded.heads_local(scan, (gx,), (wp["r_gates"],),
                                          ("bsh", "bh", "bh", "bh", "bh"))
    else:
        hs, *carry = scan(gx, wp["r_gates"])
    out = matmul(hs.reshape(B, S, cfg.d_model), params["w_down"].to(x.dtype))
    if return_state:
        return out, dict(zip(("c", "n", "h", "m"), carry))
    return out


def _slstm_scan(gx, r_gates, dtype):
    """The sLSTM over every position from a zero carry: (h (B,S,H,dh) in
    ``dtype``, c, n, h, m)."""
    B, _, H, dh4 = gx.shape
    dh, dev, f32 = dh4 // 4, gx.device, torch.float32
    carry = (torch.zeros((B, H, dh), dtype=f32, device=dev),
             torch.zeros((B, H, dh), dtype=f32, device=dev),
             torch.zeros((B, H, dh), dtype=dtype, device=dev),
             torch.full((B, H, dh), M_INIT, dtype=f32, device=dev))
    one = torch.ones((), dtype=f32, device=dev)
    hs = []
    for t in range(gx.shape[1]):
        carry = _slstm_step({"r_gates": r_gates}, carry, gx[:, t], one)
        hs.append(carry[2])
    return (torch.stack(hs, dim=1), *carry)


def slstm_state_shape(cfg: ModelConfig, batch: int):
    H = cfg.num_heads
    dh = cfg.d_model // H
    return {"c": (batch, H, dh), "n": (batch, H, dh), "h": (batch, H, dh), "m": (batch, H, dh)}


def slstm_decode(params, x, state, cfg: ModelConfig):
    """One position. x: (B,1,d); state: dict(c, n, h, m). Returns (out
    (B,1,d), new state)."""
    wp = _slstm_weights(params, x)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    carry = _slstm_step(wp, (state["c"], state["n"], state["h"], state["m"]),
                        _slstm_gx(wp, x)[:, 0], one)
    out = matmul(carry[2].reshape(x.shape[0], 1, cfg.d_model),
                 params["w_down"].to(x.dtype))
    return out, dict(zip(("c", "n", "h", "m"), carry))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig):
    return {"embedding": ArraySpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed_tbl"))}


def embed_apply(params, tokens, dtype):
    """Gather the rows, then cast them: the reference casts the whole table
    first, which gives the same values at a table's cost per call. Over
    DTensors, :func:`_embed_sharded`."""
    if is_dtensor(tokens) or is_dtensor(params["embedding"]):
        return _embed_sharded(params["embedding"], tokens).to(dtype)
    return params["embedding"][tokens.long()].to(dtype)


def _embed_sharded(table, tokens):
    """The row gather on each rank's shards, the layout fixed per mesh
    dimension: the tokens' batch split stays (the table whole there, an
    FSDP all-gather if the rules split it; its gradient a sum over the
    ranks); else a vocab split of the table stays, each rank looking up
    the tokens in its own rows (a masked local gather, zeros elsewhere: a
    pending sum, as a vocab-parallel embedding); else a split of the
    table's features stays; anything else is made whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels import _sharded

    mesh = _sharded.mesh_of(table, tokens)
    R = Replicate()
    tpl = tokens.placements if is_dtensor(tokens) else (R,) * mesh.ndim
    wpl = table.placements if is_dtensor(table) else (R,) * mesh.ndim
    rows = []    # (tokens, table, out, table's gradient)
    for tp, wp in zip(tpl, wpl):
        if tp.is_shard(0):
            rows.append((Shard(0), R, Shard(0), Partial()))
        elif wp.is_shard(0):
            rows.append((R, Shard(0), Partial(), Shard(0)))
        elif wp.is_shard(1):
            rows.append((R, Shard(1), Shard(tokens.ndim), Shard(1)))
        else:
            rows.append((R,) * 4)
    t_in, w_in, out, w_grad = (tuple(r[j] for r in rows) for j in range(4))
    split = any(p.is_shard(0) for p in w_in)
    lo = _sharded.shard_offset(table.shape[0], mesh, w_in, 0)

    def lookup(tok, tab):
        idx = tok.long()
        if not split:
            return tab[idx]
        idx = idx - lo
        inside = (idx >= 0) & (idx < tab.shape[0])
        got = tab[torch.where(inside, idx, 0)]
        return torch.where(inside[..., None], got, 0.0)

    return _sharded.run_local(lookup, mesh, (tokens, table), (t_in, w_in), out,
                              (t_in, w_grad))


def head_spec(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": ArraySpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="scaled")}


def head_apply(params, embed_params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        table = embed_params["embedding"].to(x.dtype)
        if not is_dtensor(x):
            return torch.einsum("bsd,vd->bsv", x, table)
        from repro_torch.kernels import _sharded

        return _sharded.local_product(
            lambda a, b: torch.einsum("bsd,vd->bsv", a, b), x, table,
            {0: x.ndim - 1}, {1: x.ndim - 1})
    return matmul(x, params["w"].to(x.dtype))


def cross_entropy_loss(logits, labels, mask=None):
    """logits: (B,S,V); labels: (B,S) integer; mask optional (B,S). The
    float32 ``logsumexp`` minus the label's logit, averaged (over the
    masked positions with ``mask``). DTensor logits whose vocab dimension
    is sharded take :func:`_vocab_parallel_nll`."""
    logits = logits.to(torch.float32)
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# DTensor support (the sharded steps of launch.steps with a mesh)
# ---------------------------------------------------------------------------
#
# Over DTensors most ops shard by DTensor's own rules, and a plain tensor
# (a rope table, a mask) meets them as a replicated one under the step's
# ``implicit_replication``. Where a dimension must be whole for an op that
# has no sharding rule, it is redistributed explicitly (:func:`whole_dims`),
# so the collective shows in ``launch.cost.collective_bytes``.


def whole_dims(x, dims):
    """``x`` with the tensor dimensions ``dims`` unsharded and nothing
    pending (each ``Shard`` of one of them and each ``Partial`` made
    ``Replicate``); a plain tensor, or a DTensor already so, as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.ndim for d in dims}
    want = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
                 else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; over a DTensor on each rank's
    shard, for an op DTensor has no rule for (``logsigmoid``'s backward),
    with a pending sum reduced first."""
    if not is_dtensor(x):
        return fn(x)
    from repro_torch.kernels import _sharded
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return _sharded.run_local(fn, x.device_mesh, (x,), (pl,), pl)


def batch_layout(x):
    """The activations' layout on a mesh, read off a batch-leading DTensor
    (the tokens): ``Shard(0)`` where ``x`` shards its batch, ``Replicate()``
    elsewhere (the rules' activation axes: only ``batch`` is sharded). None
    for a plain tensor."""
    if not is_dtensor(x):
        return None
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if p.is_shard(0) else Replicate() for p in x.placements)


def to_layout(x, layout):
    """``x`` redistributed to ``layout`` (from :func:`batch_layout`); a
    plain tensor, or no layout, as it is. The decoders hold each layer's
    input to it, so DTensor's choices inside a layer start from the
    rules' layout instead of drifting from layer to layer."""
    if layout is None or not is_dtensor(x) or tuple(x.placements) == layout:
        return x
    return x.redistribute(x.device_mesh, layout)


def proj_heads(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``: x (B,S,d) into heads through w
    (d,H,k); over DTensors on each rank's shards
    (``kernels._sharded.local_product``: the batch or the heads split)."""
    if not is_dtensor(x) and not is_dtensor(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from repro_torch.kernels import _sharded

    n = x.ndim
    return _sharded.local_product(
        lambda a, b: torch.einsum("bsd,dhk->bshk", a, b), x, w,
        {1: n - 1, 2: n}, {0: n - 1})


def merge_heads(x, w):
    """``einsum("bshk,hkd->bsd", x, w)``: heads x (B,S,H,k) back through w
    (H,k,d); over DTensors on each rank's shards, a heads split giving a
    pending sum."""
    if not is_dtensor(x) and not is_dtensor(w):
        return torch.einsum("bshk,hkd->bsd", x, w)
    from repro_torch.kernels import _sharded

    n = x.ndim
    return _sharded.local_product(
        lambda a, b: torch.einsum("bshk,hkd->bsd", a, b), x, w,
        {2: n - 2}, {0: n - 2, 1: n - 1})


def matmul(x, w):
    """``x @ w`` for x (..., d) and w (d, f); over DTensors on each rank's
    shards (the batch or f split; d split gives a pending sum)."""
    if not is_dtensor(x) and not is_dtensor(w):
        return x @ w
    from repro_torch.kernels import _sharded

    return _sharded.local_product(lambda a, b: a @ b, x, w,
                                  {1: x.ndim - 1}, {0: x.ndim - 1})


def _all_reduce(t, op: str, groups):
    """``t`` all-reduced (``op``) over each process group of ``groups`` in
    turn, through the functional collectives."""
    import torch.distributed._functional_collectives as funcol

    for group in groups:
        t = funcol.all_reduce(t, op, group)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _VocabNLL(torch.autograd.Function):
    """``logsumexp(x) - x[label]`` over a vocab shard ``x`` (..., Vl) whose
    first index is ``lo``: the max, the sum of exponentials and the label's
    logit (from the one shard that holds it; 0 elsewhere) all-reduced over
    ``groups``. It is ``torch.logsumexp``'s arithmetic and the gather's,
    in their order, forward and backward: over one shard the same bits."""

    @staticmethod
    def forward(ctx, x, labels, lo, groups):
        m = torch.amax(x, dim=-1, keepdim=True)
        m = _all_reduce(m, "max", groups)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = _all_reduce(torch.sum(torch.exp(x - m), dim=-1), "sum", groups)
        lse = torch.log(s) + m[..., 0]
        idx = labels - lo
        inside = (idx >= 0) & (idx < x.shape[-1])
        idx = torch.where(inside, idx, 0)
        ll = torch.gather(x, -1, idx[..., None])[..., 0]
        ll = _all_reduce(torch.where(inside, ll, 0.0), "sum", groups)
        ctx.save_for_backward(x, lse, idx, inside)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, inside = ctx.saved_tensors
        grad = g[..., None] * torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None, None


def _vocab_parallel_nll(logits, labels):
    """Per-position NLL of DTensor ``logits`` (B,S,V) float32 as
    ``loss_parallel`` computes it: the vocab stays sharded, each rank takes
    the label's logit from its own shard by a masked local gather, and
    all-reduces over the vocab's mesh dimensions combine the shards
    (:class:`_VocabNLL`). ``logits`` is first laid out as ``labels`` on the
    mesh dimensions that shard the labels, its vocab shards kept elsewhere.
    Returns a DTensor placed as ``labels``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import _sharded

    mesh = logits.device_mesh
    V = logits.ndim - 1
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = tuple(p if p.is_shard() else Replicate() for p in labels.placements)
    want = tuple(lp if lp.is_shard() else (xp if xp.is_shard(V) else Replicate())
                 for lp, xp in zip(lab, logits.placements))
    logits = logits.redistribute(mesh, want)
    labels = labels.redistribute(mesh, lab)
    offset = _sharded.shard_offset(logits.shape[V], mesh, want, V)
    groups = [mesh.get_group(i) for i, p in enumerate(want) if p.is_shard(V)]
    nll = _VocabNLL.apply(logits.to_local(), labels.to_local().long(),
                          offset, groups)
    return DTensor.from_local(nll, mesh, lab, run_check=False,
                              shape=labels.shape, stride=labels.stride())
