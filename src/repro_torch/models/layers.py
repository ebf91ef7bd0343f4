"""Neural-net layers of the model zoo (counterpart of ``repro.models.layers``),
as far as the ``dense`` (qwen2) and ``hybrid`` (hymba) families, their
decode and their training need them: plain
functions over the reference's params dict, with its names, shapes and
layouts (q/k/v ``(B, S, H, hd)``, caches keyed as in JAX).

Routing to the kernels:

  * :func:`self_attention` — ``attn_impl`` ``"auto"`` and ``"pallas"`` run
    the CUDA flash-attention kernel for CUDA tensors
    (``kernels.flash_attention.ops``); on the CPU ``"auto"`` and ``"full"``
    run :func:`gqa_attend` (``"pallas"`` the kernel wrapper's plain
    version); ``"full"`` is dense on any device;
  * :func:`ssm_apply` — ``impl`` ``"auto"`` and ``"pallas"`` run
    ``kernels.ssm_scan.ops.ssm_scan`` (the CUDA kernel on the card, its plain
    version on the CPU); ``"xla"`` is the reference's own ``lax.scan`` step
    order, ``dt*x`` formed in the input type (``layers.py:723`` there).

Weights are float32 and cast to the activation type at each use, as the
reference does (``.astype(x.dtype)``); the embedding table is gathered
first and the rows cast, which gives the same values without casting the
whole table. Not ported yet: MoE, MLA, xLSTM and cross-attention (ROADMAP
Queue A item 9 (a)), and the long-sequence ``flash_mha`` / ``chunked_attend``
(item 9 (b)).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import ArraySpec

_NOT_PORTED = ("ROADMAP Queue A item 9 (b): the long-sequence attention paths "
               "(flash_mha, chunked_attend) are not ported yet")

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


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
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
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


def self_attention(params, x, positions, cfg: ModelConfig, *, causal=True,
                   window=None, attn_impl: str = "auto", return_kv=False):
    """Full-sequence self-attention (prefill). x: (B,S,d); positions (S,).

    With ``return_kv`` also returns the roped k and v (B,S,KV,hd), which
    prefill lays into the cache (the reference recomputes them)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    S = x.shape[1]
    on_card = x.device.type == "cuda"
    if attn_impl == "chunked" or (attn_impl == "auto" and not on_card
                                  and S > CHUNKED_ATTN_THRESHOLD):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} at S={S} on {x.device.type}: {_NOT_PORTED}")
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if attn_impl == "pallas" or (attn_impl == "auto" and on_card):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)
    else:
        pos1d = positions[0] if positions.dim() == 2 else positions
        bias = _mask_bias(pos1d, pos1d, causal, window)[None, None]
        out = gqa_attend(q, k, v, bias)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
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
    out = gqa_attend(q, ck, cv, bias)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return out, layer_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d: int, f: int):
    """The gated (SwiGLU) MLP; the reference's ungated GELU variant serves
    the encdec family, not ported yet."""
    return {
        "w_gate": ArraySpec((d, f), ("embed", "mlp"), init="scaled"),
        "w_up": ArraySpec((d, f), ("embed", "mlp"), init="scaled"),
        "w_down": ArraySpec((f, d), ("mlp", "embed"), init="scaled"),
    }


def mlp_apply(params, x):
    g = F.silu(x @ params["w_gate"].to(x.dtype))
    u = x @ params["w_up"].to(x.dtype)
    return (g * u) @ params["w_down"].to(x.dtype)


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
    xz = x @ params["w_in"].to(x.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    return xs, z, d_inner, dt_rank


def _ssm_gates(params, xs_conv, cfg, dt_rank):
    s = cfg.ssm
    dtype = xs_conv.dtype
    proj = xs_conv @ params["w_x"].to(dtype)
    dt_in = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank: dt_rank + s.state_dim]
    Cmat = proj[..., dt_rank + s.state_dim:]
    dt = F.softplus(dt_in @ params["w_dt"].to(dtype) + params["b_dt"].to(dtype))
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
    out = y @ params["w_out"].to(x.dtype)
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
    out = y @ params["w_out"].to(x.dtype)
    return out, {"h": h, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig):
    return {"embedding": ArraySpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed_tbl"))}


def embed_apply(params, tokens, dtype):
    """Gather the rows, then cast them: the reference casts the whole table
    first, which gives the same values at a table's cost per call."""
    return params["embedding"][tokens.long()].to(dtype)


def head_spec(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": ArraySpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="scaled")}


def head_apply(params, embed_params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, embed_params["embedding"].to(x.dtype))
    return x @ params["w"].to(x.dtype)


def cross_entropy_loss(logits, labels, mask=None):
    """logits: (B,S,V); labels: (B,S) integer; mask optional (B,S). The
    float32 ``logsumexp`` minus the label's logit, averaged (over the
    masked positions with ``mask``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
