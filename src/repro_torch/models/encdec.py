"""Encoder-decoder transformer (counterpart of ``repro.models.encdec``): the
seamless-m4t-large-v2 backbone. The mel-spectrogram + conv frontend is
stubbed, as in the reference: the source is frame embeddings (B, Ssrc, d)
(:func:`source_embeds`). A bidirectional encoder over the frames, then an
autoregressive text decoder with cross-attention.

Public API, as the reference's:
  model_spec / init_params(cfg, key)                    -- params from a key
  encode(cfg, params, src_embeds)                       -- encoder output
  forward(cfg, params, src_embeds, tgt_tokens)          -- logits
  loss_fn(cfg, params, batch)                           -- training loss
  prefill(cfg, params, src_embeds, tgt_tokens, cache_len=...)
  decode_step(cfg, params, cache, token, pos)           -- one token
  init_cache(cfg, batch, cache_len, src_len=...)        -- self K/V + cross K/V
  param_axes / abstract_params(cfg)                     -- logical axes, meta
  cache_axes(cfg, context_parallel) / abstract_cache    -- the cache's axes, meta

The layer loops are the decoder's (each stacked leaf unbound once; each
layer through ``decoder.apply_layer``, its remat under ``cfg.remat``),
and so is the self-attention cache layout (``decoder._to_cache_layout``).
On the card the encoder's (non-causal) and the decoder's (causal)
self-attention run the flash kernel; the cross-attention is dense, as in the
reference. Each decoder layer's cross K/V are computed once from the
encoder output (the reference's prefill computes them twice: the same
values), and ``decode_step`` reads them from the cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import decoder
from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.models.config import ModelConfig


def enc_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "ln1": L.norm_spec(d),
        "attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(d),
        "mlp": L.mlp_spec(d, cfg.d_ff, gated=False),
    }


def dec_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "ln1": L.norm_spec(d),
        "self_attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(d),
        "cross_attn": L.attention_spec(cfg),
        "ln3": L.norm_spec(d),
        "mlp": L.mlp_spec(d, cfg.d_ff, gated=False),
    }


def model_spec(cfg: ModelConfig):
    ed = cfg.encdec
    return {
        "enc_blocks": S.stack_layers(enc_block_spec(cfg), ed.enc_layers),
        "enc_norm": L.norm_spec(cfg.d_model),
        "embed": L.embed_spec(cfg),
        "dec_blocks": S.stack_layers(dec_block_spec(cfg), ed.dec_layers),
        "final_norm": L.norm_spec(cfg.d_model),
        "head": L.head_spec(cfg),
    }


def init_params(cfg: ModelConfig, key, device=DEFAULT_DEVICE):
    """The reference's ``init_params(cfg, key)`` on ``device`` (see
    ``decoder.init_params``)."""
    return S.init_params_from_key(model_spec(cfg), key, resolve_device(device))


def param_axes(cfg: ModelConfig):
    """Each parameter's logical axes (``sharding.rules`` maps them)."""
    return S.axes_tree(model_spec(cfg))


def abstract_params(cfg: ModelConfig):
    """The params tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return S.abstract_params(model_spec(cfg))


def source_embeds(cfg: ModelConfig, batch: int, src_len: int, key):
    """The stubbed speech frontend's frame embeddings, (batch, src_len,
    d_model): ``0.1 * normal(key)`` in the activation type, as the reference
    launchers draw them (``decoder.stub_embeds``)."""
    return decoder.stub_embeds(cfg, (batch, src_len, cfg.d_model), key)


def _run_layers(cfg: ModelConfig, block, blocks, x, *args):
    """``x = block(cfg, p, x, *args)`` for every layer of the stacked tree
    ``blocks`` (``decoder.apply_layer``'s remat)."""
    for p in decoder._layers(blocks):
        x = decoder.apply_layer(cfg, block, p, x, *args)
    return x


def _enc_block(cfg: ModelConfig, p, x, positions, attn_impl):
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    x = x + L.self_attention(p["attn"], h, positions, cfg, causal=False,
                             attn_impl=attn_impl)
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, gated=False)


def encode(cfg: ModelConfig, params, src_embeds, attn_impl="auto"):
    """src_embeds: (B, Ssrc, d) from the stubbed frontend -> (B, Ssrc, d)."""
    x = src_embeds.to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _run_layers(cfg, _enc_block, params["enc_blocks"], x, positions,
                    attn_impl)
    return L.rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, p, x, positions, enc_out, src_valid,
               attn_impl, with_cache=False):
    """One decoder block. With ``with_cache`` returns (x, {"self_kv": (k,
    v), "cross": {"k", "v"}}): the roped self-attention K/V and this
    layer's cross K/V."""
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a = L.self_attention(p["self_attn"], h, positions, cfg, causal=True,
                         window=cfg.attention_window, attn_impl=attn_impl,
                         return_kv=with_cache)
    if with_cache:
        a, k, v = a
    x = x + a
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    ck = torch.einsum("btd,dhk->bthk", enc_out, p["cross_attn"]["wk"].to(x.dtype))
    cv = torch.einsum("btd,dhk->bthk", enc_out, p["cross_attn"]["wv"].to(x.dtype))
    x = x + L.cross_attention(p["cross_attn"], h, ck, cv, src_valid, cfg)
    h = L.rms_norm(x, p["ln3"]["scale"], cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, gated=False)
    if with_cache:
        return x, {"self_kv": (k, v), "cross": {"k": ck, "v": cv}}
    return x


def _embed_target(cfg: ModelConfig, params, enc_out, tgt_tokens):
    """(embedded target, its positions, src_valid: every frame valid)."""
    x = L.embed_apply(params["embed"], tgt_tokens, cfg.activation_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    src_valid = torch.ones(enc_out.shape[:2], dtype=torch.bool,
                           device=enc_out.device)
    return x, positions, src_valid


def forward(cfg: ModelConfig, params, src_embeds, tgt_tokens, attn_impl="auto"):
    """Logits (B, Stgt, V) of the target tokens given the source frames."""
    enc_out = encode(cfg, params, src_embeds, attn_impl)
    x, positions, src_valid = _embed_target(cfg, params, enc_out, tgt_tokens)
    x = _run_layers(cfg, _dec_block, params["dec_blocks"], x, positions,
                    enc_out, src_valid, attn_impl)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return L.head_apply(params.get("head", {}), params["embed"], x, cfg)


def loss_fn(cfg: ModelConfig, params, batch, attn_impl="auto"):
    """batch: dict(src_embeds (B,Ssrc,d), tokens (B,S), labels (B,S)
    [, loss_mask (B,S)]). Returns ``(ce, {"ce": ce, "aux": 0})``."""
    logits = forward(cfg, params, batch["src_embeds"], batch["tokens"], attn_impl)
    ce = L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# --- serving -----------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               src_len: int = 1, device=DEFAULT_DEVICE):
    """The decoder's self-attention K/V ring buffer and every layer's cross
    K/V (``src_len`` frames; prefill fills both), keyed as the reference's."""
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    Ld = cfg.encdec.dec_layers
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.attention_window
    phys = cache_len if window is None else min(window, cache_len)

    def zeros(n):
        return torch.zeros((Ld, batch, n, KV, hd), dtype=dtype, device=dev)

    return {
        "self_kv": {"k": zeros(phys), "v": zeros(phys),
                    "slot_pos": torch.full((Ld, phys), -1, dtype=torch.int32,
                                           device=dev)},
        "cross": {"k": zeros(src_len), "v": zeros(src_len)},
    }


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
                   src_len: int = 1):
    """:func:`init_cache`'s tree as ``meta`` tensors."""
    return init_cache(cfg, batch, cache_len, dtype, src_len, device="meta")


def cache_axes(cfg: ModelConfig, context_parallel: bool = False):
    """Logical axes of the cache tree; ``context_parallel`` as in
    ``decoder.cache_axes`` (the cross K/V's source frames shard with it)."""
    seq_ax = "batch" if context_parallel else None
    bt_ax = None if context_parallel else "batch"
    kv = ("layers", bt_ax, seq_ax, "kv_heads", "head_dim")
    return {"self_kv": {"k": kv, "v": kv, "slot_pos": ("layers", seq_ax)},
            "cross": {"k": kv, "v": kv}}


def prefill(cfg: ModelConfig, params, src_embeds, tgt_tokens, attn_impl="auto",
            cache_len: Optional[int] = None):
    """Encode the source, run the decoder over the target prefix and keep
    its K/V. Returns (logits of the last position (B,1,V), cache)."""
    enc_out = encode(cfg, params, src_embeds, attn_impl)
    x, positions, src_valid = _embed_target(cfg, params, enc_out, tgt_tokens)
    Stot = x.shape[1]
    cache_len = cache_len or Stot
    if cache_len < Stot:
        raise ValueError(f"cache_len {cache_len} < prompt length {Stot}")
    window = cfg.attention_window
    phys = cache_len if window is None else min(window, cache_len)
    entries = []
    for p in decoder._layers(params["dec_blocks"]):
        x, e = _dec_block(cfg, p, x, positions, enc_out, src_valid, attn_impl,
                          with_cache=True)
        (kc, vc), sp = decoder._to_cache_layout(list(e["self_kv"]), positions,
                                                phys, Stot)
        e["self_kv"] = {"k": kc, "v": vc, "slot_pos": sp}
        entries.append(e)
    cache = pt.tree_map(lambda *cs: torch.stack(cs), *entries)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.head_apply(params.get("head", {}), params["embed"], x[:, -1:, :], cfg)
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """One decoder step over the frozen cross K/V. token: (B,1) integer;
    pos: int. Returns (logits (B,1,V), cache), the self-attention cache
    updated in place (``layers.decode_attention``)."""
    pos = int(pos)
    x = L.embed_apply(params["embed"], token, cfg.activation_dtype)
    cross = cache["cross"]
    src_valid = torch.ones((x.shape[0], cross["k"].shape[2]), dtype=torch.bool,
                           device=x.device)
    for i, p in enumerate(decoder._layers(params["dec_blocks"])):
        h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        a, _ = L.decode_attention(p["self_attn"], h,
                                  pt.tree_map(lambda t: t[i], cache["self_kv"]),
                                  pos, cfg)
        x = x + a
        h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + L.cross_attention(p["cross_attn"], h, cross["k"][i],
                                  cross["v"][i], src_valid, cfg)
        h = L.rms_norm(x, p["ln3"]["scale"], cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h, gated=False)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.head_apply(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache
