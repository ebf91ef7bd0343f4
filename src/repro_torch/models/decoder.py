"""Decoder-only LM of the model zoo (counterpart of ``repro.models.decoder``),
ported for the families:

  * ``dense`` (qwen2, mistral, command-r): attention, then a gated MLP;
  * ``vlm`` (internvl2): the dense block over patch embeddings prepended to
    the tokens (the vision frontend is stubbed, as in the reference);
  * ``moe`` (phi3.5-moe: attention; deepseek-v2: MLA), then a routed MoE
    whose load-balance loss is summed over the layers;
  * ``hybrid`` (hymba): attention and a Mamba branch in parallel, then a
    gated MLP;
  * ``ssm`` (xLSTM): an mLSTM and an sLSTM cell, no attention; both run in
    every layer and a per-layer flag picks one (every ``slstm_every``-th
    layer the sLSTM), as in the reference.

The encoder-decoder (``audio``) is ``repro_torch.models.encdec``.

Public API, as the reference's:
  model_spec / init_params(cfg, key)              -- params from a key
  forward(cfg, params, tokens)                    -- logits over a sequence
  loss_fn(cfg, params, batch)                     -- training loss
  prefill(cfg, params, tokens, cache_len=...)     -- prompt -> (logits, cache)
  decode_step(cfg, params, cache, token, pos)     -- one token
  init_cache(cfg, batch, cache_len)               -- KV / MLA ring buffer (+ SSM state)
  param_axes / abstract_params(cfg)               -- logical axes, meta tensors
  cache_axes(cfg, context_parallel)               -- the cache's logical axes
  abstract_cache(cfg, batch, cache_len)           -- init_cache on ``meta``
  image_embeds(cfg, batch, key)                   -- a vlm batch's patch stub

The reference scans over the stacked layer axis; the port loops over it,
unbinding each stacked leaf once so that the backward stacks the layers'
gradients in one allocation. With ``cfg.remat`` and gradients enabled each
layer runs under ``torch.utils.checkpoint`` (the reference's per-layer
``jax.checkpoint``): its activations are recomputed in the backward, which
launches its kernels a second time; the results are unchanged.
The reference's prefill recomputes each layer's cache entries (K/V, MLA's
latent, the final SSM, mLSTM and sLSTM states by a second scan); here the
forward returns them (the ssm_scan kernel returns the state with ``y``, the
xLSTM loops their last carry).
``decode_step`` updates the cache in place (see ``layers.decode_attention``).
Over DTensors each layer's input is held to the tokens' batch layout
(``layers.to_layout``), so every layer issues the same collectives.
:func:`params_from_numpy` / :func:`params_to_numpy` carry weights across
packages: the JAX tree's paths and shapes, unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.forecaster import params_from_numpy, params_to_numpy  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.models.config import ModelConfig

FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm")


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"the decoder does not handle family {cfg.family!r} "
                         f"({cfg.name}; the encoder-decoder is models.encdec); "
                         f"its families: {FAMILIES}")


def _uses_mla(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" and cfg.mla is not None


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig):
    _check_family(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": L.norm_spec(d), "mlstm": L.mlstm_spec(cfg),
                "ln2": L.norm_spec(d), "slstm": L.slstm_spec(cfg)}
    spec = {
        "ln1": L.norm_spec(d),
        "attn": L.mla_spec(cfg) if _uses_mla(cfg) else L.attention_spec(cfg),
        "ln2": L.norm_spec(d),
    }
    if cfg.family == "moe":
        spec["moe"] = L.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(d, cfg.d_ff)
    if cfg.family == "hybrid":
        spec["ssm"] = L.ssm_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig):
    return {
        "embed": L.embed_spec(cfg),
        "blocks": S.stack_layers(block_spec(cfg), cfg.num_layers),
        "final_norm": L.norm_spec(cfg.d_model),
        "head": L.head_spec(cfg),
    }


def init_params(cfg: ModelConfig, key, device=DEFAULT_DEVICE):
    """The reference's ``init_params(cfg, key)``: one key per leaf, the same
    draws up to ``erfinv``'s last ulps (``repro_torch.random.normal``),
    made on ``device``."""
    return S.init_params_from_key(model_spec(cfg), key, resolve_device(device))


def param_axes(cfg: ModelConfig):
    """Each parameter's logical axes (``sharding.rules`` maps them)."""
    return S.axes_tree(model_spec(cfg))


def abstract_params(cfg: ModelConfig):
    """The params tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return S.abstract_params(model_spec(cfg))


def _layer_flags(cfg: ModelConfig):
    """Per-layer scalar flags: for ``ssm`` 1.0 on every ``slstm_every``-th
    layer (the sLSTM's), else 0.0; zeros for the other families."""
    if cfg.family == "ssm":
        k = cfg.xlstm.slstm_every
        return [float(i % k == k - 1) for i in range(cfg.num_layers)]
    return [0.0] * cfg.num_layers


def _layers(blocks):
    """Every layer's params from a stacked tree: each leaf unbound once."""
    pairs = pt.flatten_with_paths(blocks)
    parts = [leaf.unbind(0) for _, leaf in pairs]
    return [pt.unflatten([(path, part[i]) for (path, _), part in zip(pairs, parts)])
            for i in range(len(parts[0]))]


# ---------------------------------------------------------------------------
# Blocks — full sequence (prefill)
# ---------------------------------------------------------------------------


def _attention(cfg: ModelConfig, p, h, positions, attn_impl, with_cache):
    """The block's attention. Returns (a, cache entries): ``{"kv": (k, v)}``
    or, for MLA, ``{"mla": (c_kv, roped k_rope)}`` with ``with_cache``, else
    ``{}``."""
    if _uses_mla(cfg):
        a = L.mla_attention(p, h, positions, cfg, window=cfg.attention_window,
                            return_latent=with_cache)
        if not with_cache:
            return a, {}
        a, c_kv, k_rope = a
        return a, {"mla": (c_kv, k_rope[:, :, 0, :])}
    a = L.self_attention(p, h, positions, cfg, window=cfg.attention_window,
                         attn_impl=attn_impl, return_kv=with_cache)
    if not with_cache:
        return a, {}
    a, k, v = a
    return a, {"kv": (k, v)}


def _xlstm_mix(x, m_out, s_out, flag):
    """``x + ((1 - flag) * m_out + flag * s_out)`` with the blend in float32
    (the reference's flag is a float32 array), cast to x's type. Both cells
    stay in the graph, so the unused one's params get zero gradients."""
    f32 = torch.float32
    return x + ((1.0 - flag) * m_out.to(f32) + flag * s_out.to(f32)).to(x.dtype)


def _block_apply(cfg: ModelConfig, p, x, positions, flag, attn_impl,
                 with_cache=False):
    """One block over the full sequence. Returns (x, aux), and with
    ``with_cache`` (x, aux, cache entries {"kv": (k, v)} or {"mla": (c_kv,
    k_rope)} [, "ssm": state], or for ``ssm`` {"mlstm": state, "slstm":
    state})."""
    _check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        m_out = L.mlstm_apply(p["mlstm"], h, cfg, return_state=with_cache)
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        s_out = L.slstm_apply(p["slstm"], h2, cfg, return_state=with_cache)
        if not with_cache:
            return _xlstm_mix(x, m_out, s_out, flag), aux
        (m_out, m_state), (s_out, s_state) = m_out, s_out
        return (_xlstm_mix(x, m_out, s_out, flag), aux,
                {"mlstm": m_state, "slstm": s_state})
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a, entries = _attention(cfg, p["attn"], h, positions, attn_impl, with_cache)
    if cfg.family == "hybrid":
        s = L.ssm_apply(p["ssm"], h, cfg, return_state=with_cache)
        if with_cache:
            s, entries["ssm"] = s
        x = x + 0.5 * (a + s)
    else:
        x = x + a
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = L.moe_apply(p["moe"], h, cfg)
        x = x + y
    else:
        x = x + L.mlp_apply(p["mlp"], h)
    return (x, aux, entries) if with_cache else (x, aux)


def apply_layer(cfg: ModelConfig, block, p, *args):
    """``block(cfg, p, *args)`` for one layer's params ``p``, under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and gradients are on: the
    remat policy of every family's layer loop."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, cfg, p, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return block(cfg, p, *args)


def forward_hidden(cfg: ModelConfig, params, x, positions, attn_impl="auto"):
    """Run the block stack. x: (B,S,d) already embedded."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layout = L.batch_layout(x)
    for p, flag in zip(_layers(params["blocks"]), _layer_flags(cfg)):
        x, aux = apply_layer(cfg, _block_apply, p, x, positions, flag, attn_impl)
        x = L.to_layout(x, layout)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, aux_total


def stub_embeds(cfg: ModelConfig, shape, key):
    """A stubbed frontend's output: ``0.1 * normal(key, shape)`` drawn and
    scaled in the activation type, bit for bit the reference launchers'
    draw (float32 up to ``erfinv``'s last ulps; see ``random.normal``)."""
    dtype = cfg.activation_dtype
    return R.normal(key, shape, dtype=dtype) * torch.tensor(
        0.1, dtype=dtype, device=key.device)


def image_embeds(cfg: ModelConfig, batch: int, key):
    """The stubbed vision frontend's patch embeddings for a ``vlm`` config,
    (batch, num_patches, d_model) (:func:`stub_embeds`)."""
    return stub_embeds(cfg, (batch, cfg.vlm.num_patches, cfg.d_model), key)


def embed_inputs(cfg: ModelConfig, params, tokens, img_embeds=None):
    """Token embedding; for ``vlm``, the patch embeddings ``img_embeds``
    (B, num_patches, d) prepended (the stubbed vision frontend's output)."""
    _check_family(cfg)
    dtype = cfg.activation_dtype
    x = L.embed_apply(params["embed"], tokens, dtype)
    if cfg.family == "vlm":
        if img_embeds is None:
            raise ValueError("the vlm family requires img_embeds")
        x = torch.cat([img_embeds.to(dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params, tokens, img_embeds=None, attn_impl="auto"):
    x = L.to_layout(embed_inputs(cfg, params, tokens, img_embeds),
                    L.batch_layout(tokens))
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = forward_hidden(cfg, params, x, positions, attn_impl)
    logits = L.head_apply(params.get("head", {}), params["embed"], x, cfg)
    return logits, aux


def loss_fn(cfg: ModelConfig, params, batch, attn_impl="auto"):
    """batch: dict(tokens (B,S), labels (B,S) [, img_embeds (B,P,d)]
    [, loss_mask (B,S)]). For ``vlm`` the image-prefix positions carry no
    loss (labels align to the text). Returns ``(ce + aux, {"ce": ce,
    "aux": aux})``, ``aux`` the MoE load-balance loss summed over layers."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("img_embeds"), attn_impl)
    if cfg.family == "vlm":
        logits = logits[:, cfg.vlm.num_patches:, :]
    ce = L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Cache / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=DEFAULT_DEVICE):
    """Layer-leading cache tree, keyed as the reference's."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    if cfg.family == "ssm":
        Lc, f32 = cfg.num_layers, torch.float32
        mshp = L.mlstm_state_shape(cfg, batch)
        sshp = L.slstm_state_shape(cfg, batch)
        return {
            "mlstm": {
                "C": torch.zeros((Lc,) + mshp["C"], dtype=f32, device=dev),
                "n": torch.zeros((Lc,) + mshp["n"], dtype=f32, device=dev),
                "m": torch.full((Lc,) + mshp["m"], L.M_INIT, dtype=f32, device=dev),
            },
            "slstm": {
                "c": torch.zeros((Lc,) + sshp["c"], dtype=f32, device=dev),
                "n": torch.zeros((Lc,) + sshp["n"], dtype=f32, device=dev),
                "h": torch.zeros((Lc,) + sshp["h"], dtype=dtype, device=dev),
                "m": torch.full((Lc,) + sshp["m"], L.M_INIT, dtype=f32, device=dev),
            },
        }
    if _uses_mla(cfg):
        cache = {"mla": L.init_mla_cache(cfg, batch, cache_len, dtype, dev)}
    else:
        cache = {"kv": L.init_kv_cache(cfg, batch, cache_len, dtype, dev)}
    if cfg.family == "hybrid":
        shp = L.ssm_state_shape(cfg, batch)
        cache["ssm"] = {
            "h": torch.zeros(shp["h"], dtype=torch.float32, device=dev),
            "conv": torch.zeros(shp["conv"], dtype=dtype, device=dev),
        }
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None):
    """:func:`init_cache`'s tree as ``meta`` tensors."""
    return init_cache(cfg, batch, cache_len, dtype, device="meta")


def cache_axes(cfg: ModelConfig, context_parallel: bool = False):
    """Logical axes of the cache tree. ``context_parallel`` shards the cache
    sequence over the batch rule's mesh axes instead of the batch (batch 1
    at long_500k), as the reference decides (``decoder.py:254`` there)."""
    _check_family(cfg)
    seq_ax = "batch" if context_parallel else None
    bt_ax = None if context_parallel else "batch"
    if cfg.family == "ssm":
        return {
            "mlstm": {"C": ("layers", bt_ax, "heads", "head_dim", None),
                      "n": ("layers", bt_ax, "heads", "head_dim"),
                      "m": ("layers", bt_ax, "heads")},
            "slstm": {name: ("layers", bt_ax, "heads", "head_dim")
                      for name in ("c", "n", "h", "m")},
        }
    if _uses_mla(cfg):
        ax = {"mla": {"c_kv": ("layers", bt_ax, seq_ax, "lora"),
                      "k_rope": ("layers", bt_ax, seq_ax, "head_dim"),
                      "slot_pos": ("layers", seq_ax)}}
    else:
        ax = {"kv": {"k": ("layers", bt_ax, seq_ax, "kv_heads", "head_dim"),
                     "v": ("layers", bt_ax, seq_ax, "kv_heads", "head_dim"),
                     "slot_pos": ("layers", seq_ax)}}
    if cfg.family == "hybrid":
        ax["ssm"] = {"h": ("layers", bt_ax, "mlp", "ssm_state"),
                     "conv": ("layers", bt_ax, "conv", "mlp")}
    return ax


def _block_decode(cfg: ModelConfig, p, x, layer_cache, pos, flag):
    _check_family(cfg)
    new_cache = {}
    if cfg.family == "ssm":
        h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        m_out, new_cache["mlstm"] = L.mlstm_decode(p["mlstm"], h,
                                                   layer_cache["mlstm"], cfg)
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        s_out, new_cache["slstm"] = L.slstm_decode(p["slstm"], h2,
                                                   layer_cache["slstm"], cfg)
        return _xlstm_mix(x, m_out, s_out, flag), new_cache
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if _uses_mla(cfg):
        a, new_cache["mla"] = L.mla_decode_attention(p["attn"], h,
                                                     layer_cache["mla"], pos, cfg)
    else:
        a, new_cache["kv"] = L.decode_attention(p["attn"], h, layer_cache["kv"],
                                                pos, cfg)
    if cfg.family == "hybrid":
        s, new_cache["ssm"] = L.ssm_decode(p["ssm"], h, layer_cache["ssm"], cfg)
        x = x + 0.5 * (a + s)
    else:
        x = x + a
    h = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if cfg.family == "moe":
        # the decode batch is one dispatch group of B tokens, so its
        # capacity (and which tokens drop) is not the prefill's
        y, _ = L.moe_apply(p["moe"], h, cfg)
        x = x + y
    else:
        x = x + L.mlp_apply(p["mlp"], h)
    return x, new_cache


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """One autoregressive step. token: (B,1) integer; pos: int. Returns
    (logits (B,1,V), cache), the cache updated in place (the recurrent
    states, SSM and xLSTM, copied into their layer's slot)."""
    pos = int(pos)
    layout = L.batch_layout(token)
    x = L.to_layout(L.embed_apply(params["embed"], token, cfg.activation_dtype),
                    layout)
    for i, (p, flag) in enumerate(zip(_layers(params["blocks"]),
                                      _layer_flags(cfg))):
        layer_cache = pt.tree_map(lambda a: a[i], cache)
        x, new = _block_decode(cfg, p, x, layer_cache, pos, flag)
        x = L.to_layout(x, layout)
        for name in ("ssm", "mlstm", "slstm"):
            for key, value in new.get(name, {}).items():
                cache[name][key][i].copy_(value)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.head_apply(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache


def _to_cache_layout(seq_arrays, slot_pos, phys_target: int, Stot: int):
    """Lay out prefill K/V so that position p sits in slot ``p % phys_target``
    (the ring-buffer invariant decode_attention relies on). seq_arrays:
    tensors with the sequence on dim 1; slot_pos: (Stot,) absolute positions.

    If phys_target >= Stot: identity layout + right-padding (slot_pos=-1;
    none, and no copy, when they are equal). Else: keep the last
    phys_target positions, rolled by Stot % phys_target.
    """
    if phys_target == Stot:
        return list(seq_arrays), slot_pos
    if phys_target > Stot:
        pad = phys_target - Stot
        out = [_along_seq(lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)), a)
               for a in seq_arrays]
        sp = F.pad(slot_pos, (0, pad), value=-1)
        return out, sp
    shift = Stot % phys_target
    out = [_along_seq(lambda t: torch.roll(t[:, -phys_target:], shift, dims=1), a)
           for a in seq_arrays]
    sp = torch.roll(slot_pos[-phys_target:], shift)
    return out, sp


def _along_seq(fn, a):
    """``fn(a)``, an op along the sequence (dim 1) alone; over a DTensor on
    each rank's shard, that dimension whole (torch 2.11's DTensor lays
    ``F.pad``'s output out over one mesh dimension of several and has no
    rule for ``torch.roll``)."""
    if not L.is_dtensor(a):
        return fn(a)
    from repro_torch.kernels import _sharded

    a = L.whole_dims(a, (1,))
    return _sharded.run_local(fn, a.device_mesh, (a,), (a.placements,),
                              a.placements)


_CACHE_KEYS = {"kv": ("k", "v"), "mla": ("c_kv", "k_rope")}


def prefill(cfg: ModelConfig, params, tokens, img_embeds=None, attn_impl="auto",
            cache_len: Optional[int] = None):
    """Process a prompt, returning (last_logits (B,1,V), cache).

    ``cache_len`` is the logical cache capacity the following decode will
    use (>= prompt length); the physical cache is min(window, cache_len).
    Each layer's K/V (MLA: ``c_kv`` and the roped ``k_rope``) come from its
    attention, its SSM state from the scan kernel's final state and its
    conv state from the last K-1 inputs, its mLSTM / sLSTM states from the
    cells' last carry."""
    layout = L.batch_layout(tokens)
    x = L.to_layout(embed_inputs(cfg, params, tokens, img_embeds), layout)
    Stot = x.shape[1]
    cache_len = cache_len or Stot
    if cache_len < Stot:
        raise ValueError(f"cache_len {cache_len} < prompt length {Stot}")
    positions = torch.arange(Stot, dtype=torch.int32, device=x.device)
    window = cfg.attention_window
    phys = cache_len if window is None else min(window, cache_len)
    entries = []
    for p, flag in zip(_layers(params["blocks"]), _layer_flags(cfg)):
        x, _, e = _block_apply(cfg, p, x, positions, flag, attn_impl,
                               with_cache=True)
        x = L.to_layout(x, layout)
        for name, keys in _CACHE_KEYS.items():
            if name in e:
                arrays, sp = _to_cache_layout(list(e[name]), positions, phys, Stot)
                e[name] = {**dict(zip(keys, arrays)), "slot_pos": sp}
        entries.append(e)
    cache = pt.tree_map(lambda *cs: torch.stack(cs), *entries)
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.head_apply(params.get("head", {}), params["embed"], x[:, -1:, :], cfg)
    return logits, cache
