"""The paper's forecasting models in PyTorch: LoGTST, PatchTST and MetaFormer
variants (counterpart of ``repro.core.forecast``).

Pipeline (Fig. 3 of the paper):
  RevIN -> Tokenization (1-D conv patch embed) -> N blocks -> DeTokenization
  (flatten + MLP) -> RevIN denorm.

Block token-mixers (Fig. 2): ``attn`` (multi-head self-attention), ``mlp``
(Time-MLP along the token axis), ``id`` (identity). LoGTST is
``("id", "id", "attn")``, PatchTST ``("attn", "attn", "attn")``. Channel
independence follows PatchTST: ``(B, M, L)`` series run as ``(B*M, L)`` with
shared weights.

The model is PLAIN FUNCTIONS over a nested params dict whose keys are the JAX
pytree's (``tokenize/w``, ``blocks/b2/attn/wq``, ...), not an ``nn.Module``.
That keeps the checkpoint keys and the FL engine's flat parameter vector
identical to the reference's, and leaves ``torch.func.vmap`` over clients
possible.

Where PyTorch's defaults differ from JAX's, the port follows JAX:
  * ``jax.nn.gelu`` is the tanh approximation -> ``approximate="tanh"``;
  * ``jnp.var`` is the population variance -> ``unbiased=False``;
  * the dense attention softmaxes in fp32, then casts back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import spec as S
from repro_torch.models.spec import ArraySpec


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    look_back: int = 128        # paper FL setting: 128 steps
    horizon: int = 2            # EV: 2; NN5: 4; Table I: 96/192/336/720
    patch_len: int = 16         # P (conv kernel == patch length)
    stride: int = 8             # S
    d_model: int = 128
    num_heads: int = 16
    d_ff: int = 256
    mixers: Tuple[str, ...] = ("id", "id", "attn")   # LoGTST
    dropout: float = 0.0        # kept for config parity; eval-mode graphs
    revin: bool = True
    # use_flash_attn: route _self_attn through the flash-attention kernel
    # (repro_torch.kernels.flash_attention: the CUDA kernel on the card, its
    # plain version on the CPU). Matches the dense path to FLASH_ATTN_TOL.
    use_flash_attn: bool = False

    @property
    def num_tokens(self) -> int:
        return (self.look_back - self.patch_len) // self.stride + 1

    @property
    def name(self) -> str:
        if all(m == "attn" for m in self.mixers):
            return f"patchtst/{self.num_tokens}"
        if all(m == "id" for m in self.mixers):
            return "idformer"
        if all(m == "mlp" for m in self.mixers):
            return "mlpformer"
        return f"logtst/{self.num_tokens}"


def logtst_config(**kw) -> ForecastConfig:
    return ForecastConfig(mixers=("id", "id", "attn"), **kw)


def patchtst_config(**kw) -> ForecastConfig:
    return ForecastConfig(mixers=("attn", "attn", "attn"), **kw)


def mlpformer_config(**kw) -> ForecastConfig:
    return ForecastConfig(mixers=("mlp", "mlp", "mlp"), **kw)


def idformer_config(**kw) -> ForecastConfig:
    return ForecastConfig(mixers=("id", "id", "id"), **kw)


# Flash vs dense attention: both softmax in fp32 over the same scores and
# differ only in accumulation order and the cast point (the reference's
# contract, repro.core.forecast.FLASH_ATTN_TOL).
FLASH_ATTN_TOL = 1e-5

# Port vs reference, absolute and relative, on the same params and inputs in
# fp32: PyTorch's and XLA's CPU matmuls sum in different orders (and the
# card's differ again), so results agree to a few ulps of the largest
# partial sums, not bitwise. On the tests' geometries the worst difference
# seen is 5.1e-6 on outputs of magnitude ~6 (full-width LoGTST), i.e. ~1e-6
# relative; 1e-5 absolute plus 1e-5 relative keeps a margin above that.
PORT_PARITY_TOL = 1e-5


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# RevIN [18]
# ---------------------------------------------------------------------------


def revin_spec():
    return {
        "affine_w": ArraySpec((1,), (None,), init="ones"),
        "affine_b": ArraySpec((1,), (None,), init="zeros"),
    }


def revin_norm(params, x, eps: float = 1e-5):
    """x: (B, L). Returns normalized x and (mean, std) for denorm."""
    mean = x.mean(dim=-1, keepdim=True)
    std = torch.sqrt(x.var(dim=-1, keepdim=True, unbiased=False) + eps)
    y = (x - mean) / std
    y = y * params["affine_w"] + params["affine_b"]
    return y, (mean, std)


def revin_denorm(params, y, stats, eps: float = 1e-5):
    """Exact inverse of the affine step of :func:`revin_norm`: divides by
    ``affine_w`` itself, falling back to ``eps`` only where ``w == 0``."""
    mean, std = stats
    w = params["affine_w"]
    safe_w = torch.where(w == 0.0, torch.full_like(w, eps), w)
    x = (y - params["affine_b"]) / safe_w
    return x * std + mean


# ---------------------------------------------------------------------------
# Tokenization / DeTokenization (eq. 1)
# ---------------------------------------------------------------------------


def tokenize_spec(cfg: ForecastConfig):
    return {
        "w": ArraySpec((cfg.patch_len, cfg.d_model), (None, "embed"), init="scaled"),
        "b": ArraySpec((cfg.d_model,), ("embed",), init="zeros"),
        "pos": ArraySpec((cfg.num_tokens, cfg.d_model), (None, "embed"), init="normal"),
    }


def tokenize(params, x, cfg: ForecastConfig):
    """x: (B, L) -> tokens (B, N, D). Conv1d(P, stride=S) == patch gather +
    matmul. The patches are gathered by index (not ``Tensor.unfold``, whose
    backward has no ``torch.func.vmap`` rule and would loop over clients)."""
    idx = (torch.arange(cfg.num_tokens, device=x.device)[:, None] * cfg.stride
           + torch.arange(cfg.patch_len, device=x.device)[None, :])
    patches = x[..., idx]  # (B, N, P)
    tok = patches @ params["w"] + params["b"]
    return tok + params["pos"]  # additive learnable positional encoding


def detokenize_spec(cfg: ForecastConfig):
    flat = cfg.num_tokens * cfg.d_model
    return {
        "w": ArraySpec((flat, cfg.horizon), (None, None), init="scaled"),
        "b": ArraySpec((cfg.horizon,), (None,), init="zeros"),
    }


def detokenize(params, tok):
    """Pred = MLP{Concat[Flat(V_0), Flat(V_1), ...]} (eq. 1)."""
    return tok.reshape(tok.shape[0], -1) @ params["w"] + params["b"]


# ---------------------------------------------------------------------------
# MetaFormer blocks
# ---------------------------------------------------------------------------


def _ln_spec(d):
    return {
        "scale": ArraySpec((d,), ("act_embed",), init="ones"),
        "bias": ArraySpec((d,), ("act_embed",), init="zeros"),
    }


def _ln(params, x, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * params["scale"]
            + params["bias"]).to(x.dtype)


def block_spec(cfg: ForecastConfig, mixer: str):
    d = cfg.d_model
    spec = {"ln1": _ln_spec(d), "ln2": _ln_spec(d)}
    if mixer == "attn":
        hd = d // cfg.num_heads
        spec["attn"] = {
            "wq": ArraySpec((d, cfg.num_heads, hd), ("embed", "heads", "head_dim"), init="scaled"),
            "wk": ArraySpec((d, cfg.num_heads, hd), ("embed", "heads", "head_dim"), init="scaled"),
            "wv": ArraySpec((d, cfg.num_heads, hd), ("embed", "heads", "head_dim"), init="scaled"),
            "wo": ArraySpec((cfg.num_heads, hd, d), ("heads", "head_dim", "embed"), init="scaled"),
            "bq": ArraySpec((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros"),
            "bk": ArraySpec((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros"),
            "bv": ArraySpec((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros"),
            "bo": ArraySpec((d,), ("act_embed",), init="zeros"),
        }
    elif mixer == "mlp":
        n = cfg.num_tokens
        spec["time_mlp"] = {
            "w1": ArraySpec((n, n), (None, None), init="scaled"),
            "b1": ArraySpec((n,), (None,), init="zeros"),
        }
    elif mixer != "id":
        raise ValueError(mixer)
    spec["mlp"] = {
        "w1": ArraySpec((d, cfg.d_ff), ("embed", "mlp"), init="scaled"),
        "b1": ArraySpec((cfg.d_ff,), ("mlp",), init="zeros"),
        "w2": ArraySpec((cfg.d_ff, d), ("mlp", "embed"), init="scaled"),
        "b2": ArraySpec((d,), ("act_embed",), init="zeros"),
    }
    return spec


def _self_attn(p, x, cfg: ForecastConfig):
    """Bidirectional MHSA over tokens (eq. 2). x: (B, N, D).

    ``cfg.use_flash_attn`` routes softmax(QK^T)V through the flash-attention
    wrapper (the CUDA kernel for CUDA tensors); otherwise the dense einsum
    path. Both share the projections and the output mix."""
    hd = cfg.d_model // cfg.num_heads
    q = torch.einsum("bnd,dhk->bnhk", x, p["wq"]) + p["bq"]
    k = torch.einsum("bnd,dhk->bnhk", x, p["wk"]) + p["bk"]
    v = torch.einsum("bnd,dhk->bnhk", x, p["wv"]) + p["bv"]
    if cfg.use_flash_attn:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        # (B, N, H, hd) is already the kernel layout; tokens attend
        # bidirectionally (eq. 2)
        o = flash_attention(q, k, v, causal=False)
    else:
        s = torch.einsum("bnhk,bmhk->bhnm", q, k) / math.sqrt(hd)
        a = torch.softmax(s.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.einsum("bhnm,bmhk->bnhk", a, v)
    return torch.einsum("bnhk,hkd->bnd", o, p["wo"]) + p["bo"]


def block_apply(params, x, cfg: ForecastConfig, mixer: str):
    h = _ln(params["ln1"], x)
    if mixer == "attn":
        x = x + _self_attn(params["attn"], h, cfg)
    elif mixer == "mlp":
        # Time-MLP: MLP along the token axis
        tm = params["time_mlp"]
        t = torch.einsum("bnd,nm->bmd", h, tm["w1"]) + tm["b1"][None, :, None]
        x = x + gelu(t)
    elif mixer == "id":
        x = x + h  # identity mixer: the sublayer reduces to the norm residual
    h = _ln(params["ln2"], x)
    m = params["mlp"]
    return x + (gelu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"])


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def model_spec(cfg: ForecastConfig):
    spec = {
        "tokenize": tokenize_spec(cfg),
        "blocks": {f"b{i}": block_spec(cfg, m) for i, m in enumerate(cfg.mixers)},
        "detokenize": detokenize_spec(cfg),
    }
    if cfg.revin:
        spec["revin"] = revin_spec()
    return spec


def init_params(cfg: ForecastConfig, generator: torch.Generator,
                device=DEFAULT_DEVICE):
    """Random params from ``generator`` on ``device`` (the card by default;
    raises without one unless ``device="cpu"``)."""
    return S.init_params(model_spec(cfg), generator, resolve_device(device))


def num_params(cfg: ForecastConfig) -> int:
    return S.spec_num_params(model_spec(cfg))


def forward(cfg: ForecastConfig, params, x):
    """x: (B, L) univariate look-back -> (B, T) prediction."""
    stats = None
    if cfg.revin:
        x, stats = revin_norm(params["revin"], x)
    tok = tokenize(params["tokenize"], x, cfg)
    for i, m in enumerate(cfg.mixers):
        tok = block_apply(params["blocks"][f"b{i}"], tok, cfg, m)
    pred = detokenize(params["detokenize"], tok)
    if cfg.revin:
        pred = revin_denorm(params["revin"], pred, stats)
    return pred


def forward_multivariate(cfg: ForecastConfig, params, x):
    """x: (B, M, L) -> (B, M, T); channel-independent shared weights."""
    B, M, Lw = x.shape
    return forward(cfg, params, x.reshape(B * M, Lw)).reshape(B, M, cfg.horizon)


def mse_loss(cfg: ForecastConfig, params, x, y):
    """Paper loss: L = 1/M sum ||x_hat - x||^2 (MSE over horizon)."""
    pred = forward(cfg, params, x) if x.dim() == 2 else forward_multivariate(cfg, params, x)
    return torch.mean(torch.square(pred - y))
