"""Plain PyTorch forecaster of the paper (LoGTST, PatchTST): the yardstick
the benchmark holds the program's training against.

Written from the paper's equations (RevIN -> patch tokens + learnable
positions -> MetaFormer blocks with an ``attn`` / ``mlp`` / ``id`` token
mixer and a GELU MLP -> flatten + linear head -> RevIN denorm), with
nothing of the program: dense softmax attention, no kernels, no ``vmap``.
Every parameter leaf carries a leading client axis ``K`` (``K = 1`` for one
model), so one autograd pass over the sum of the clients' losses gives each
client's own gradient.

Conventions the configuration fixes, as the program runs them: GELU is the
tanh approximation, variances are population variances, LayerNorm and RevIN
take eps 1e-5, and the flat parameter vector lays the leaves out in sorted
key order (JAX's pytree order), so ``blocks/b0/attn/bk`` comes before
``tokenize/w``.

``precision="tf32"`` rounds both operands of every matrix product to TF32
(10 mantissa bits) and accumulates in float32, as the tensor cores' TF32
mode does: the control that the comparison has to reject.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
REVIN_EPS = 1e-5


def num_tokens(model: dict) -> int:
    return (model["look_back"] - model["patch_len"]) // model["stride"] + 1


def _block_leaves(model: dict, mixer: str):
    d, f, h = model["d_model"], model["d_ff"], model["num_heads"]
    e = d // h
    out = {"ln1/scale": ((d,), "ones"), "ln1/bias": ((d,), "zeros"),
           "ln2/scale": ((d,), "ones"), "ln2/bias": ((d,), "zeros"),
           "mlp/w1": ((d, f), "scaled"), "mlp/b1": ((f,), "zeros"),
           "mlp/w2": ((f, d), "scaled"), "mlp/b2": ((d,), "zeros")}
    if mixer == "attn":
        for n in ("q", "k", "v"):
            out[f"attn/w{n}"] = ((d, h, e), "scaled")
            out[f"attn/b{n}"] = ((h, e), "zeros")
        out["attn/wo"] = ((h, e, d), "scaled")
        out["attn/bo"] = ((d,), "zeros")
    elif mixer == "mlp":
        n = num_tokens(model)
        out["time_mlp/w1"] = ((n, n), "scaled")
        out["time_mlp/b1"] = ((n,), "zeros")
    elif mixer != "id":
        raise ValueError(f"unknown token mixer {mixer!r}")
    return out


def leaf_specs(model: dict):
    """``[(path, shape, init)]`` in the flat vector's order. ``init`` is
    ``zeros``, ``ones``, ``normal`` (std 0.02) or ``scaled`` (std
    1/sqrt(fan-in), fan-in the product of all but the last dimension)."""
    n, d = num_tokens(model), model["d_model"]
    leaves = {"tokenize/w": ((model["patch_len"], d), "scaled"),
              "tokenize/b": ((d,), "zeros"),
              "tokenize/pos": ((n, d), "normal"),
              "detokenize/w": ((n * d, model["horizon"]), "scaled"),
              "detokenize/b": ((model["horizon"],), "zeros")}
    if model["revin"]:
        leaves["revin/affine_w"] = ((1,), "ones")
        leaves["revin/affine_b"] = ((1,), "zeros")
    for i, mixer in enumerate(model["mixers"]):
        for path, spec in _block_leaves(model, mixer).items():
            leaves[f"blocks/b{i}/{path}"] = spec
    return [(p,) + leaves[p] for p in sorted(leaves, key=lambda p: p.split("/"))]


def init_std(shape, init: str) -> float:
    if init == "normal":
        return 0.02
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else shape[0]
    return 1.0 / math.sqrt(max(fan_in, 1))


def num_params(model: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaf_specs(model))


def unflatten(flat: torch.Tensor, model: dict) -> dict:
    """``(K, D)`` -> ``{path: (K, *shape)}`` views."""
    out, off = {}, 0
    for path, shape, _ in leaf_specs(model):
        n = math.prod(shape)
        out[path] = flat[:, off:off + n].reshape((flat.shape[0],) + shape)
        off += n
    if off != flat.shape[1]:
        raise ValueError(f"vector of {flat.shape[1]} elements, the model has {off}")
    return out


def _tf32(x):
    """Round to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``einsum(eq, a, b)`` with both operands rounded to TF32, and in the
    backward the gradient and both operands rounded before its products."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, _tf32(a), _tf32(b))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            ar = _tf32(a).requires_grad_()
            br = _tf32(b).requires_grad_()
            ga, gb = torch.autograd.grad(torch.einsum(ctx.eq, ar, br), (ar, br),
                                         _tf32(grad))
        return None, ga, gb


def _mm(eq, a, b, precision):
    if precision == "tf32":
        return _TF32Product.apply(eq, a, b)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.einsum(eq, a, b)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ln(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    k = scale.shape[0]
    return ((x - mu) / torch.sqrt(var + LN_EPS) * scale.reshape(k, 1, 1, -1)
            + bias.reshape(k, 1, 1, -1))


def _attention(p, pre, h, model, precision):
    k = h.shape[0]

    def proj(n):
        return (_mm("kbnd,kdhe->kbnhe", h, p[f"{pre}attn/w{n}"], precision)
                + p[f"{pre}attn/b{n}"][:, None, None])

    q, key, v = proj("q"), proj("k"), proj("v")
    e = q.shape[-1]
    s = _mm("kbnhe,kbmhe->kbhnm", q, key, precision) / math.sqrt(e)
    o = _mm("kbhnm,kbmhe->kbnhe", torch.softmax(s, dim=-1), v, precision)
    return (_mm("kbnhe,khed->kbnd", o, p[f"{pre}attn/wo"], precision)
            + p[f"{pre}attn/bo"].reshape(k, 1, 1, -1))


def forward(model: dict, p: dict, x: torch.Tensor, precision: str = "fp32"):
    """``x`` ``(K, B, look_back)`` with parameters ``p`` ``{path: (K,
    ...)}`` -> ``(K, B, horizon)``."""
    K, B, _ = x.shape
    if model["revin"]:
        mean = x.mean(dim=-1, keepdim=True)
        std = torch.sqrt(((x - mean) ** 2).mean(dim=-1, keepdim=True) + REVIN_EPS)
        aw = p["revin/affine_w"].reshape(K, 1, 1)
        ab = p["revin/affine_b"].reshape(K, 1, 1)
        x = (x - mean) / std * aw + ab
    n = num_tokens(model)
    idx = (torch.arange(n, device=x.device)[:, None] * model["stride"]
           + torch.arange(model["patch_len"], device=x.device)[None, :])
    tok = (_mm("kbnp,kpd->kbnd", x[..., idx], p["tokenize/w"], precision)
           + p["tokenize/b"].reshape(K, 1, 1, -1) + p["tokenize/pos"][:, None])
    for i, mixer in enumerate(model["mixers"]):
        pre = f"blocks/b{i}/"
        h = _ln(tok, p[pre + "ln1/scale"], p[pre + "ln1/bias"])
        if mixer == "attn":
            tok = tok + _attention(p, pre, h, model, precision)
        elif mixer == "mlp":
            t = (_mm("kbnd,knm->kbmd", h, p[pre + "time_mlp/w1"], precision)
                 + p[pre + "time_mlp/b1"][:, None, :, None])
            tok = tok + _gelu(t)
        else:
            tok = tok + h
        h = _ln(tok, p[pre + "ln2/scale"], p[pre + "ln2/bias"])
        u = _gelu(_mm("kbnd,kdf->kbnf", h, p[pre + "mlp/w1"], precision)
                  + p[pre + "mlp/b1"].reshape(K, 1, 1, -1))
        tok = tok + (_mm("kbnf,kfd->kbnd", u, p[pre + "mlp/w2"], precision)
                     + p[pre + "mlp/b2"].reshape(K, 1, 1, -1))
    pred = (_mm("kbf,kft->kbt", tok.reshape(K, B, -1), p["detokenize/w"], precision)
            + p["detokenize/b"].reshape(K, 1, -1))
    if model["revin"]:
        safe = torch.where(aw == 0.0, torch.full_like(aw, REVIN_EPS), aw)
        pred = (pred - ab) / safe * std + mean
    return pred


def client_losses(model, flat, x, y, precision="fp32"):
    """Per-client mean squared error ``(K,)`` of ``flat`` ``(K, D)`` on
    ``x`` ``(K, B, L)``, ``y`` ``(K, B, T)``."""
    pred = forward(model, unflatten(flat, model), x, precision)
    return ((pred - y) ** 2).mean(dim=(1, 2))


def client_grads(model, flat, x, y, precision="fp32"):
    """``(grads (K, D), losses (K,))``: one backward pass over the sum of
    the clients' losses."""
    w = flat.detach().requires_grad_()
    losses = client_losses(model, w, x, y, precision)
    (g,) = torch.autograd.grad(losses.sum(), [w])
    return g, losses.detach()
