"""The hand-written kernels' forwards on ``meta`` tensors (the dry run's,
``launch.dryrun``): one custom op per kernel, ``torch.ops.repro_torch.*``,
that allocates what the kernel allocates (its outputs, and a returned
state) and nothing else, and beside each op its cost formula, which
``launch.cost``'s counter reads (:data:`COSTS`).

On the card the kernels keep no intermediate: flash attention holds no
``(B, H, Sq, Skv)`` score tensor, ssm_scan no ``(B, S, D, N)`` state, and
psgf_mix no mask temporaries. Their plain versions make all of those, so a
wrapper that ran its plain version on ``meta`` tensors would put them into
the dry run's peak. A formula returns ``(flops, transcendentals)`` of one
call: the FLOPs are the plain version's matmul FLOPs (flash attention's
full ``S x S`` products, two a multiply-add, where the kernel skips the
blocks its mask drops; none for the elementwise kernels), the
transcendentals the exponentials the kernel evaluates (one per score, one
per ``(b, s, d, n)`` decay). Bytes accessed need no formula: the counter
takes each op's operands and results, which for these ops is what the
kernel reads and writes.

The ops have no autograd: a wrapper calls its op inside its
``torch.autograd.Function``'s forward, whose backward stays the plain
version's (which on ``meta`` allocates what the card's backward, torch ops
too, allocates).
"""
from __future__ import annotations

from typing import Optional

import torch

# custom op -> formula(*op args) -> (flops, transcendentals)
COSTS = {}


@torch.library.custom_op("repro_torch::flash_attention_meta", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: Optional[int], kv_len: Optional[int]) -> torch.Tensor:
    raise RuntimeError("flash_attention_meta runs on meta tensors only")


@flash_attention.register_fake
def _(q, k, v, causal, window, kv_len):
    return torch.empty_like(q)


def _flash_cost(q, k, v, causal, window, kv_len):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    # QK^T and PV over every (query, key) pair; an exponential per score
    return 4 * B * H * Sq * Skv * hd, B * H * Sq * Skv


@torch.library.custom_op("repro_torch::ssm_scan_meta", mutates_args=())
def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             A: torch.Tensor, return_state: bool) -> list[torch.Tensor]:
    raise RuntimeError("ssm_scan_meta runs on meta tensors only")


@ssm_scan.register_fake
def _(x, dt, Bm, Cm, A, return_state):
    y = torch.empty_like(x)
    if not return_state:
        return [y]
    return [y, x.new_empty((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32)]


def _ssm_cost(x, dt, Bm, Cm, A, return_state):
    batch, S, D = x.shape
    # exp(dt * A) per (b, s, d, n); no matmul
    return 0, batch * S * D * A.shape[1]


@torch.library.custom_op("repro_torch::psgf_mix_meta", mutates_args=())
def psgf_mix(w_global: torch.Tensor, w_rows: torch.Tensor,
             mask: torch.Tensor) -> list[torch.Tensor]:
    raise RuntimeError("psgf_mix_meta runs on meta tensors only")


@psgf_mix.register_fake
def _(w_global, w_rows, mask):
    return [torch.empty_like(w_rows), w_rows.new_empty((), dtype=torch.float32)]


COSTS[torch.ops.repro_torch.flash_attention_meta.default] = _flash_cost
COSTS[torch.ops.repro_torch.ssm_scan_meta.default] = _ssm_cost
COSTS[torch.ops.repro_torch.psgf_mix_meta.default] = lambda *args: (0, 0)
