"""Operations and bytes of the work a cell asks for, from its shapes alone,
and the card's published peaks: the yardstick of the roofline and
utilization metrics.

Peaks: one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet; dense rates without
sparsity, at the full 700 W power limit).

The flash-attention bound is ``src/repro_torch/kernels/flash_attention/
bound.py::attention_bound`` and the psgf_mix bound ``chip_smoke.py::
mix_bound_ms``, both copied at commit 2bc2c01 and frozen here, so a later
change to the program cannot move the yardstick.
"""
from __future__ import annotations

from bench.reference.model import num_tokens

FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12


def forward_flops(model: dict) -> int:
    """Matrix-product FLOPs (2 a multiply-add) of one window's forward pass:
    the patch embedding, per block the token mixer (Q, K, V and output
    projections, QK^T and P.V over every pair of tokens; or the time MLP)
    and the two-layer MLP, and the head. Norms, activations and softmax are
    not counted."""
    n, d, f = num_tokens(model), model["d_model"], model["d_ff"]
    total = 2 * n * model["patch_len"] * d
    for mixer in model["mixers"]:
        total += 2 * n * (d * f + f * d)
        if mixer == "attn":
            total += 2 * n * 4 * d * d + 2 * 2 * n * n * d
        elif mixer == "mlp":
            total += 2 * n * n * d
    return total + 2 * n * d * model["horizon"]


def train_flops(model: dict) -> int:
    """One window carried through forward and backward: three forwards'
    worth, recompute not counted."""
    return 3 * forward_flops(model)


def attention_bound_s(batch: int, seq: int, heads: int, head_dim: int,
                      itemsize: int = 4) -> float:
    """The least time one bidirectional attention forward could take: q, k,
    v read once and o written once at the HBM rate, or QK^T and P.V over
    every (query, key) pair at float32's rate (the lesser of the CUDA cores'
    fp32 and 3xTF32 on the tensor cores), whichever is longer."""
    nbytes = 4 * batch * seq * heads * head_dim * itemsize
    flops = 4 * batch * heads * head_dim * seq * seq
    ops_s = min(flops / FP32_FLOP_PER_S, 3 * flops / TF32_FLOP_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, ops_s)


def mix_bound_s(clients: int, dim: int) -> float:
    """The least time of one downlink mix of ``clients`` rows of ``dim``
    float32 parameters: client rows and gates read and the mix written
    (3 K D floats) and the global vector read once, at the HBM rate; or 3
    FLOPs an element at the fp32 rate."""
    nbytes = (3 * clients * dim + dim) * 4
    return max(nbytes / HBM_BYTES_PER_S, 3 * clients * dim / FP32_FLOP_PER_S)
