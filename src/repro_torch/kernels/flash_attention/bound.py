"""The least time one H100 could take for a flash-attention call.

``chip_smoke.py`` reports it as each flash call's ``bound_ms``: the larger
of the bytes the call must move (q, k, v read once, the output written
once) over the HBM rate, and its operations over their type's peak rate
(``common/hw.py``). The operations are QK^T and P.V over the (query, key)
pairs the mask keeps, 2 flops a multiply-add. For bf16 they run on the
tensor cores, and the pairs' exponentials on the special-function units
bound them where those take longer. For float32 the bound is the lesser
of the CUDA cores' fp32 rate and 3xTF32 on the tensor cores (three TF32
products a float32 product, as the general kernel computes them), so a
3xTF32 kernel never reads above its bound. A function of shapes alone, so
it runs without a GPU.
"""
from __future__ import annotations

import torch

from repro_torch.common import hw
from repro_torch.kernels.flash_attention.ref import attention_mask


def attention_bound(q_shape, kv_shape, dtype, *, causal=False, window=None,
                    kv_len=None) -> dict:
    """q (B, Sq, H, hd), k / v (B, Skv, KV, hd) in ``dtype`` -> ``{"ms",
    "bound_by"`` ("bytes" or "operations"), ``"operations_by"`` (the rate
    that bounds the operations: "fp32", "3xtf32", "bf16" or "sfu"),
    ``"bytes_ms"``, ``"operations_ms"``, ``"bytes"``, ``"flops"``,
    ``"pairs"}`` (pairs a head and batch row)."""
    B, Sq, H, hd = q_shape
    Skv, KV = kv_shape[1], kv_shape[2]
    size = torch.empty((), dtype=dtype).element_size()
    pairs = int(attention_mask(Sq, Skv, causal=causal, window=window,
                               kv_len=kv_len).sum())
    nbytes = (2 * B * Sq * H + 2 * B * Skv * KV) * hd * size
    flops = 4 * B * H * hd * pairs
    if dtype == torch.float32:
        rates = {"fp32": flops / hw.FP32_FLOP_PER_S,
                 "3xtf32": 3 * flops / hw.TF32_FLOP_PER_S}
        ops_by = min(rates, key=rates.get)
    else:
        rates = {"bf16": flops / hw.BF16_FLOP_PER_S,
                 "sfu": B * H * pairs / hw.SFU_OPS_PER_S}
        ops_by = max(rates, key=rates.get)
    times = {"bytes": nbytes / hw.HBM_BYTES_PER_S * 1e3,
             "operations": rates[ops_by] * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "bound_by": by, "operations_by": ops_by,
            "bytes_ms": times["bytes"], "operations_ms": times["operations"],
            "bytes": nbytes, "flops": flops, "pairs": pairs}
