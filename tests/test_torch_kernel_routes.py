"""Which flash-attention kernel a CUDA call takes, and why the tensor-core
route's tolerance is what it is. CPU only: the routing is a pure function,
and the tensor-core numerics are emulated in torch."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_ref)

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_route(dtype, hd):
    if dtype not in (torch.float32, torch.bfloat16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.kernel_route(dtype, hd)
    elif hd not in ops.HEAD_DIMS:
        with pytest.raises(ValueError, match=f"head dim {hd}"):
            ops.kernel_route(dtype, hd)
    elif dtype == torch.bfloat16 and hd in (64, 128):
        assert ops.kernel_route(dtype, hd) == "tensor_core"
    else:
        assert ops.kernel_route(dtype, hd) == "scalar"


def test_route_counts_reset_and_cpu_calls_launch_nothing():
    ops.reset_launch_counts()
    assert ops.LAUNCHES == 0 and set(ops.ROUTE_LAUNCHES) == set(ops.ROUTES)
    assert all(n == 0 for n in ops.ROUTE_LAUNCHES.values())
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert ops.LAUNCHES == 0 and sum(ops.ROUTE_LAUNCHES.values()) == 0


def tensor_core_emulation(q, k, v, *, causal, window, kv_len, tile=64):
    """The tensor-core kernel's numerics in torch: fp32 scores of the bf16
    inputs, an online softmax over key tiles with a fp32 running max, row
    sum and accumulator, P rounded to bf16 before P.V, the output rounded
    to bf16 once."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Skv, causal=causal, window=window, kv_len=kv_len)
    m = torch.full((B, KV, G, Sq, 1), -math.inf)
    l = torch.zeros(B, KV, G, Sq, 1)
    acc = torch.zeros(B, KV, G, Sq, hd)
    for t0 in range(0, Skv, tile):
        s = torch.einsum("bskgd,btkd->bkgst", qf, kf[:, t0:t0 + tile])
        s = torch.where(mask[:, t0:t0 + tile], s / math.sqrt(hd), -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.where(m_new == -math.inf, 1.0, torch.exp(m - base))
        p = torch.exp(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(torch.bfloat16).float(),
                          vf[:, t0:t0 + tile])
        acc = acc * corr + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("case", [
    # B, S, H, KV, causal, window, kv_len
    (1, 256, 5, 1, True, 64, None),        # hymba's mask at a small size
    (1, 256, 5, 1, False, None, 200),      # bidirectional, padded keys
])
def test_tensor_core_numerics_within_bf16_tolerance(case):
    """The reason for FLASH_BF16_RTOL / FLASH_BF16_ATOL: rounding P to bf16
    before P.V and the output once stays inside 2^-7 |want| + 2^-8 of the
    float32 plain version, and inside the absolute bf16 bound 2e-2."""
    B, S, H, KV, causal, window, kv_len = case
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, S, H, 64), (B, S, KV, 64), (B, S, KV, 64)))
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    got = tensor_core_emulation(q, k, v, **mask).float()
    want = flash_attention_ref(q.float(), k.float(), v.float(), **mask)
    err = (got - want).abs()
    bound = ops.FLASH_BF16_RTOL * want.abs() + ops.FLASH_BF16_ATOL
    assert float((err / bound).max()) <= 1.0
    assert float(err.max()) <= 2e-2
    # rounding P is a real change: the emulation is not the rounded fp32 answer
    assert not torch.equal(got, want.to(torch.bfloat16).float())
