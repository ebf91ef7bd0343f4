"""Which flash-attention kernel a CUDA call takes, why the tensor-core,
short and general routes' tolerances are what they are, and each call's
bound. CPU only: the routing and the bound are pure functions, and the
kernels' numerics are emulated in torch (the short and general ones also
held against the JAX kernel in interpret mode)."""
import math
import threading

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


def test_cpu_calls_are_not_counted_as_captured():
    """Calls of either wrapper on CPU tensors are no kernel launch, and so
    never a call recorded into a CUDA graph, on any thread."""
    from repro_torch.kernels.psgf_mix import ops as mix_ops

    seen = []

    def calls():
        q = torch.zeros(2, 15, 4, 8)
        ops.flash_attention(q, q, q)
        mix_ops.psgf_mix_batch(torch.zeros(6), torch.zeros(3, 6),
                               torch.ones(3, 6))
        seen.append((ops.captured_calls(), mix_ops.captured_calls()))

    calls()
    worker = threading.Thread(target=calls)
    worker.start()
    worker.join()
    assert seen == [(0, 0), (0, 0)]


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


# the forecaster's shapes: 15 tokens x 16 heads of 8 at look_back 128 (63
# tokens at look_back 512); serving buckets of 1..32 requests x 1 or 3
# channels, training's K x 32 rows and evaluation's K x n_test rows of the
# clusters K = 21 / 27 / 10
FORECAST_ROWS = sorted({b * m for b in (1, 2, 4, 8, 16, 32) for m in (1, 3)}
                       | {K * 32 for K in (21, 27, 10)}
                       | {K * 58 for K in (21, 27, 10)} | {70_000})


@pytest.mark.parametrize("rows", FORECAST_ROWS)
@pytest.mark.parametrize("tokens", [15, 63])
def test_short_route_takes_the_forecaster(rows, tokens):
    shape = (rows, tokens, 16, 8)
    assert ops.kernel_route(torch.float32, 8, shape, shape) == "short"
    assert ops.kernel_route(torch.float32, 8) == "scalar"    # no shape: as before


@pytest.mark.parametrize("case", [
    # dtype, hd, q (B, Sq, H), kv (Skv, KV), route
    (torch.bfloat16, 8, (4, 15, 16), (15, 16), "short"),
    (torch.bfloat16, 16, (4, 32, 16), (32, 8), "short"),        # 512 pairs
    (torch.bfloat16, 32, (4, 16, 16), (16, 4), "short"),        # 256 pairs
    (torch.float32, 32, (2, 15, 16), (15, 16), "short"),        # 92,160 B
    (torch.float32, 8, (1, 64, 16), (64, 16), "short"),         # 98,304 B
    (torch.float32, 8, (1, 64, 16), (100, 16), "scalar"),       # 135,168 B
    (torch.float32, 8, (1, 65, 16), (65, 16), "scalar"),        # 1,040 pairs
    (torch.bfloat16, 16, (1, 33, 16), (33, 16), "scalar"),      # 528 > 512 pairs
    (torch.bfloat16, 32, (1, 17, 16), (17, 16), "scalar"),      # 272 > 256 pairs
    (torch.float32, 32, (1, 16, 16), (20, 16), "short"),        # 114,688 B
    (torch.float32, 32, (1, 16, 16), (24, 16), "scalar"),       # 131,072 B
    (torch.float32, 8, (1, 15, 16), (2048, 16), "scalar"),      # long keys
    (torch.float32, 64, (1, 15, 16), (15, 16), "scalar"),       # fp32 at hd 64
    (torch.float32, 128, (1, 15, 4), (15, 4), "scalar"),        # fp32 at hd 128
    (torch.bfloat16, 64, (1, 15, 16), (15, 16), "tensor_core"),
    (torch.bfloat16, 128, (4, 2048, 25), (2048, 5), "tensor_core"),
])
def test_kernel_route_by_shape(case):
    dtype, hd, (B, Sq, H), (Skv, KV), route = case
    assert ops.kernel_route(dtype, hd, (B, Sq, H, hd), (B, Skv, KV, hd)) == route


def test_short_envelope_edges():
    """Just inside and just past each bound of the short envelope."""
    f32 = torch.float32
    r = lambda Sq, H, Skv, KV, hd=8, dt=f32: ops.kernel_route(   # noqa: E731
        dt, hd, (1, Sq, H, hd), (1, Skv, KV, hd))
    assert r(64, 16, 1, 1) == "short" and r(64, 16, 64, 1) == "short"
    assert r(1025, 1, 1, 1) == "scalar"                       # threads
    # staged bytes: (Sq*H + 2*Skv*KV) * hd * 4 against 112 KiB
    budget_rows = ops.SHORT_SMEM_BUDGET // (8 * 4)           # 3,584 rows of hd 8
    assert r(64, 16, (budget_rows - 1024) // 2, 1) == "short"
    assert r(64, 16, (budget_rows - 1024) // 2 + 1, 1) == "scalar"
    assert ops.SHORT_MAX_THREADS == {8: 1024, 16: 512, 32: 256}
    with pytest.raises(ValueError, match="both q_shape and kv_shape"):
        ops.kernel_route(f32, 8, (1, 15, 16, 8))


def short_kernel_emulation(q, k, v, *, causal, window, kv_len):
    """The short kernel's numerics in torch: per (query, head), fp32 scores
    of each kept key (one contiguous range [lo, hi)), their max, then
    ``exp(s - m)`` summed key by key into l and P.V in key order, the output
    ``acc / max(l, 1e-30)`` rounded to the input dtype once."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    kh = torch.arange(H) // (H // KV)
    qf = q.float()
    kf, vf = k.float()[:, :, kh], v.float()[:, :, kh]          # (B, Skv, H, hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(B, Sq, H, hd)
    for i in range(Sq):
        hi = min(kv_len, i + 1) if causal else kv_len
        lo = 0 if window is None else min(max(0, i - window + 1), Skv)
        if lo >= hi:
            continue                                          # 0 / 1e-30 = 0
        s = torch.stack([(qf[:, i] * kf[:, j]).sum(-1) * scale
                         for j in range(lo, hi)])            # (keys, B, H)
        m = s.amax(0)
        l = torch.zeros(B, H)
        acc = torch.zeros(B, H, hd)
        for n, j in enumerate(range(lo, hi)):
            p = torch.exp(s[n] - m)
            l = l + p
            acc = acc + p[..., None] * vf[:, j]
        out[:, i] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, KV, hd, causal, window, kv_len
    (2, 15, 15, 4, 4, 8, False, None, None),      # the forecaster's shape, cut
    (2, 15, 20, 4, 2, 16, True, 6, 17),           # GQA, causal, window, kv_len
    (1, 12, 12, 4, 1, 8, False, 4, 0),            # kv_len 0: every row zero
])
def test_short_kernel_numerics_within_flash_tolerance(case):
    """The reason the short route is held to FLASH_ATTN_TOL: its two-pass
    fp32 softmax stays within it of the JAX kernel (interpret mode) and of
    the plain version, at shapes the route takes."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.core.forecast import FLASH_ATTN_TOL

    B, Sq, Skv, H, KV, hd, causal, window, kv_len = case
    assert ops.kernel_route(torch.float32, hd, (B, Sq, H, hd),
                            (B, Skv, KV, hd)) == "short"
    rng = np.random.default_rng(15)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    got = short_kernel_emulation(q, k, v, **mask)
    plain = flash_attention_ref(q, k, v, **mask)
    jax_kern = np.asarray(flash_attention_kernel(
        *(jnp.asarray(a) for a in arrs), causal=causal, window=window,
        block_q=Sq, block_k=Skv, kv_len=kv_len, interpret=True))
    for want in (plain.numpy(), jax_kern):
        np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATTN_TOL,
                                   rtol=FLASH_ATTN_TOL)
    if kv_len == 0:
        assert torch.equal(got, torch.zeros_like(got))


def tf32_split(x):
    """An fp32 operand as the general kernel splits it: ``hi`` rounded to
    TF32 (10 mantissa bits, ties away from zero), ``lo = x - hi`` (exact)
    as the tensor cores read it, its low 13 bits dropped."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def tf32_product(eq, a, b, terms=3):
    """``einsum(eq, a, b)`` as 3xTF32 (hi.hi + hi.lo + lo.hi, fp32 out) or,
    with ``terms=1``, as one TF32 product (hi.hi)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    prod = lambda x, y: torch.einsum(eq, x.double(), y.double())  # noqa: E731
    out = prod(ah, bh)
    if terms == 3:
        out = out + prod(ah, bl) + prod(al, bh)
    return out.float()


def general_kernel_emulation(q, k, v, *, causal, window, kv_len, tile=16,
                             terms=3):
    """The general kernel's numerics in torch: QK^T and P.V as 3xTF32 (or
    ``terms=1``: one TF32 product each), an online softmax over key tiles
    with a fp32 running max and row sum, one rescale of the accumulator a
    tile, the output divided once."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Skv, causal=causal, window=window, kv_len=kv_len)
    m = torch.full((B, KV, H // KV, Sq, 1), -math.inf)
    l = torch.zeros(B, KV, H // KV, Sq, 1)
    acc = torch.zeros(B, KV, H // KV, Sq, hd)
    for t0 in range(0, Skv, tile):
        s = tf32_product("bskgd,btkd->bkgst", qf, kf[:, t0:t0 + tile], terms)
        s = torch.where(mask[:, t0:t0 + tile], s / math.sqrt(hd), -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + tf32_product("bkgst,btkd->bkgsd", p,
                                        vf[:, t0:t0 + tile], terms)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, KV, hd, causal, window, kv_len
    (1, 48, 48, 10, 2, 64, True, 17, None),       # GQA 5:1, causal, window
    (1, 40, 56, 12, 2, 128, False, None, 33),     # GQA 6:1, ragged, kv_len
    (1, 24, 24, 4, 1, 64, True, None, 0),         # no valid key: every row 0
])
def test_general_kernel_numerics_within_flash_tolerance(case):
    """The reason the general route's 3xTF32 products keep its float32
    contract: they stay within FLASH_ATTN_TOL of the JAX kernel (interpret
    mode) and of the plain version, where one TF32 product does not."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.core.forecast import FLASH_ATTN_TOL

    B, Sq, Skv, H, KV, hd, causal, window, kv_len = case
    assert ops.kernel_route(torch.float32, hd, (B, Sq, H, hd),
                            (B, Skv, KV, hd)) == "scalar"
    rng = np.random.default_rng(28)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    got = general_kernel_emulation(q, k, v, **mask)
    plain = flash_attention_ref(q, k, v, **mask)
    jax_kern = np.asarray(flash_attention_kernel(
        *(jnp.asarray(a) for a in arrs), causal=causal, window=window,
        block_q=Sq, block_k=Skv, kv_len=kv_len, interpret=True))
    for want in (plain.numpy(), jax_kern):
        np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATTN_TOL,
                                   rtol=FLASH_ATTN_TOL)
    if kv_len == 0:
        assert torch.equal(got, torch.zeros_like(got))
    else:
        one = general_kernel_emulation(q, k, v, **mask, terms=1)
        assert float((one - plain).abs().max()) > 10 * FLASH_ATTN_TOL


@pytest.mark.parametrize("case", [
    # q, kv shapes, dtype, causal, window: pairs a head, flops, bytes, the
    # bound's ms, what bounds it (and the operations), and each candidate
    ((4, 2048, 25, 64), (4, 2048, 5, 64), torch.float32, True, 1024,
     1_573_376, 4.03e10, 125.8e6, 0.244, "operations", "3xtf32",
     {"fp32": 0.601, "bytes": 0.0376}),
    ((4, 2048, 12, 128), (4, 2048, 2, 128), torch.float32, True, None,
     2_098_176, 5.16e10, 117.4e6, 0.313, "operations", "3xtf32",
     {"fp32": 0.770, "bytes": 0.0351}),
    ((4, 2048, 25, 64), (4, 2048, 5, 64), torch.bfloat16, True, 1024,
     1_573_376, 4.03e10, 62.9e6, 0.0407, "operations", "bf16",
     {"bytes": 0.0188}),
    ((96, 15, 16, 8), (96, 15, 16, 8), torch.float32, False, None,
     225, 1.106e7, 2.95e6, 0.000880, "bytes", "3xtf32", {}),
], ids=["hymba_fp32", "qwen2_fp32", "hymba_bf16", "serving_fp32"])
def test_attention_bound(case):
    """``bound.attention_bound`` at the general route's two float32 prefill
    calls: operations-bound at 3xTF32, the lesser of it and the fp32 CUDA
    cores' rate; and as before for bf16 (the tensor cores) and for the
    forecaster's serving bucket (bytes)."""
    from repro_torch.common import hw
    from repro_torch.kernels.flash_attention.bound import attention_bound

    (qs, kvs, dtype, causal, window, pairs, flops, nbytes, ms, by, ops_by,
     others) = case
    b = attention_bound(qs, kvs, dtype, causal=causal, window=window)
    assert b["pairs"] == pairs
    assert b["flops"] == pytest.approx(flops, rel=2e-3)
    assert b["bytes"] == pytest.approx(nbytes, rel=2e-3)
    assert b["ms"] == pytest.approx(ms, rel=3e-3)
    assert (b["bound_by"], b["operations_by"]) == (by, ops_by)
    assert b["bytes_ms"] == pytest.approx(nbytes / hw.HBM_BYTES_PER_S * 1e3,
                                          rel=2e-3)
    if "fp32" in others:
        assert b["flops"] / hw.FP32_FLOP_PER_S * 1e3 == pytest.approx(
            others["fp32"], rel=3e-3)
        assert b["ms"] == pytest.approx(
            3 * b["flops"] / hw.TF32_FLOP_PER_S * 1e3)
    if "bytes" in others:
        assert b["bytes_ms"] == pytest.approx(others["bytes"], rel=1e-2)
