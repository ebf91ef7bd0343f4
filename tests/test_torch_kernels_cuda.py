"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (the kernels have
no CPU mode). The file imports no JAX, so it runs on a GPU machine without
the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core import forecast as F  # noqa: E402
from repro_torch.core.forecaster import get_forecaster  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_BF16_ATOL, FLASH_BF16_RTOL, flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.psgf_mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.psgf_mix.ref import psgf_mix_batch_ref, psgf_mix_ref  # noqa: E402

BF16_TOL = 2e-2

CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, kv_len, dtype, tol
    (96, 15, 15, 16, 16, 8, False, None, None, torch.float32, F.FLASH_ATTN_TOL),
    (3, 15, 15, 16, 16, 8, False, None, None, torch.float32, F.FLASH_ATTN_TOL),
    (2, 256, 256, 4, 2, 64, True, None, None, torch.float32, 2e-5),
    (1, 200, 200, 4, 4, 128, True, 64, None, torch.float32, 2e-5),
    (2, 128, 384, 8, 2, 64, False, None, None, torch.float32, 2e-5),
    (1, 100, 100, 6, 3, 32, True, 17, None, torch.float32, 2e-5),
    (1, 256, 256, 2, 1, 128, True, None, None, torch.bfloat16, BF16_TOL),
    (1, 128, 256, 2, 2, 16, False, 16, 100, torch.float32, 2e-5),
    (2, 7, 40, 4, 1, 32, True, None, 0, torch.float32, 0.0),       # no valid key
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, Sq, Skv, H, KV, hd, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_plain(cuda, case):
    B, Sq, Skv, H, KV, hd, causal, window, kv_len, dtype, tol = case
    q, k, v = _inputs(0, B, Sq, Skv, H, KV, hd, cuda, dtype)
    before = ops.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


GENERAL_CASES = [
    # B, Sq, Skv, H, KV, causal, window, kv_len: float32 at hd 64 and 128,
    # the general route (kernel_route "scalar") of the zoo's float32 prefills
    (1, 300, 300, 10, 2, True, 37, None),        # GQA 5:1, causal, window
    (2, 130, 130, 12, 2, True, None, None),      # GQA 6:1, causal
    (2, 100, 300, 8, 2, True, None, None),       # causal, Sq < Skv
    (2, 300, 100, 6, 1, True, None, 77),         # causal, Sq > Skv, kv_len
    (1, 300, 400, 4, 4, False, 50, 350),         # window without causal, kv_len
    (2, 7, 40, 5, 1, True, None, 0),             # no valid key: exactly 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", GENERAL_CASES)
def test_flash_general_kernel_matches_plain(cuda, case, hd):
    """The general route in float32: one launch counted on it, within 2e-5
    of the plain version (its 3xTF32 products), rows with no valid key
    exactly zero."""
    B, Sq, Skv, H, KV, causal, window, kv_len = case
    q, k, v = _inputs(28, B, Sq, Skv, H, KV, hd, cuda)
    assert ops.kernel_route(torch.float32, hd, tuple(q.shape),
                            tuple(k.shape)) == "scalar"
    before = dict(ops.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES == {**before, "scalar": before["scalar"] + 1}
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    if kv_len == 0:
        assert torch.equal(got, torch.zeros_like(got))


TC_CASES = [
    # B, Sq, Skv, H, KV, causal, window, kv_len: bf16, at hd 64 and 128
    (1, 2048, 2048, 5, 1, True, 1024, None),     # GQA 5:1, hymba's mask
    (1, 100, 100, 6, 3, True, 17, None),         # window 17
    (2, 128, 384, 8, 2, False, None, None),      # Sq != Skv, bidirectional
    (1, 128, 256, 2, 2, False, None, 100),       # kv_len 100
    (2, 7, 40, 4, 1, True, None, 0),             # no valid key: exactly 0
    (3, 63, 63, 2, 1, False, None, None),        # Sq not a multiple of 64
    (1, 130, 130, 8, 8, True, None, None),
    (70_000, 15, 15, 2, 1, False, None, None),   # B past gridDim.z
    (1, 64, 64, 8, 8, False, None, None),        # fewer work tiles than SMs
    (2, 100, 100, 10, 2, True, None, None),      # G = 5: 12 positions a block
    (2, 70, 70, 12, 2, True, 17, None),          # G = 6 with a window
    (1, 40, 40, 130, 1, True, None, None),       # G > 64: head chunks
    (2, 100, 300, 8, 2, True, None, None),       # causal, Sq < Skv
    (2, 300, 100, 8, 2, True, None, None),       # causal, Sq > Skv
    (2, 200, 200, 6, 3, True, None, 77),         # causal, ragged kv_len
    (1, 300, 300, 4, 2, False, 50, None),        # window without causal
]


def _check_tensor_core_call(q, k, v, causal, window, kv_len):
    """One wrapper call on the tensor-core route against the float32 plain
    version: within FLASH_BF16_RTOL |want| + FLASH_BF16_ATOL and BF16_TOL."""
    assert ops.kernel_route(q.dtype, q.shape[3]) == "tensor_core"
    before = dict(ops.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES == {**before,
                                  "tensor_core": before["tensor_core"] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                               window=window, kv_len=kv_len)
    err = (got.float() - want).abs()
    assert bool((err <= FLASH_BF16_RTOL * want.abs() + FLASH_BF16_ATOL).all())
    assert float(err.max()) <= BF16_TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_tensor_core_kernel_matches_plain(cuda, case, hd):
    B, Sq, Skv, H, KV, causal, window, kv_len = case
    q, k, v = _inputs(6, B, Sq, Skv, H, KV, hd, cuda, torch.bfloat16)
    got = _check_tensor_core_call(q, k, v, causal, window, kv_len)
    if kv_len == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_flash_tensor_core_more_work_tiles_than_blocks(cuda):
    """8,192 work tiles (64 x 8 kv heads x 16 row blocks), dealt to the
    persistent grid's blocks over many rounds."""
    q, k, v = _inputs(13, 64, 512, 512, 32, 8, 128, cuda, torch.bfloat16)
    _check_tensor_core_call(q, k, v, True, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_tensor_core_repeats_and_graph_replay_are_bitwise(cuda, hd):
    """The static schedule computes each row in one order: two eager calls,
    and a call captured in a CUDA graph and replayed, are bitwise equal."""
    q, k, v = _inputs(14, 4, 512, 512, 32, 8, hd, cuda, torch.bfloat16)
    eager = flash_attention(q, k, v, causal=True)
    assert torch.equal(eager, flash_attention(q, k, v, causal=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, k, v, causal=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attention(q, k, v, causal=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, captured)


@pytest.mark.cuda
def test_flash_tensor_core_takes_unaligned_views(cuda):
    """q, k, v that start 2 bytes into their storage (not 16-byte aligned,
    as TMA needs): the wrapper copies them and the kernel is right."""
    q, k, v = _inputs(7, 2, 96, 96, 10, 2, 64, cuda, torch.bfloat16)
    q, k, v = (torch.cat([t.flatten(), t.new_zeros(1)])[1:].view(t.shape)
               for t in (q, k, v))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    _check_tensor_core_call(q, k, v, True, 33, None)


@pytest.mark.cuda
def test_flash_kernel_batch_above_grid_limit(cuda):
    """B past gridDim.z's 65535 (the engine's vmap folds K clients into B):
    the kernel strides over the batch, so every row is written and right."""
    q, k, v = _inputs(5, 70_000, 15, 15, 16, 16, 8, cuda)
    before = ops.LAUNCHES
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want, atol=F.FLASH_ATTN_TOL,
                               rtol=F.FLASH_ATTN_TOL)


@pytest.mark.cuda
def test_flash_kernel_padding_inert_and_dead_rows_zero(cuda):
    q, k, v = _inputs(1, 1, 256, 128, 2, 2, 16, cuda)
    base = flash_attention(q, k, v, causal=False, window=16, kv_len=100)
    k[:, 100:], v[:, 100:] = 50.0, -50.0
    assert torch.equal(base, flash_attention(q, k, v, causal=False, window=16,
                                             kv_len=100))
    assert torch.equal(base[0, 115:], torch.zeros_like(base[0, 115:]))


SHORT_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, kv_len, dtype: the forecaster's
    # serving buckets (3, 96), training's K x 32 rows (864) and a batch past
    # the old grid limit (70,000); no valid key; GQA with every mask; 63
    # tokens; hd 16 and 32; bf16
    (3, 15, 15, 16, 16, 8, False, None, None, torch.float32),
    (96, 15, 15, 16, 16, 8, False, None, None, torch.float32),
    (864, 15, 15, 16, 16, 8, False, None, None, torch.float32),
    (70_000, 15, 15, 16, 16, 8, False, None, None, torch.float32),
    (2, 7, 40, 4, 1, 8, True, None, 0, torch.float32),
    (3, 15, 15, 16, 4, 8, True, 5, 12, torch.float32),
    (4, 63, 63, 16, 16, 8, False, None, None, torch.float32),
    (2, 30, 20, 16, 2, 16, False, 9, 17, torch.float32),
    (2, 15, 15, 16, 16, 32, False, None, None, torch.float32),
    (96, 15, 15, 16, 16, 8, False, None, None, torch.bfloat16),
    (3, 20, 33, 8, 2, 16, True, None, 30, torch.bfloat16),
    (3, 16, 16, 16, 8, 32, False, 4, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SHORT_CASES)
def test_flash_short_kernel_matches_plain(cuda, case):
    """The short route: one launch counted on it, within FLASH_ATTN_TOL of
    the plain version in float32 (BF16_TOL in bf16), rows with no valid key
    exactly zero."""
    B, Sq, Skv, H, KV, hd, causal, window, kv_len, dtype = case
    q, k, v = _inputs(8, B, Sq, Skv, H, KV, hd, cuda, dtype)
    assert ops.kernel_route(dtype, hd, tuple(q.shape), tuple(k.shape)) == "short"
    before = dict(ops.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES == {**before, "short": before["short"] + 1}
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    tol = F.FLASH_ATTN_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if kv_len == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_flash_short_and_scalar_kernels_agree(cuda):
    """The scalar kernel, its route forced, on the short route's inputs: the
    two CUDA kernels agree within FLASH_ATTN_TOL, and each launch is counted
    on its own route."""
    q, k, v = _inputs(9, 96, 15, 15, 16, 16, 8, cuda)
    before = dict(ops.ROUTE_LAUNCHES)
    short = flash_attention(q, k, v, causal=False)
    scalar = ops._launch(q, k, v, False, None, None, route="scalar")
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES == {**before, "short": before["short"] + 1,
                                  "scalar": before["scalar"] + 1}
    torch.testing.assert_close(short, scalar, atol=F.FLASH_ATTN_TOL,
                               rtol=F.FLASH_ATTN_TOL)
    with pytest.raises(ValueError, match="short flash-attention kernel does not"):
        ops._launch(*_inputs(9, 1, 100, 100, 16, 16, 8, cuda), False, None,
                    None, route="short")


@pytest.mark.cuda
def test_flash_kernel_grads_match_plain(cuda):
    a = [t.requires_grad_() for t in _inputs(2, 1, 60, 60, 4, 2, 16, cuda)]
    b = [t.detach().clone().requires_grad_() for t in a]
    torch.sin(flash_attention(*a, causal=False)).sum().backward()
    torch.sin(flash_attention_ref(*b, causal=False)).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_tensor_core_training_step_at_hd128_gqa6(cuda):
    """One train step of a one-layer qwen2-shaped model (d_model 1536, 12
    query heads over 2 kv heads of 128, bf16 activations) on the card: its
    attention forward on the tensor-core route (twice, the forward and its
    recompute under remat), and the loss and updated params against the
    same step on the CPU within bf16's rounding."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as train_steps

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=1, d_ff=512,
                              vocab_size=512)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    out = {}
    for dev in ("cpu", cuda):
        fn, api, opt = train_steps.build_train_step(cfg, device=dev)
        params = api.init_params(R.PRNGKey(0))
        state = opt.init(params)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        ops.reset_launch_counts()
        params, state, metrics = fn(params, state, batch)
        out[str(dev)] = (float(metrics["loss"]), params, dict(ops.ROUTE_LAUNCHES))
    loss_cpu, p_cpu, _ = out["cpu"]
    loss_gpu, p_gpu, routes = out["cuda"]
    assert routes == {"scalar": 0, "short": 0, "tensor_core": 2}
    assert abs(loss_gpu - loss_cpu) <= BF16_TOL * abs(loss_cpu)
    for (path, a), b in zip(pt.flatten_with_paths(p_gpu), pt.leaves(p_cpu)):
        # the first Adam step moves each element by ~lr (1.5e-6 at step 1 of
        # make_optimizer's warm-up) whatever its gradient, so a gradient sign
        # flipped by bf16 rounding is a 3e-6 difference; init draws agree to
        # erfinv's ulps
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5, msg=path)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(3, 1, 8, 8, 2, 2, 24, cuda)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention(q, k, v)
    q, k, v = _inputs(3, 1, 8, 8, 2, 2, 16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, k.cpu(), v)


@pytest.mark.cuda
def test_forecaster_on_the_card_matches_cpu(cuda):
    """Full-width LoGTST with flash attention: one kernel launch per forward,
    and the CPU forward's outputs within 1e-4 (fp32 without TF32 on both
    sides, but cuBLAS and the CPU sum the matmuls in other orders)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fc = get_forecaster("logtst", use_flash_attn=True)
    params = fc.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 3, 128)).astype(np.float32))
    want = fc.forward_multivariate(params, x)
    p_gpu = pt.tree_map(lambda t: t.to(cuda), params)
    before = ops.LAUNCHES
    got = fc.forward_multivariate(p_gpu, x.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


MIX_CASES = [
    # K, D, mask kind: the main path's three clusters at full width, a
    # ragged D (scalar path), one client, a non-binary float mask
    (21, 273_284, "binary"), (27, 273_284, "binary"), (10, 273_284, "binary"),
    (3, 1_001, "binary"), (1, 4_097, "binary"), (5, 8_192, "uniform"),
    (4, 10_000, "quarters"),
]


def _mix_inputs(seed, K, D, kind, device):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(D).astype(np.float32)
    w = rng.standard_normal((K, D)).astype(np.float32)
    if kind == "binary":
        m = (rng.random((K, D)) < 0.3).astype(np.float32)
    elif kind == "quarters":
        m = rng.integers(0, 5, (K, D)).astype(np.float32) / np.float32(4)
    else:
        m = rng.random((K, D)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (g, w, m)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MIX_CASES)
def test_psgf_mix_kernel_bitwise_plain(cuda, case):
    K, D, kind = case
    g, w, m = _mix_inputs(K + D, K, D, kind, cuda)
    before = mix_ops.LAUNCHES
    mixed, count = mix_ops.psgf_mix_batch(g, w, m)
    torch.cuda.synchronize()
    assert mix_ops.LAUNCHES == before + 1
    want, want_count = psgf_mix_batch_ref(g, w, m)
    assert torch.equal(mixed, want)                 # bitwise, any float mask
    if kind == "uniform":                           # sums in another order
        torch.testing.assert_close(count, want_count, rtol=1e-6, atol=0)
    else:
        assert torch.equal(count, want_count)


@pytest.mark.cuda
def test_psgf_mix_single_vector_and_unaligned_rows(cuda):
    g, w, m = _mix_inputs(1, 1, 4_099, "uniform", cuda)
    before = (mix_ops.LAUNCHES, mix_ops.LAUNCHES_SINGLE)
    got = mix_ops.psgf_mix(g, w[0], m[0])
    torch.cuda.synchronize()
    assert (mix_ops.LAUNCHES, mix_ops.LAUNCHES_SINGLE) == (before[0],
                                                           before[1] + 1)
    want = psgf_mix_ref(g, w[0], m[0])
    assert torch.equal(got[0], want[0])
    # a view starting 4 bytes in: not 16-byte aligned -> the scalar path
    g, w, m = _mix_inputs(2, 2, 4_097, "binary", cuda)
    got = mix_ops.psgf_mix_batch(g[1:], w[:, 1:].contiguous(), m[:, 1:].contiguous())
    want = psgf_mix_batch_ref(g[1:], w[:, 1:], m[:, 1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_psgf_mix_rejects_what_it_does_not_take(cuda):
    g, w, m = _mix_inputs(3, 2, 64, "binary", cuda)
    with pytest.raises(TypeError, match="float32"):
        mix_ops.psgf_mix_batch(g, w, m > 0)
    with pytest.raises(TypeError, match="float32"):
        mix_ops.psgf_mix_batch(g.double(), w.double(), m.double())
    with pytest.raises(ValueError, match="different devices"):
        mix_ops.psgf_mix_batch(g.cpu(), w, m)
    with pytest.raises(ValueError, match="contiguous"):
        mix_ops.psgf_mix_batch(g, w.t().contiguous().t(), m)


@pytest.mark.cuda
def test_fl_round_on_the_card_matches_cpu(cuda):
    """One psgf round with the fused downlink and flash attention on the
    card: selection, gates and comm counters bitwise those of the CPU round
    (integer RNG), states within FL_PARITY_TOL-sized float noise."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.data.synthetic import ev_synthetic
    from repro_torch.data.windowing import client_datasets

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = F.logtst_config(look_back=32, horizon=2, d_model=16, num_heads=2,
                          d_ff=32, use_flash_attn=True)
    tr, _, _, _ = client_datasets(ev_synthetic(seed=0, num_clients=5,
                                               num_days=150), 32, 2)
    fl = E.FLConfig(num_clients=tr.shape[0], batch_size=8, local_steps=2,
                    use_pallas_mix=True)
    out = {}
    for dev in ("cpu", "cuda"):
        state, meta = E.init_fl_state(cfg, fl, R.PRNGKey(0), device=dev)
        before = (mix_ops.LAUNCHES, ops.LAUNCHES)
        out[dev] = E.fl_round(state, tr, R.PRNGKey(1), cfg, fl, meta, device=dev)
        launched = (mix_ops.LAUNCHES - before[0], ops.LAUNCHES - before[1])
        # one mix per round, one attention forward per local step
        assert launched == ((1, fl.local_steps) if dev == "cuda" else (0, 0))
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k in ("comm_down", "comm_up", "round", "adam_t"):
        assert torch.equal(cs[k], gs[k].cpu()), k
    assert float(cm["num_selected"]) == float(gm["num_selected"])
    keep = E.bk_free(meta)                # attn/bk: see FL_PARITY_TOL
    torch.testing.assert_close(gs["w_global"].cpu()[keep], cs["w_global"][keep],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_vmap_grad_through_flash_kernel_matches_dense_on_the_card(cuda):
    """LocalUpdate's ``vmap(grad_and_value)`` over clients through the
    flash kernel (full-width LoGTST) against the dense attention path on
    the card: one kernel launch for all clients (the vmap rule folds them
    into the batch), gradients within 1e-4 (flash and dense differ in
    accumulation order, ~1e-6 relative per attention output, and the
    backward sums those over 15 tokens x 32 series per client)."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = F.logtst_config()
    params = F.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    vec, meta = pt.tree_flatten_to_vector(params)
    rng = np.random.default_rng(5)
    K = 4
    w = (vec[None].repeat(K, 1) + 0.01 * torch.from_numpy(
        rng.standard_normal((K, meta.total)).astype(np.float32))).to(cuda)
    x = torch.from_numpy(rng.standard_normal((K, 32, 128)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((K, 32, 2)).astype(np.float32)).to(cuda)

    def grads(c):
        def loss(wv, xb, yb):
            return F.mse_loss(c, pt.tree_unflatten_from_vector(wv, meta), xb, yb)
        return torch.func.vmap(torch.func.grad_and_value(loss))(w, x, y)

    before = ops.LAUNCHES
    g_flash, l_flash = grads(dataclasses.replace(cfg, use_flash_attn=True))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    g_dense, l_dense = grads(cfg)
    torch.testing.assert_close(l_flash, l_dense, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(g_flash, g_dense, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_vmap_grad_over_27_clients_is_one_short_launch(cuda):
    """LocalUpdate's ``vmap(grad_and_value)`` at the largest cluster (27
    clients x 32 series of full-width LoGTST): the vmap rule folds every
    client into one (864, 15, 16, 8) call, launched once on the short
    route; the gradients match the dense attention path as above."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = F.logtst_config()
    params = F.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    vec, meta = pt.tree_flatten_to_vector(params)
    rng = np.random.default_rng(6)
    K = 27
    w = (vec[None].repeat(K, 1) + 0.01 * torch.from_numpy(
        rng.standard_normal((K, meta.total)).astype(np.float32))).to(cuda)
    x = torch.from_numpy(rng.standard_normal((K, 32, 128)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((K, 32, 2)).astype(np.float32)).to(cuda)

    def grads(c):
        def loss(wv, xb, yb):
            return F.mse_loss(c, pt.tree_unflatten_from_vector(wv, meta), xb, yb)
        return torch.func.vmap(torch.func.grad_and_value(loss))(w, x, y)

    before = dict(ops.ROUTE_LAUNCHES)
    g_flash, l_flash = grads(dataclasses.replace(cfg, use_flash_attn=True))
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES == {**before, "short": before["short"] + 1}
    g_dense, l_dense = grads(cfg)
    torch.testing.assert_close(l_flash, l_dense, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(g_flash, g_dense, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 27])
def test_psgf_mix_count_across_graph_replays(cuda, K):
    """One call captured in a CUDA graph and replayed three times: the same
    bitwise mix and the exact count every time (the last block resets the
    ticket counter, so each replay starts clean); two calls back to back
    give identical counts."""
    g, w, m = _mix_inputs(20 + K, K, 273_284, "binary", cuda)
    want, want_count = psgf_mix_batch_ref(g, w, m)
    first = mix_ops.psgf_mix_batch(g, w, m)[1]
    second = mix_ops.psgf_mix_batch(g, w, m)[1]
    assert torch.equal(first, want_count) and torch.equal(second, first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mixed, count = mix_ops.psgf_mix_batch(g, w, m)
    for _ in range(3):
        mixed.zero_()
        count.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(mixed, want)
        assert torch.equal(count, want_count)


@pytest.mark.cuda
def test_psgf_mix_many_clients_one_launch(cuda):
    """70,000 short client rows: more slices than the grid holds, so every
    block walks several; the mix bitwise, the count exact."""
    g, w, m = _mix_inputs(30, 70_000, 8, "binary", cuda)
    before = mix_ops.LAUNCHES
    mixed, count = mix_ops.psgf_mix_batch(g, w, m)
    torch.cuda.synchronize()
    assert mix_ops.LAUNCHES == before + 1
    want, want_count = psgf_mix_batch_ref(g, w, m)
    assert torch.equal(mixed, want) and torch.equal(count, want_count)


# ---------------- ssm_scan ----------------

from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402

# float32: the kernel rounds the state update as the plain version does;
# only the dot with C sums in another order, over 2048 serial steps at most
SSM_F32_TOL = 1e-4
# bfloat16 output: one bf16 rounding (2^-8 relative, either side) of values
# that agree to SSM_F32_TOL in float32
SSM_BF16_RTOL = 2.0 ** -7

SSM_CASES = [
    # B, S, D, N, dtype
    (4, 512, 3200, 16, torch.float32),       # hymba's width, a shorter prompt
    (2, 300, 3200, 16, torch.bfloat16),
    (1, 37, 300, 8, torch.float32),          # ragged S and D
    (2, 64, 128, 4, torch.float32),
    (1, 100, 96, 64, torch.float32),
    (3, 130, 70, 32, torch.bfloat16),
] + [
    # every state dim in both dtypes: D = 203 is a multiple of no block's
    # channel count and of no 16-byte vector, D = 256 moves as vectors; S =
    # 130 and 200 end in a partial time tile
    (B, S, D, N, dtype)
    for N in ssm_ops.STATE_DIMS for dtype in (torch.float32, torch.bfloat16)
    for B, S, D in ((2, 130, 203), (1, 200, 256))
]


def _ssm_inputs(seed, B, S, D, N, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)))).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(0.1 * rng.standard_normal((D, N))).astype(np.float32)
    return ([torch.from_numpy(t).to(device, dtype) for t in (x, dt, bm, cm)]
            + [torch.from_numpy(a).to(device)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, case):
    B, S, D, N, dtype = case
    args = _ssm_inputs(B + S + D + N, B, S, D, N, cuda, dtype)
    before = ssm_ops.LAUNCHES
    y, h = ssm_ops.ssm_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert ssm_ops.LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    want_y, want_h = ssm_scan_ref(*args, return_state=True)
    torch.testing.assert_close(h, want_h, atol=SSM_F32_TOL, rtol=SSM_F32_TOL)
    if dtype == torch.float32:
        assert torch.equal(h, want_h)     # the update rounds as the plain one
        torch.testing.assert_close(y, want_y, atol=SSM_F32_TOL, rtol=SSM_F32_TOL)
    else:
        torch.testing.assert_close(y.float(), want_y.float(), atol=SSM_F32_TOL,
                                   rtol=SSM_BF16_RTOL)
    assert torch.equal(ssm_ops.ssm_scan(*args), y)       # no state: same y


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 64, 256, 16, torch.float32, False),
                                  (2, 64, 256, 16, torch.float32, True),
                                  (1, 37, 203, 8, torch.bfloat16, False)])
def test_ssm_scan_kernel_grads_match_plain(cuda, case):
    """The kernel under autograd (its backward the plain version's, recomputed
    on the saved inputs) against autograd through the plain version."""
    B, S, D, N, dtype, with_state = case
    args = _ssm_inputs(7, B, S, D, N, cuda, dtype)
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ssm_ops.LAUNCHES
    y, h = ssm_ops.ssm_scan(*a, return_state=True)
    assert ssm_ops.LAUNCHES == before + 1 and y.grad_fn is not None
    wy, wh = ssm_scan_ref(*b, return_state=True)
    dy = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
    dh = torch.randn(h.shape, generator=gen, device=cuda)
    loss = (y.float() * dy.float()).sum() + ((h * dh).sum() if with_state else 0)
    want = (wy.float() * dy.float()).sum() + ((wh * dh).sum() if with_state else 0)
    loss.backward()
    want.backward()
    assert ssm_ops.LAUNCHES == before + 1      # the backward launches no kernel
    for x, w in zip(a, b):
        scale = max(1.0, float(w.grad.abs().max()))
        if dtype == torch.float32:
            torch.testing.assert_close(x.grad, w.grad, rtol=1e-5, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(x.grad.float(), w.grad.float(),
                                       rtol=SSM_BF16_RTOL, atol=SSM_BF16_RTOL * scale)


@pytest.mark.cuda
def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, bm, cm, a = _ssm_inputs(0, 1, 8, 16, 4, cuda)
    with pytest.raises(ValueError, match="state dim"):
        ssm_ops.ssm_scan(*_ssm_inputs(0, 1, 8, 16, 5, cuda))
    with pytest.raises(TypeError):
        ssm_ops.ssm_scan(x.half(), dt.half(), bm.half(), cm.half(), a)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_ops.ssm_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                         bm, cm, a)
    with pytest.raises(ValueError, match="different devices"):
        ssm_ops.ssm_scan(x.detach().cpu(), dt, bm, cm, a)


@pytest.mark.cuda
def test_hybrid_prefill_and_decode_on_the_card_match_cpu(cuda):
    """Reduced hymba in float32, the same params on both devices: the card
    runs both kernels (flash attention, ssm_scan), the CPU their plain
    versions and dense attention."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as TD

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="float32")
    params = TD.init_params(cfg, R.PRNGKey(0), device="cpu")
    tp = pt.tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    fa_before, ssm_before = ops.LAUNCHES, ssm_ops.LAUNCHES
    got_l, got_c = TD.prefill(cfg, tp, toks.to(cuda), cache_len=56)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == fa_before + cfg.num_layers
    assert ssm_ops.LAUNCHES == ssm_before + cfg.num_layers
    want_l, want_c = TD.prefill(cfg, params, toks, cache_len=56)
    tol = 1e-4          # cuBLAS vs CPU sums, online vs dense softmax
    torch.testing.assert_close(got_l.cpu(), want_l, atol=tol, rtol=tol)
    for (path, g), (_, w) in zip(pt.flatten_with_paths(got_c),
                                 pt.flatten_with_paths(want_c)):
        torch.testing.assert_close(g.cpu(), w, atol=tol, rtol=tol, msg=path)
    tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]
    for i in range(4):
        got_l, got_c = TD.decode_step(cfg, tp, got_c, tok.to(cuda), 48 + i)
        want_l, want_c = TD.decode_step(cfg, params, want_c, tok, 48 + i)
        torch.testing.assert_close(got_l.cpu(), want_l, atol=tol, rtol=tol)
        tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2048, 32, 8), (4, 2048, 16, 8)],
                         ids=["phi3.5-moe", "internvl2"])
def test_flash_tensor_core_at_the_zoo_families_prefill(cuda, shape):
    """The tensor-core route at phi3.5-moe's (GQA 4:1) and internvl2's
    (GQA 2:1) prefill, bf16, hd 128, causal."""
    B, S, H, KV = shape
    q, k, v = _inputs(11, B, S, S, H, KV, 128, cuda, torch.bfloat16)
    _check_tensor_core_call(q, k, v, True, None, None)


# reduced configs in float32 on the card against the CPU: cuBLAS and the CPU
# sum matmuls in other orders, the flash kernel's online softmax and the
# dense one round differently; 1e-4 abs/rel is ~100x the float32 ulps of
# O(1) logits (as the hybrid test above)
ZOO_CPU_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                                  "internvl2-2b"])
def test_zoo_family_prefill_and_decode_on_the_card_match_cpu(cuda, monkeypatch,
                                                             arch):
    """Reduced MoE (GQA attention through the flash kernel), MLA (dense at
    48 tokens, no kernel) and vlm (patch prefix, flash kernel) in float32:
    prefill and 4 decode steps, the same params on both devices; the MoE
    routing of the prefill equal on both."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as TD
    from repro_torch.models import layers as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = TD.init_params(cfg, R.PRNGKey(0), device="cpu")
    tp = pt.tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    img = (TD.image_embeds(cfg, 2, R.PRNGKey(1)) if cfg.family == "vlm" else None)
    start = 48 + (cfg.vlm.num_patches if img is not None else 0)
    before = ops.LAUNCHES
    got_l, got_c = TD.prefill(cfg, tp, toks.to(cuda),
                              None if img is None else img.to(cuda),
                              cache_len=start + 4)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + (0 if cfg.mla is not None else cfg.num_layers)
    want_l, want_c = TD.prefill(cfg, params, toks, img, cache_len=start + 4)
    torch.testing.assert_close(got_l.cpu(), want_l, atol=ZOO_CPU_TOL, rtol=ZOO_CPU_TOL)
    for (path, g), (_, w) in zip(pt.flatten_with_paths(got_c),
                                 pt.flatten_with_paths(want_c)):
        torch.testing.assert_close(g.cpu(), w, atol=ZOO_CPU_TOL, rtol=ZOO_CPU_TOL,
                                   msg=path)
    if cfg.moe is not None:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 48, cfg.d_model)).astype(np.float32))
        p0 = pt.tree_map(lambda a: a[0], params["blocks"])["moe"]
        p0c = pt.tree_map(lambda t: t.to(cuda), p0)
        routes = []
        real = TL.moe_route

        def moe_route(*args, **kw):
            routes.append(real(*args, **kw))
            return routes[-1]
        monkeypatch.setattr(TL, "moe_route", moe_route)
        TL.moe_apply(p0c, x.to(cuda), cfg)
        TL.moe_apply(p0, x, cfg)
        monkeypatch.undo()
        rc, rh = routes
        for key in ("gate_idx", "positions", "keep", "counts", "dispatch"):
            assert torch.equal(rc[key].cpu(), rh[key]), key
    tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]
    for i in range(4):
        got_l, got_c = TD.decode_step(cfg, tp, got_c, tok.to(cuda), start + i)
        want_l, want_c = TD.decode_step(cfg, params, want_c, tok, start + i)
        torch.testing.assert_close(got_l.cpu(), want_l, atol=ZOO_CPU_TOL,
                                   rtol=ZOO_CPU_TOL)
        tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "decoder"])
def test_flash_tensor_core_at_a_shrunk_seamless_shape(cuda, causal):
    """The tensor-core route at seamless-m4t's head layout (16/16 heads, hd
    64, bf16) with the sequence cut to 512: the encoder's non-causal and the
    decoder's causal self-attention."""
    q, k, v = _inputs(12, 2, 512, 512, 16, 16, 64, cuda, torch.bfloat16)
    _check_tensor_core_call(q, k, v, causal, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "seamless-m4t-large-v2"])
def test_last_families_prefill_and_decode_on_the_card_match_cpu(cuda, arch):
    """Reduced xlstm (4 layers: both cells, no kernel) and seamless (flash
    kernel in each encoder and decoder layer, dense cross-attention) in
    float32, the same params on both devices: prefill (the final mLSTM /
    sLSTM states, the self and cross K/V) and 4 decode steps; then one
    training step's loss and gradients."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch.api import ModelApi

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = {"num_layers": 4} if arch == "xlstm-125m" else {}
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)
    apis = {"cpu": ModelApi(cfg, "cpu"), "cuda": ModelApi(cfg, cuda)}
    params = apis["cpu"].init_params(R.PRNGKey(0))
    tp = pt.tree_map(lambda t: t.to(cuda), params)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)}
    if cfg.family == "audio":
        batch["src_embeds"] = 0.1 * torch.randn(2, 32, cfg.d_model, generator=gen)
    on_card = {k: t.to(cuda) for k, t in batch.items()}
    before = ops.LAUNCHES
    with torch.no_grad():
        got_l, got_c = apis["cuda"].prefill(tp, on_card, cache_len=28)
        torch.cuda.synchronize()
        layers = 0 if cfg.family == "ssm" else 2 * cfg.num_layers
        assert ops.LAUNCHES == before + layers
        want_l, want_c = apis["cpu"].prefill(params, batch, cache_len=28)
        torch.testing.assert_close(got_l.cpu(), want_l, atol=ZOO_CPU_TOL,
                                   rtol=ZOO_CPU_TOL)
        for (path, g), (_, w) in zip(pt.flatten_with_paths(got_c),
                                     pt.flatten_with_paths(want_c)):
            torch.testing.assert_close(g.cpu(), w, atol=ZOO_CPU_TOL,
                                       rtol=ZOO_CPU_TOL, msg=path)
        tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]
        for i in range(4):
            got_l, got_c = apis["cuda"].decode_step(tp, got_c, tok.to(cuda), 24 + i)
            want_l, want_c = apis["cpu"].decode_step(params, want_c, tok, 24 + i)
            torch.testing.assert_close(got_l.cpu(), want_l, atol=ZOO_CPU_TOL,
                                       rtol=ZOO_CPU_TOL)
            tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    on_card["labels"] = batch["labels"].to(cuda)
    (gl, _), gg = pt.value_and_grad(apis["cuda"].loss_fn, tp, on_card)
    (wl, _), wg = pt.value_and_grad(apis["cpu"].loss_fn, params, batch)
    torch.testing.assert_close(gl.cpu(), wl, atol=ZOO_CPU_TOL, rtol=ZOO_CPU_TOL)
    for (path, g), (_, w) in zip(pt.flatten_with_paths(gg), pt.flatten_with_paths(wg)):
        torch.testing.assert_close(g.cpu(), w, atol=ZOO_CPU_TOL, rtol=ZOO_CPU_TOL,
                                   msg=path)


@pytest.mark.cuda
def test_flash_mha_on_the_card_matches_cpu(cuda):
    """The long-sequence path on the card (torch ops, no kernel) at MLA's
    head dims 192 / 128 and 2,049 tokens: forward and gradients against the
    CPU in float32 (the same blocks, other summation orders)."""
    from repro_torch.models import layers as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    S = TL.CHUNKED_ATTN_THRESHOLD + 1
    host = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, S, 2, 192), (1, S, 2, 192), (1, S, 2, 128), (1, S, 2, 128))]
    pos = torch.arange(S, dtype=torch.int32)
    outs = {}
    for dev in ("cpu", cuda):
        q, k, v = (t.detach().to(dev).requires_grad_() for t in host[:3])
        o = TL.flash_mha(q, k, v, pos.to(dev), pos.to(dev), True, None)
        o.backward(host[3].to(dev))
        outs[str(dev)] = [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(g, w, atol=ZOO_CPU_TOL, rtol=ZOO_CPU_TOL, msg=name)


# ---------------------------------------------------------------------------
# the while and host FL drivers on the card
# ---------------------------------------------------------------------------

DRIVER_CASES = {
    # FLConfig overrides, run_fl's (max_rounds, patience, eval_every)
    "patience_fires": (dict(), (9, 1, 2)),
    "ragged_last_chunk": (dict(), (7, 50, 3)),
    "cohort_streaming": (dict(participation=4, streaming_windows=True,
                              client_chunk=2), (5, 50, 2)),
}


def _driver_inputs(case):
    """A small LoGTST (flash on) and PSGF-Fed with the fused downlink over
    six ``ev`` stations, in the layout ``case`` asks for."""
    from repro_torch.core.fl import engine as E
    from repro_torch.data.synthetic import ev_synthetic
    from repro_torch.data.windowing import client_datasets, client_series_datasets

    torch.backends.cuda.matmul.allow_tf32 = False
    fl_kw, (max_rounds, patience, eval_every) = DRIVER_CASES[case]
    cfg = F.logtst_config(look_back=16, horizon=2, d_model=16, num_heads=2,
                          d_ff=32, patch_len=8, stride=4, use_flash_attn=True)
    series = ev_synthetic(seed=0, num_clients=6, num_days=120)
    build = (client_series_datasets if fl_kw.get("streaming_windows")
             else client_datasets)
    tr, _, te, _ = build(series, 16, 2)
    fl = E.FLConfig(num_clients=6, batch_size=8, local_steps=2,
                    use_pallas_mix=True, **fl_kw)
    kw = dict(max_rounds=max_rounds, patience=patience, eval_every=eval_every)
    return cfg, fl, tr, te, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_while_driver_on_the_card_matches_scan(cuda, case):
    """``run_fl(driver="while")`` on the card replays one captured graph per
    chunk length and stops where the scan driver on the card stops:
    ``rounds_run``, comm, the history's round indices and the counters
    bitwise; losses, RMSE and states within FL_PARITY_TOL (the graphs run
    the same kernels; the tolerance covers a cuBLAS algorithm that differs
    under capture). The same run driven stage by stage replays its chunks
    under ``set_sync_debug_mode("error")`` up to the final read, and equals
    ``run_fl``'s bitwise."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E

    cfg, fl, tr, te, kw = _driver_inputs(case)
    wh = E.run_fl(cfg, fl, tr, te, R.PRNGKey(1), driver="while",
                  device="cuda", **kw)
    sh = E.run_fl(cfg, fl, tr, te, R.PRNGKey(1), driver="scan",
                  device="cuda", **kw)
    run = wh["while_run"]
    lengths = {kw["eval_every"], kw["max_rounds"] % kw["eval_every"]} - {0}
    assert run["captured"] == sorted(lengths)
    assert sorted(run["replays"]) == sorted(lengths)
    assert (len(wh["rmse"]) <= sum(run["replays"].values())
            <= len(wh["rmse"]) + 1)
    assert wh["rounds_run"] == sh["rounds_run"]
    if case == "patience_fires":
        assert wh["rounds_run"] < kw["max_rounds"]
    assert wh["round"] == sh["round"] and wh["comm"] == sh["comm"]
    assert [r for r, _ in wh["rmse"]] == [r for r, _ in sh["rmse"]]
    tol = E.FL_PARITY_TOL
    np.testing.assert_allclose(wh["train_loss"], sh["train_loss"], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose([v for _, v in wh["rmse"]],
                               [v for _, v in sh["rmse"]], rtol=tol, atol=tol)
    keep = E.bk_free(wh["meta"]).to(cuda)
    for name, want in sh["state"].items():
        got = wh["state"][name]
        if name in ("comm_down", "comm_up", "round", "adam_t"):
            assert torch.equal(got, want), name
        else:
            torch.testing.assert_close(got[..., keep], want[..., keep],
                                       atol=tol, rtol=tol, msg=name)

    # stage by stage, as run_fl runs it, with every host sync an error
    key = R.split(R.PRNGKey(1, device="cuda")).unbind(0)
    state, meta = E.init_fl_state(cfg, fl, key[1], device="cuda")
    step = E._WhileRun(state, key[0], torch.from_numpy(tr).to(cuda),
                       torch.from_numpy(te).to(cuda), cfg, fl, meta,
                       E.pol.from_config(fl), kw["max_rounds"],
                       kw["eval_every"], kw["patience"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.launch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rounds, chunks, losses, comms, rmses = step.read()
    assert (rounds, losses, comms) == (wh["rounds_run"], wh["train_loss"],
                                       wh["comm"])
    assert rmses == [v for _, v in wh["rmse"]]
    assert all(torch.equal(step.state[k], wh["state"][k]) for k in state)


@pytest.mark.cuda
def test_host_driver_on_the_card_equals_loop(cuda):
    """``run_fl(driver="host")`` on the card, the store pinned in host
    memory, against the loop driver on the card with the fleet on the
    device: states, comm and ``rounds_run`` bitwise."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E

    cfg, fl, tr, te, _ = _driver_inputs("cohort_streaming")
    kw = dict(max_rounds=5, patience=2, eval_every=2)
    lh = E.run_fl(cfg, fl, tr, te, R.PRNGKey(3), driver="loop",
                  device="cuda", **kw)
    hh = E.run_fl(cfg, fl, tr, te, R.PRNGKey(3), driver="host",
                  device="cuda", **kw)
    store = hh["client_store"]
    assert store.pinned
    for name in E._CLIENT_AXIS_KEYS + ("train", "test"):
        assert getattr(store, name).is_pinned(), name
    assert hh["state"]["w_global"].is_cuda
    for name in ("rounds_run", "round", "train_loss", "comm", "final_comm"):
        assert hh[name] == lh[name], name
    for name, want in lh["state"].items():
        assert torch.equal(hh["state"][name].to(cuda), want), name
    np.testing.assert_allclose(hh["final_rmse"], lh["final_rmse"], rtol=1e-6)
    store.close()
    assert not store.w_clients.is_pinned()


# ---------------------------------------------------------------------------
# the gateway and the flywheel on the card
# ---------------------------------------------------------------------------

SERVE_TOL = 1e-4     # served on the card against the CPU forward (chip_smoke.py)


def _flywheel_root(root):
    """A generation-0 root of two clusters of six ``ev`` stations, trained
    on the card by the port (small LoGTST, flash on, the fused downlink)."""
    from repro_torch.core.tasks import (ExperimentSpec, get_task,
                                        run_experiment, task_forecaster)

    torch.backends.cuda.matmul.allow_tf32 = False
    task = get_task("ev", quick=True, clusters=2, num_clients=12,
                    num_days=150, look_back=32, horizon=2)
    model = task_forecaster(task, "logtst", quick=True, d_model=16,
                            num_heads=2, d_ff=32, use_flash_attn=True)
    spec = ExperimentSpec(task=task, model=model,
                          grid=(("psgf", {"use_pallas_mix": True}),),
                          local_steps=2, batch_size=16, max_rounds=4,
                          patience=10, eval_every=2)
    series = task.series()
    labels = task.cluster_labels(series, device="cuda")
    run_experiment(spec, checkpoint_dir=root, series=series, labels=labels,
                   device="cuda")
    return spec, series, labels


@pytest.mark.cuda
def test_gateway_on_the_card_matches_cpu_forward(cuda, tmp_path):
    """HTTP requests through the gateway, served on the card, against the
    CPU forward of the same checkpoint within SERVE_TOL."""
    from repro_torch.core.forecaster import load_forecaster
    from repro_torch.launch.gateway import ForecastGateway, request_json
    from repro_torch.launch.serve_forecast import ForecastServer

    root = str(tmp_path / "root")
    spec, _, labels = _flywheel_root(root)
    server = ForecastServer.from_manifest(root, device="cuda", max_batch=8)
    server.warmup(channels=3)
    cpu = {c: load_forecaster(f"{root}/psgf-s30-f20_c{c}", device="cpu")
           for c in (0, 1)}
    rng = np.random.default_rng(0)
    with ForecastGateway(server, auth_token="t") as gw:
        for s in range(len(labels)):
            x = rng.standard_normal((3, 32)).astype(np.float32)
            status, _, body = request_json(*gw.address, "POST", "/v1/forecast",
                                           {"x": x.tolist(), "station": s},
                                           token="t")
            assert status == 200 and body["cluster"] == int(labels[s])
            fc, params, _ = cpu[body["cluster"]]
            with torch.inference_mode():
                want = F.forward_multivariate(fc.cfg, params,
                                              torch.from_numpy(x)[None])[0]
            np.testing.assert_allclose(np.asarray(body["y"], np.float32),
                                       want.numpy(), atol=SERVE_TOL,
                                       rtol=SERVE_TOL)
        status, _, health = request_json(*gw.address, "GET", "/healthz")
        assert status == 200 and health["generation"] == 0
    server.close()


@pytest.mark.cuda
def test_while_retrain_beside_serving_equals_the_retrain_alone(cuda, tmp_path):
    """A ``while`` retrain (warm-up, CUDA-graph capture, replays) in one
    thread while another submits to the server on the same card without a
    pause: no error, every future resolved, the server hot-swapped, and the
    retrained parameters bitwise equal to the same retrain run alone."""
    import dataclasses
    import shutil
    import threading

    from repro_torch.core.fl.flywheel import RetrainController
    from repro_torch.core.forecaster import load_forecaster
    from repro_torch.launch.serve_forecast import ForecastServer

    root = str(tmp_path / "root")
    spec, series, labels = _flywheel_root(root)
    spec = dataclasses.replace(spec, driver="while")
    alone = str(tmp_path / "alone")
    shutil.copytree(root, alone)
    server = ForecastServer.from_manifest(root, device="cuda", max_batch=8,
                                          max_wait_ms=0.5)
    server.warmup(channels=1)
    server.start()
    ctl = RetrainController(spec, root, series=series, labels=labels,
                            server=server, device="cuda")
    out, errors = {}, []

    def retrain():
        try:
            out.update(ctl.retrain([1]))
        except Exception as exc:          # reported below
            errors.append(exc)

    t = threading.Thread(target=retrain)
    futs = []
    x = np.random.default_rng(1).standard_normal((1, 32)).astype(np.float32)
    t.start()
    while t.is_alive():
        futs.append(server.submit(x, station=int(np.flatnonzero(labels == 1)[0])))
        if len(futs) % 16 == 0:
            futs[-16].result(timeout=60)
    t.join()
    ys = [f.result(timeout=60) for f in futs]
    assert not errors, errors
    assert out["generation"] == server.generation == 1
    assert len(ys) > 0 and all(np.isfinite(y).all() for y in ys)
    row = out["rows"][1]
    assert row["while_run"]["captured"] == [2]
    server.close()

    RetrainController(spec, alone, series=series, labels=labels,
                      device="cuda").retrain([1])
    sub = "psgf-s30-f20_c1_g1"
    got = load_forecaster(f"{root}/{sub}", device="cpu")[1]
    want = load_forecaster(f"{alone}/{sub}", device="cpu")[1]
    for (path, g), (_, w) in zip(pt.flatten_with_paths(got),
                                 pt.flatten_with_paths(want)):
        assert torch.equal(g, w), path


@pytest.mark.cuda
def test_two_controllers_retraining_at_once_equal_the_retrains_in_turn(
        cuda, tmp_path):
    """A scan controller and a while controller of one root retrain two
    clusters in two threads at once on the card. The device lock runs them
    one after the other, so each row and each retrained model is bitwise
    the one the same two retrains give run in turn, in the order their
    generations show (a psgf_mix run beside another would corrupt the
    shared ticket counter and so the comm counts)."""
    import dataclasses
    import shutil
    import threading

    from repro_torch.core.fl.flywheel import RetrainController
    from repro_torch.core.forecaster import load_forecaster

    root = str(tmp_path / "root")
    spec, series, labels = _flywheel_root(root)
    specs = {0: spec, 1: dataclasses.replace(spec, driver="while")}
    alone = str(tmp_path / "alone")
    shutil.copytree(root, alone)
    rows, errors = {}, []

    def retrain(c):
        try:
            ctl = RetrainController(specs[c], root, series=series,
                                    labels=labels, device="cuda")
            rows.update(ctl.retrain([c])["rows"])
        except Exception as exc:          # reported below
            errors.append(exc)

    threads = [threading.Thread(target=retrain, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert sorted(r["generation"] for r in rows.values()) == [1, 2]
    for c in sorted(rows, key=lambda c: rows[c]["generation"]):
        want = RetrainController(specs[c], alone, series=series, labels=labels,
                                 device="cuda").retrain([c])["rows"][c]
        keys = ("rounds", "comm_params", "rmse", "generation")
        assert [rows[c][k] for k in keys] == [want[k] for k in keys]
        sub = f"psgf-s30-f20_c{c}_g{want['generation']}"
        got = load_forecaster(f"{root}/{sub}", device="cpu")[1]
        ref = load_forecaster(f"{alone}/{sub}", device="cpu")[1]
        for (path, g), (_, w) in zip(pt.flatten_with_paths(got),
                                     pt.flatten_with_paths(ref)):
            assert torch.equal(g, w), (c, path)


@pytest.mark.cuda
def test_captured_calls_are_counted_per_thread(cuda):
    """Calls captured into a CUDA graph on one thread (``thread_local``
    mode) count in that thread's ``captured_calls``; calls that another
    thread launches on its own stream meanwhile count in ``LAUNCHES``
    only."""
    import threading
    import time

    q, k, v = _inputs(3, 96, 15, 15, 16, 16, 8, cuda)
    g, w, m = _mix_inputs(4, 3, 4096, "binary", cuda)
    flash_attention(q, k, v)
    mix_ops.psgf_mix_batch(g, w, m)          # the ticket counter, outside
    torch.cuda.synchronize()
    capturing, stop, seen = threading.Event(), threading.Event(), {}

    def serve():
        with torch.cuda.stream(torch.cuda.Stream()):
            capturing.wait()
            while not stop.is_set():
                flash_attention(q, k, v)
                seen["served"] = seen.get("served", 0) + 1
            torch.cuda.current_stream().synchronize()
        seen["captured"] = (ops.captured_calls(), mix_ops.captured_calls())

    t = threading.Thread(target=serve)
    t.start()
    before = (ops.LAUNCHES, ops.captured_calls(), mix_ops.captured_calls())
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            capturing.set()
            for _ in range(3):
                flash_attention(q, k, v)
                mix_ops.psgf_mix_batch(g, w, m)
            deadline = time.time() + 30       # let the other thread launch
            while seen.get("served", 0) < 5 and time.time() < deadline:
                time.sleep(0.001)
        finally:
            graph.capture_end()
    stop.set()
    t.join()
    assert (ops.captured_calls() - before[1],
            mix_ops.captured_calls() - before[2]) == (3, 3)
    assert seen["captured"] == (0, 0) and seen["served"] > 0
    assert ops.LAUNCHES - before[0] == 3 + seen["served"]
    graph.replay()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# several processes on the card (gloo, staged through pinned host memory)
# ---------------------------------------------------------------------------

_CARD_CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
from repro_torch import random as R
from repro_torch.core import forecast as F
from repro_torch.core.fl.engine import FLConfig, run_fl
from repro_torch.launch import distributed as D
from repro_torch.launch.mesh import make_client_mesh

out_dir, run, fl_kw, cfg_kw = sys.argv[1], *map(json.loads, sys.argv[2:5])
assert D.initialize_distributed(device="cuda:0")
torch.backends.cuda.matmul.allow_tf32 = False
idx = D.process_index()
z = np.load(out_dir + "/inputs.npz")
out = {"backend": D.backend(), "device": str(D.device())}
# the exchange primitives on card tensors: bit transport, results on the card
full = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 3))
                        .astype(np.float32)).cuda()
full[0, 0] = -0.0
lo, hi = D.block_range(8)
mine = torch.zeros_like(full)
mine[lo:hi] = full[lo:hi]
merged = D.merge_disjoint(mine)
gathered = D.allgather_blocks(full[lo:hi], 8)
out["exchange"] = {
    "on_card": merged.is_cuda and gathered.is_cuda,
    "merge_exact": torch.equal(merged.view(torch.int32), full.view(torch.int32)),
    "gather_exact": torch.equal(gathered.view(torch.int32), full.view(torch.int32))}
mesh = make_client_mesh(multi_host=True)
cfg = F.logtst_config(**cfg_kw)
for name, kw in (("host", dict(driver="host")),
                 ("scan", dict(driver="scan", client_mesh=mesh)),
                 ("while", dict(driver="while", client_mesh=mesh))):
    h = run_fl(cfg, FLConfig(**fl_kw), z["train"], z["test"], R.PRNGKey(2),
               device="cuda", **run, **kw)
    np.savez(f"{out_dir}/{name}_{idx}.npz",
             **{k: v.cpu().numpy() for k, v in h["state"].items()})
    out[name] = {"losses": h["train_loss"], "comm": h["comm"],
                 "rmse": [[int(r), float(v)] for r, v in h["rmse"]],
                 "rows": h["owned_rows"], "mesh_run": h.get("mesh_run")}
D.sync("done")
D.shutdown_distributed()
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_two_processes_on_one_card_equal_one_process(cuda, tmp_path):
    """Two processes on ``cuda:0`` over gloo (the exchanges staged through
    pinned host memory): the exchange primitives move card tensors bit for
    bit; the partitioned ``host`` run equals the 1-process ``host`` run on
    the card, and the mesh's ``scan`` and ``while`` the 1-process ``scan``
    run, bitwise (losses, comm, RMSE, every state leaf, each process's
    client rows). The mesh's ``while`` replays its four captured segments
    around the host exchanges; each segment captures the kernels its eager
    run launches at the same shapes, as ``chip_smoke.py`` phase 10 also
    holds at full width."""
    import json
    import os
    import sys

    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.data.synthetic import nn5_synthetic
    from repro_torch.data.windowing import client_series_datasets
    from repro_torch.launch import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_kw = dict(look_back=16, horizon=2, d_model=16, num_heads=2, d_ff=32,
                  patch_len=8, stride=4, use_flash_attn=True)
    fl_kw = dict(policy="psgf", num_clients=12, local_steps=2, batch_size=8,
                 streaming_windows=True, participation=8, client_chunk=2,
                 use_pallas_mix=True)
    run = dict(max_rounds=4, patience=99, eval_every=2)
    tr, _, te, _ = client_series_datasets(
        nn5_synthetic(seed=0, num_clients=12, num_days=120), 16, 2)
    np.savez(tmp_path / "inputs.npz", train=tr, test=te)
    cfg, fl = F.logtst_config(**cfg_kw), E.FLConfig(**fl_kw)
    want = {d: E.run_fl(cfg, fl, tr, te, R.PRNGKey(2), driver=d,
                        device="cuda", **run) for d in ("host", "scan")}
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    procs = D.spawn_processes(
        2, [sys.executable, "-c", _CARD_CHILD, str(tmp_path), json.dumps(run),
            json.dumps(fl_kw), json.dumps(cfg_kw)], env=env, timeout=600,
        coordinator=f"file://{tmp_path / 'store'}")
    for i, r in enumerate(procs):
        assert r.returncode == 0, f"child {i}:\n{r.stderr[-4000:]}"
    reps = [json.loads(r.stdout.strip().splitlines()[-1]) for r in procs]
    for i, rep in enumerate(reps):
        assert (rep["backend"], rep["device"]) == ("gloo", "cuda:0")
        assert all(rep["exchange"].values()), rep["exchange"]
        for name in ("host", "scan", "while"):
            h = want["host" if name == "host" else "scan"]
            got, (lo, hi) = rep[name], rep[name]["rows"]
            state = np.load(tmp_path / f"{name}_{i}.npz")
            assert got["comm"] == h["comm"], name
            assert [r for r, _ in got["rmse"]] == [r for r, _ in h["rmse"]]
            for k, v in h["state"].items():
                v = v.cpu().numpy()
                v = v[lo:hi] if k in E._CLIENT_AXIS_KEYS else v
                np.testing.assert_array_equal(state[k], v, err_msg=f"{name}/{k}")
            assert got["losses"] == h["train_loss"], name
            assert got["rmse"] == [[r, v] for r, v in h["rmse"]], name
        run_ = rep["while"]["mesh_run"]
        assert run_["graphs"] == ["payload", "local", "up", "end_chunk"]
        assert run_["replays"] == {"payload": 3, "local": 3, "up": 3,
                                   "end_chunk": 2}


@pytest.mark.cuda
def test_client_grads_depend_on_the_vmap_width_on_the_card(cuda):
    """Why a process must run the one-process run's own ``client_chunk``
    chunks on the card too (``partition.validate_partition``): at the nn5
    cell's full width, LocalUpdate's gradients of 128 clients in one vmap
    differ from the same clients' in two vmaps of 64, and the chunked call
    equals the two halves bit for bit."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.core.tasks import get_task, task_forecaster
    from repro_torch.models.spec import init_params_from_key

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = task_forecaster(get_task("nn5", quick=False), "logtst", quick=False,
                          use_flash_attn=True).cfg
    params = init_params_from_key(F.model_spec(cfg), R.PRNGKey(0), cuda)
    vec, meta = pt.tree_flatten_to_vector(params)
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, b = 128, 32                     # the cell's cohort block and batch
    w = vec[None].repeat(n, 1) + 0.01 * torch.randn(n, vec.numel(),
                                                    generator=gen, device=cuda)
    x = torch.randn(n, b, cfg.look_back, generator=gen, device=cuda)
    y = torch.randn(n, b, cfg.horizon, generator=gen, device=cuda)
    with torch.no_grad():
        whole, _ = E._client_grads(cfg, meta, w, x, y, None)
        halves = torch.cat([E._client_grads(cfg, meta, w[i:i + 64],
                                            x[i:i + 64], y[i:i + 64], None)[0]
                            for i in (0, 64)])
        chunked, _ = E._client_grads(cfg, meta, w, x, y, 64)
    assert not torch.equal(whole, halves)
    assert torch.equal(chunked, halves)


# ---------------------------------------------------------------------------
# a local mesh: two shards of one card, each on its own stream
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_psgf_mix_on_two_streams_of_one_device_at_once(cuda):
    """Two streams of one device launch psgf_mix_batch at once, 20 calls
    each with no host wait between them (a local mesh's two shards of one
    card): each stream counts on its own ticket counter, so every call's
    mix and count equal the plain version's bit for bit, and each call
    counts one launch."""
    ins = [_mix_inputs(11 + i, 27, 273_284, "binary", cuda) for i in range(2)]
    want = [psgf_mix_batch_ref(*a) for a in ins]
    streams = [torch.cuda.Stream(cuda) for _ in ins]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    before = mix_ops.LAUNCHES
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(mix_ops.psgf_mix_batch(*ins[i]))
    torch.cuda.synchronize()
    assert mix_ops.LAUNCHES - before == 40
    index = torch.cuda.current_device()
    assert len({mix_ops._TICKET_SLOTS[(index, s.cuda_stream)]
                for s in streams}) == 2
    for i, calls in enumerate(outs):
        for mixed, count in calls:
            assert torch.equal(mixed, want[i][0])
            assert torch.equal(count, want[i][1])


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["scan", "while"])
def test_local_mesh_on_one_card_equals_the_unsharded_run(cuda, driver):
    """``run_fl(client_mesh=Mesh("clients", (cuda:0, cuda:0)))``: two shards
    of the card, each on its own stream (``while``: each shard's four
    segments captured on its stream), bitwise the unsharded scan run on the
    card (losses, comm, RMSE, every state leaf of the whole client axis), as
    ``chip_smoke.py`` phase 15 also holds at full width."""
    from repro_torch import random as R
    from repro_torch.core.fl import engine as E
    from repro_torch.data.synthetic import nn5_synthetic
    from repro_torch.data.windowing import client_series_datasets
    from repro_torch.launch.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = F.logtst_config(look_back=16, horizon=2, d_model=16, num_heads=2,
                          d_ff=32, patch_len=8, stride=4, use_flash_attn=True)
    fl = E.FLConfig(policy="psgf", num_clients=12, local_steps=2,
                    batch_size=8, streaming_windows=True, participation=8,
                    client_chunk=2, use_pallas_mix=True)
    tr, _, te, _ = client_series_datasets(
        nn5_synthetic(seed=0, num_clients=12, num_days=120), 16, 2)
    kw = dict(max_rounds=4, patience=99, eval_every=2, device="cuda")
    want = E.run_fl(cfg, fl, tr, te, R.PRNGKey(2), driver="scan", **kw)
    card = torch.device("cuda", torch.cuda.current_device())
    got = E.run_fl(cfg, fl, tr, te, R.PRNGKey(2), driver=driver,
                   client_mesh=Mesh("clients", (card, card)), **kw)
    for k in ("rounds_run", "train_loss", "comm", "rmse", "final_rmse"):
        assert got[k] == want[k], k
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    run = got["mesh_run"]
    assert (run["shards"], run["sharded"], run["backend"]) == (2, True, "local")
    if driver == "while":
        assert run["graphs"] == ["payload", "local", "up", "end_chunk"]
        assert run["replays"] == {"payload": 3, "local": 3, "up": 3,
                                  "end_chunk": 2}


@pytest.mark.cuda
def test_shard_batch_on_one_card(cuda, monkeypatch):
    """``ForecastServer(shard_batch=True)`` over two shards of the card:
    each block of a bucket of 8 bitwise the plain server's forward of that
    block, the bucket within the served tolerance of the plain server's
    (cuBLAS picks its kernels by M), a bucket of 1 bitwise."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve_forecast import ForecastServer

    torch.backends.cuda.matmul.allow_tf32 = False
    fc = get_forecaster("logtst", look_back=16, horizon=2, d_model=16,
                        num_heads=2, d_ff=16, patch_len=8, stride=4,
                        use_flash_attn=True)
    params = fc.init_params(torch.Generator().manual_seed(0), device="cuda")
    plain = ForecastServer(fc, params, max_batch=8, device="cuda")
    card = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setattr(M, "make_batch_mesh",
                        lambda axis="batch", device=None: M.Mesh(axis, (card, card)))
    shard = ForecastServer(fc, params, max_batch=8, device="cuda",
                           shard_batch=True)
    x = np.random.default_rng(0).standard_normal((8, 3, 16)).astype(np.float32)
    got = shard.predict(x)
    for i in range(2):
        np.testing.assert_array_equal(got[4 * i:4 * (i + 1)],
                                      plain.predict(x[4 * i:4 * (i + 1)]))
    np.testing.assert_allclose(got, plain.predict(x), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(shard.predict(x[:1]), plain.predict(x[:1]))
