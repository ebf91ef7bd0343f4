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
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

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


@pytest.mark.cuda
def test_flash_kernel_padding_inert_and_dead_rows_zero(cuda):
    q, k, v = _inputs(1, 1, 256, 128, 2, 2, 16, cuda)
    base = flash_attention(q, k, v, causal=False, window=16, kv_len=100)
    k[:, 100:], v[:, 100:] = 50.0, -50.0
    assert torch.equal(base, flash_attention(q, k, v, causal=False, window=16,
                                             kv_len=100))
    assert torch.equal(base[0, 115:], torch.zeros_like(base[0, 115:]))


@pytest.mark.cuda
def test_flash_kernel_grads_match_plain(cuda):
    a = [t.requires_grad_() for t in _inputs(2, 1, 60, 60, 4, 2, 16, cuda)]
    b = [t.detach().clone().requires_grad_() for t in a]
    torch.sin(flash_attention(*a, causal=False)).sum().backward()
    torch.sin(flash_attention_ref(*b, causal=False)).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=2e-5, rtol=2e-5)


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
