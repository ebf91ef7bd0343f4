"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX kernel in interpret mode and against the JAX dense oracle, at
cut-down sizes of tests/test_kernels.py's cases. The CUDA kernel itself runs
only on a GPU: tests/test_torch_kernels_cuda.py holds it against the plain
version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.core.forecast import FLASH_ATTN_TOL  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

BF16_TOL = 2e-2

FA_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, dtype, tol
    (2, 64, 64, 4, 2, 16, True, None, np.float32, FLASH_ATTN_TOL),   # GQA causal
    (1, 100, 100, 4, 4, 32, True, 17, np.float32, 2e-5),             # window
    (2, 48, 96, 4, 2, 16, False, None, np.float32, FLASH_ATTN_TOL),  # Sq != Skv
    (1, 64, 64, 2, 1, 128, True, None, "bfloat16", BF16_TOL),        # bf16
]

PAD_BIDIR_CASES = [
    # bidirectional at lengths that are not block multiples; (2, 15, 15, 4,
    # 4, 8) is the forecaster's LoGTST token count and head dim
    (2, 15, 15, 4, 4, 8),
    (1, 100, 100, 4, 2, 32),
    (1, 120, 120, 8, 8, 16),
    (3, 63, 63, 2, 1, 64),
]


def _inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_matches_jax_kernel_and_oracle(case):
    B, Sq, Skv, H, KV, hd, causal, window, dtype, tol = case
    arrs = _inputs(1, B, Sq, Skv, H, KV, hd)
    if dtype == "bfloat16":
        jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
        tq = _torch(arrs, torch.bfloat16)
    else:
        jq = [jnp.asarray(a) for a in arrs]
        tq = _torch(arrs)
    got = flash_attention(*tq, causal=causal, window=window)
    assert got.dtype == tq[0].dtype and got.shape == (B, Sq, H, hd)
    got = got.float().numpy()
    kern = jax_flash(*jq, causal=causal, window=window, block_q=128,
                     block_k=128, interpret=True)
    dense = attention_ref(*jq, causal=causal, window=window)
    for want in (kern, dense):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("case", PAD_BIDIR_CASES)
def test_plain_bidirectional_ragged_matches_jax(case):
    B, Sq, Skv, H, KV, hd = case
    arrs = _inputs(2, B, Sq, Skv, H, KV, hd)
    got = flash_attention(*_torch(arrs), causal=False).numpy()
    jq = [jnp.asarray(a) for a in arrs]
    kern = jax_flash(*jq, causal=False, block_q=128, block_k=128,
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(attention_ref(
        *jq, causal=False, window=None)), atol=2e-5, rtol=2e-5)


def test_kv_len_poisoned_keys_inert():
    """Keys at and past kv_len never reach an output, bitwise; the result
    matches the JAX kernel called with the same kv_len."""
    q, k, v = _inputs(3, 1, 128, 256, 2, 2, 16)
    base = flash_attention(*_torch((q, k, v)), causal=False, kv_len=100)
    kp, vp = k.copy(), v.copy()
    kp[:, 100:], vp[:, 100:] = 50.0, -50.0
    poisoned = flash_attention(*_torch((q, kp, vp)), causal=False, kv_len=100)
    np.testing.assert_array_equal(base.numpy(), poisoned.numpy())
    want = flash_attention_kernel(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), causal=False, block_q=128,
                                  block_k=128, kv_len=100, interpret=True)
    np.testing.assert_allclose(base.numpy(), np.asarray(want),
                               atol=FLASH_ATTN_TOL, rtol=FLASH_ATTN_TOL)


def test_fully_masked_rows_are_zero():
    """Rows whose one-sided window holds only padding return exact zeros, as
    the JAX kernel does (its masked-exp hardening)."""
    q, k, v = _inputs(4, 1, 128, 128, 2, 2, 16)
    got = flash_attention(*_torch((q, k, v)), causal=False, window=16,
                          kv_len=100).numpy()
    dead = got[0, 115:]      # keys k > q - 16 and k < 100: none for q >= 115
    np.testing.assert_array_equal(dead, np.zeros_like(dead))
    want = flash_attention_kernel(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=False, window=16, block_q=128,
                                  block_k=128, kv_len=100, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_grads_match_jax_custom_vjp():
    """Autograd of the plain version == the JAX wrapper's custom VJP (whose
    backward is the dense oracle's VJP)."""
    arrs = _inputs(5, 1, 60, 60, 4, 2, 16)
    tq = [t.requires_grad_() for t in _torch(arrs)]
    torch.sin(flash_attention(*tq, causal=False)).sum().backward()

    def f(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, causal=False, block_q=128,
                                         block_k=128, interpret=True)))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    for t, w in zip(tq, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=2e-5)


def test_cpu_path_launches_nothing():
    before = ops.LAUNCHES
    flash_attention(*_torch(_inputs(6, 2, 15, 15, 4, 4, 8)), causal=False)
    assert ops.LAUNCHES == before


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v = _torch(_inputs(7, 1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 8), v[:, :, :1].expand(1, 8, 3, 8))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=9)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[..., :4], v[..., :4])
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q.to("meta"), k, v)
    # meta tensors (the dry run's) run the plain version on shapes alone
    before = ops.LAUNCHES
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape and ops.LAUNCHES == before


def test_build_names_library_by_source_hash(monkeypatch):
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch_kernels")
    assert path == _build.library_path("flash_attention")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15flash_tc_kernelILi128EEv' for 'sm_90a'
ptxas info    : Function properties for _Z15flash_tc_kernelILi128EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z15flash_tc_kernelILi64EEv' for 'sm_90a'
ptxas info    : Function properties for _Z15flash_tc_kernelILi64EEv
    32 bytes stack frame, 32 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 32 bytes cumulative stack size
"""


def test_parse_ptxas_reads_registers_and_spills_per_entry():
    report = _build.parse_ptxas(PTXAS_LOG)
    assert report == {
        "_Z15flash_tc_kernelILi128EEv": dict(registers=168, stack_bytes=0,
                                            spill_stores=0, spill_loads=0),
        "_Z15flash_tc_kernelILi64EEv": dict(registers=128, stack_bytes=32,
                                           spill_stores=32, spill_loads=24)}
    assert _build.parse_ptxas("") == {}


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, KV, hd, causal, window, kv_len
    (2, 15, 15, 4, 4, 8, False, None, None),      # the forecaster's shape
    (1, 33, 33, 4, 2, 16, True, None, None),      # GQA causal
    (1, 40, 40, 2, 1, 8, True, 7, None),          # window
    (1, 24, 30, 2, 2, 8, False, 5, 12),           # rows with no valid key
])
def test_backward_formulas_match_autograd_of_plain(case):
    """The kernel's backward (gradients written out in torch ops) against
    autograd through the plain version, masks included."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, flash_attention_ref_backward)

    B, Sq, Skv, H, KV, hd, causal, window, kv_len = case
    q, k, v = (t.requires_grad_() for t in
               _torch(_inputs(8, B, Sq, Skv, H, KV, hd)))
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, Sq, H, hd)).astype(np.float32))
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    flash_attention_ref(q, k, v, **mask).backward(do)
    got = flash_attention_ref_backward(q.detach(), k.detach(), v.detach(), do,
                                       **mask)
    for g, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def _kernel_route_on_cpu(monkeypatch):
    """Send the wrapper's calls through ``_FlashAttention`` (the CUDA route)
    with the launch replaced by the plain forward, counting launches."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    calls = []

    def fake_launch(q, k, v, causal, window, kv_len):
        assert not torch._C._functorch.is_batchedtensor(q)   # folded by vmap
        calls.append(tuple(q.shape))
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)

    monkeypatch.setattr(ops, "_launch", fake_launch)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, *, causal=True, window=None, kv_len=None:
                        ops._FlashAttention.apply(q, k, v, causal, window, kv_len))
    return calls


def test_kernel_function_runs_under_vmap_of_grad(monkeypatch):
    """``vmap(grad(...))`` through the kernel's ``autograd.Function`` (the
    FL engine's per-client LocalUpdate, with flash on, on the card): the
    vmapped axis is folded into the batch (one launch), and the gradients
    equal those through the plain version."""
    from repro_torch.core import forecast as TF
    from repro_torch.common import pytree_utils as pt

    cfg = TF.logtst_config(look_back=32, horizon=2, d_model=16, num_heads=2,
                           d_ff=16, patch_len=8, stride=4)
    params = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    vec, meta = pt.tree_flatten_to_vector(params)
    rng = np.random.default_rng(10)
    K = 3
    w = vec[None].repeat(K, 1) + 0.01 * torch.from_numpy(
        rng.standard_normal((K, meta.total)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((K, 5, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((K, 5, 2)).astype(np.float32))

    def grads(c):
        def loss(wv, xb, yb):
            return TF.mse_loss(c, pt.tree_unflatten_from_vector(wv, meta), xb, yb)
        return torch.func.vmap(torch.func.grad_and_value(loss))(w, x, y)

    dense_g, dense_l = grads(cfg)
    plain_g, plain_l = grads(dataclass_replace(cfg, use_flash_attn=True))
    calls = _kernel_route_on_cpu(monkeypatch)
    kern_g, kern_l = grads(dataclass_replace(cfg, use_flash_attn=True))
    # forward once with the clients folded into the batch (K * 5 series)
    assert calls == [(K * 5, cfg.num_tokens, 2, 8)]
    np.testing.assert_allclose(kern_g.numpy(), plain_g.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(kern_l.numpy(), plain_l.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(kern_g.numpy(), dense_g.numpy(),
                               atol=FLASH_ATTN_TOL, rtol=FLASH_ATTN_TOL)
    np.testing.assert_allclose(kern_l.numpy(), dense_l.numpy(),
                               atol=FLASH_ATTN_TOL, rtol=FLASH_ATTN_TOL)


def dataclass_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)
