"""The port's long-sequence attention (``layers.chunked_attend`` and
``layers.flash_mha`` with its flash backward) against the JAX package's on
the CPU: forward and gradients, GQA, ``hd_v != hd`` (MLA's 192 / 128 in
miniature), a sliding window, query and key lengths that are not whole
blocks (the padding), and the routes of ``self_attention`` and
``mla_attention`` past ``CHUNKED_ATTN_THRESHOLD``."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch_zoo_utils import (close, f32_configs, numpy_params, to_jax,  # noqa: E402
                             to_torch)

# float32 on both sides: the same online softmax over the same blocks, its
# einsums and exponentials rounded by XLA and torch in other orders (ulps
# per op); outputs are convex sums of O(1) values, so 2e-5 is ~100x their
# float32 rounding
FWD_TOL = 2e-5
# gradients sum ds * k and p * dout over every key block (and, for dk / dv,
# every query block), up to 2049 terms of O(1): 1e-4 leaves ~100x their
# float32 rounding, and a wrong mask or lse moves them by 1e-2 or more
GRAD_TOL = 1e-4

CASES = {
    # name: (B, Sq, Sk, H, KV, hd, hd_v, causal, window, block_q, block_k)
    "gqa_padded": (2, 100, 100, 4, 2, 16, 16, True, None, 32, 48),
    "hd_v_ne_hd": (1, 70, 70, 3, 3, 24, 16, True, None, 32, 32),
    "window": (1, 96, 96, 2, 1, 16, 16, True, 20, 32, 32),
    "cross_lengths": (2, 40, 90, 2, 2, 8, 12, False, None, 16, 32),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, hd, hd_v = CASES[case][:7]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd_v), (B, Sq, H, hd_v))]
    # queries after the keys, so a causal cross-length case sees every key
    q_pos = np.arange(Sk - Sq if Sk > Sq else 0, Sk if Sk > Sq else Sq,
                      dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    return arrs, q_pos, k_pos


def _mask_kw(case):
    causal, window, block_q, block_k = CASES[case][7:]
    return dict(causal=causal, window=window, block_q=block_q, block_k=block_k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attend_matches_jax(case):
    (q, k, v, _), qp, kp = _inputs(case)
    kw = _mask_kw(case)
    want = jax.jit(partial(JL.chunked_attend, **kw))(
        *map(jnp.asarray, (q, k, v, qp, kp)))
    got = TL.chunked_attend(*map(torch.from_numpy, (q, k, v, qp, kp)), **kw)
    assert got.shape == (q.shape[0], q.shape[1], q.shape[2], v.shape[3])
    close(got.numpy(), want, FWD_TOL)


@pytest.mark.parametrize("remat_inner", [True, False])
def test_chunked_attend_grads_match_jax(remat_inner):
    (q, k, v, dout), qp, kp = _inputs("gqa_padded", seed=1)
    kw = _mask_kw("gqa_padded")

    def jloss(q, k, v):
        o = JL.chunked_attend(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                              remat_inner=remat_inner, **kw)
        return jnp.sum(o * jnp.asarray(dout))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TL.chunked_attend(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                          remat_inner=remat_inner, **kw)
    torch.sum(o * torch.from_numpy(dout)).backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        close(g.numpy(), w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_mha_forward_and_grads_match_jax(case):
    (q, k, v, dout), qp, kp = _inputs(case, seed=2)
    kw = _mask_kw(case)
    args = (kw["causal"], kw["window"], kw["block_q"], kw["block_k"])
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, vjp = jax.vjp(lambda q, k, v: JL.flash_mha(
        q, k, v, jnp.asarray(qp), jnp.asarray(kp), *args), jq, jk, jv)
    wgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TL.flash_mha(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                       *args)
    close(got.detach().numpy(), want, FWD_TOL)
    got.backward(torch.from_numpy(dout))
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), wgrads):
        close(g.numpy(), w, GRAD_TOL, f"d{name}")
    # the flash backward against autograd through the chunked forward
    cq, ck, cv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TL.chunked_attend(cq, ck, cv, torch.from_numpy(qp), torch.from_numpy(kp),
                          remat_inner=False, **kw)
    o.backward(torch.from_numpy(dout))
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), (cq.grad, ck.grad, cv.grad)):
        close(g.numpy(), w.numpy(), GRAD_TOL, f"d{name} vs chunked autograd")


def test_flash_mha_under_inference_mode():
    (q, k, v, _), qp, kp = _inputs("window", seed=3)
    args = map(torch.from_numpy, (q, k, v, qp, kp))
    with torch.inference_mode():
        got = TL.flash_mha(*args, True, 20, 32, 32)
    want = TL.chunked_attend(*map(torch.from_numpy, (q, k, v, qp, kp)),
                             causal=True, window=20, block_q=32, block_k=32)
    assert torch.equal(got, want)


LONG = TL.CHUNKED_ATTN_THRESHOLD + 1       # 2049: one padded query block


@pytest.mark.parametrize("custom_vjp", [True, False])
def test_self_attention_auto_past_the_threshold(custom_vjp):
    """``attn_impl="auto"`` at 2,049 tokens on the CPU: the reference's
    long-sequence path (``flash_mha`` with ``attn_custom_vjp``, else
    ``chunked_attend``), against the reference's own ``"auto"``."""
    tcfg, jcfg = f32_configs("qwen2-1.5b", d_model=64, attn_custom_vjp=custom_vjp)
    p = numpy_params(TL.attention_spec(tcfg), seed=4)
    x = np.random.default_rng(5).standard_normal((1, LONG, 64)).astype(np.float32)
    pos = np.arange(LONG, dtype=np.int32)
    want = jax.jit(partial(JL.self_attention, cfg=jcfg, window=48))(
        to_jax(p), jnp.asarray(x), jnp.asarray(pos))
    got = TL.self_attention(to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(pos), tcfg, window=48)
    close(got.numpy(), want, FWD_TOL)
    chunked = TL.self_attention(to_torch(p), torch.from_numpy(x),
                                torch.from_numpy(pos), tcfg, window=48,
                                attn_impl="chunked")
    assert torch.equal(chunked, got)


def test_self_attention_chunked_at_a_short_length():
    tcfg, jcfg = f32_configs("qwen2-1.5b")
    p = numpy_params(TL.attention_spec(tcfg), seed=6)
    x = np.random.default_rng(7).standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = jax.jit(partial(JL.self_attention, cfg=jcfg, attn_impl="chunked"))(
        to_jax(p), jnp.asarray(x), jnp.asarray(pos))
    got = TL.self_attention(to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(pos), tcfg, attn_impl="chunked")
    close(got.numpy(), want, FWD_TOL)


def test_mla_attention_past_the_threshold():
    """deepseek-v2's MLA at 2,049 tokens: ``flash_mha`` with q/k head dim
    nope + rope = 96 and v head dim 64 (the full config's 192 / 128)."""
    tcfg, jcfg = f32_configs("deepseek-v2-236b", d_model=128)
    tcfg = dataclasses.replace(tcfg, num_heads=2, num_kv_heads=2)
    jcfg = dataclasses.replace(jcfg, num_heads=2, num_kv_heads=2)
    p = numpy_params(TL.mla_spec(tcfg), seed=8)
    x = np.random.default_rng(9).standard_normal((1, LONG, 128)).astype(np.float32)
    pos = np.arange(LONG, dtype=np.int32)
    want = jax.jit(partial(JL.mla_attention, cfg=jcfg))(
        to_jax(p), jnp.asarray(x), jnp.asarray(pos))
    got = TL.mla_attention(to_torch(p), torch.from_numpy(x),
                           torch.from_numpy(pos), tcfg)
    close(got.numpy(), want, FWD_TOL)
