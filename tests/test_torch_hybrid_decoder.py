"""The port's hybrid decoder (hymba) against the JAX package on the CPU, at
the reduced config (2 layers, d 256, 4 heads / 1 kv head of 64, window 32,
d_inner 512, state 16), on the same numpy-made params and inputs.

Float32 runs compare the algorithm: the port's attention on the CPU is the
reference's dense ``gqa_attend`` and its SSM scan is the kernel's plain
version, which sums ``h*C`` in another order than the reference's einsum.
A bfloat16 prefill is compared at a looser tolerance (see ``BF16_TOL``).
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import decoder as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402

# float32 on both sides: matmuls and the SSM's dot with C sum in other
# orders (XLA vs torch), ulps per op over 2 layers of width 256-1024 with
# O(1) activations; 2e-5 is ~100x the float32 epsilon at these magnitudes
PARITY_TOL = 2e-5
# bfloat16 activations: the two packages round at other places (the port's
# scan forms dt*x in float32, the reference's in bf16; torch and XLA round
# matmul outputs and softmax inputs differently), each a bf16 ulp (2^-8
# relative) that two layers compound; logits are O(1)
BF16_TOL = 6e-2
# torch's erfinv against XLA's, as in test_torch_random
INIT_RTOL, INIT_ATOL = 1e-5, 1e-7

T_CFG = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="float32")
J_CFG = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(), dtype="float32")
PROMPT = 48            # > window 32: the prefill's ring buffer wraps
GEN = 8


def numpy_params(spec_tree, seed=0):
    """Params of the spec's shapes from numpy: scaled normals, and ones /
    zeros leaves perturbed (so the norm scales, biases and A_log matter)."""
    rng = np.random.default_rng(seed)

    def make(s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "ones":
            return 1.0 + 0.1 * noise
        if s.init == "zeros":
            return 0.1 * noise
        return (S._scale(s) * noise).astype(np.float32)

    return pt.tree_map(make, spec_tree, is_leaf=S.is_spec)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return TD.params_from_numpy(tree, "cpu")


def _close(got, want, tol=PARITY_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _close_trees(got, want, tol=PARITY_TOL):
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = pt.flatten_with_paths(got)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    for (_, w), (path, g) in zip(jl, tl):
        assert tuple(g.shape) == tuple(w.shape), path
        _close(g.float().numpy(), w, tol, path)


@pytest.fixture(scope="module")
def params():
    return numpy_params(TD.model_spec(T_CFG))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, T_CFG.vocab_size, (2, PROMPT),
                                             dtype=np.int32)


def _layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["blocks"])


def test_spec_matches_reference():
    jshapes = jax.eval_shape(lambda: JD.init_params(J_CFG, jax.random.PRNGKey(0)))
    tree = TD.model_spec(T_CFG)
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = pt.flatten_with_paths(tree, is_leaf=S.is_spec)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(s.shape) for _, s in tl]
    full = get_config("hymba-1.5b")
    assert S.spec_num_params(TD.model_spec(full)) == 1_662_161_600


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_ssm_apply_matches_jax(params, impl):
    p = _layer0(params)["ssm"]
    x = 0.5 * np.random.default_rng(2).standard_normal(
        (2, PROMPT, T_CFG.d_model)).astype(np.float32)
    want = jax.jit(partial(JL.ssm_apply, cfg=J_CFG, impl="xla"))(
        _jax(p), jnp.asarray(x))
    got = TL.ssm_apply(_torch(p), torch.from_numpy(x), T_CFG, impl=impl)
    _close(got.numpy(), want)


@pytest.mark.parametrize("attn_impl,qkv_bias", [("auto", False), ("full", False),
                                               ("pallas", False), ("auto", True)])
def test_self_attention_matches_jax(params, attn_impl, qkv_bias):
    tcfg = dataclasses.replace(T_CFG, qkv_bias=qkv_bias)
    jcfg = dataclasses.replace(J_CFG, qkv_bias=qkv_bias)
    p = (numpy_params(TL.attention_spec(tcfg), seed=8) if qkv_bias
         else _layer0(params)["attn"])
    x = np.random.default_rng(3).standard_normal(
        (2, PROMPT, T_CFG.d_model)).astype(np.float32)
    pos = np.arange(PROMPT, dtype=np.int32)
    want = jax.jit(partial(JL.self_attention, cfg=jcfg, attn_impl="full",
                           window=J_CFG.attention_window))(
        _jax(p), jnp.asarray(x), jnp.asarray(pos))
    got = TL.self_attention(_torch(p), torch.from_numpy(x),
                            torch.from_numpy(pos), tcfg,
                            window=T_CFG.attention_window, attn_impl=attn_impl)
    _close(got.numpy(), want)


def test_attention_impls_not_ported_raise(params):
    """Every attention impl and every family is ported: an unknown impl
    raises ``ValueError``, and so does the decoder for the encoder-decoder
    family (``models.encdec`` serves it)."""
    p = _torch(_layer0(params)["attn"])
    x = torch.zeros(1, 4, T_CFG.d_model)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="encdec"):
        TD._block_apply(dataclasses.replace(T_CFG, family="audio"),
                        _torch(_layer0(params)), x, pos, 0.0, "auto")
    with pytest.raises(ValueError, match="attn_impl"):
        TL.self_attention(p, x, pos, T_CFG, attn_impl="flash")
    with pytest.raises(ValueError, match="impl"):
        TL.ssm_apply(_torch(_layer0(params)["ssm"]), x, T_CFG, impl="cuda")


def _filled_layer_cache(seed, P, pos):
    """A layer cache whose slots hold positions pos-P+1 .. pos-1 (one slot
    still empty), ring-buffer placed."""
    rng = np.random.default_rng(seed)
    KV, hd = T_CFG.num_kv_heads, T_CFG.resolved_head_dim
    k = rng.standard_normal((2, P, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, P, KV, hd)).astype(np.float32)
    spos = np.full((P,), -1, np.int32)
    for q in range(max(0, pos - P + 1), pos):
        spos[q % P] = q
    return {"k": k, "v": v, "slot_pos": spos}


@pytest.mark.parametrize("pos", [5, 45])
def test_decode_attention_matches_jax(params, pos):
    p = _layer0(params)["attn"]
    P = T_CFG.attention_window
    cache = _filled_layer_cache(4, P, pos)
    x = np.random.default_rng(5).standard_normal(
        (2, 1, T_CFG.d_model)).astype(np.float32)
    want, wcache = jax.jit(partial(JL.decode_attention, cfg=J_CFG))(
        _jax(p), jnp.asarray(x), _jax(cache), jnp.int32(pos))
    tcache = pt.tree_map(torch.from_numpy, cache)
    got, gcache = TL.decode_attention(_torch(p), torch.from_numpy(x), tcache,
                                      pos, T_CFG)
    _close(got.numpy(), want)
    _close_trees(gcache, wcache)


def test_ssm_decode_matches_jax(params):
    p = _layer0(params)["ssm"]
    rng = np.random.default_rng(6)
    d_inner = T_CFG.ssm.expand * T_CFG.d_model
    state = {"h": rng.standard_normal((2, d_inner, T_CFG.ssm.state_dim)).astype(np.float32),
             "conv": rng.standard_normal((2, T_CFG.ssm.conv_kernel - 1, d_inner)).astype(np.float32)}
    x = rng.standard_normal((2, 1, T_CFG.d_model)).astype(np.float32)
    want, wstate = jax.jit(partial(JL.ssm_decode, cfg=J_CFG))(
        _jax(p), jnp.asarray(x), _jax(state))
    got, gstate = TL.ssm_decode(_torch(p), torch.from_numpy(x),
                                pt.tree_map(torch.from_numpy, state), T_CFG)
    _close(got.numpy(), want)
    _close_trees(gstate, wstate)


@pytest.mark.parametrize("tie", [False, True])
def test_forward_matches_jax(params, tokens, tie):
    tcfg = dataclasses.replace(T_CFG, tie_embeddings=tie)
    jcfg = dataclasses.replace(J_CFG, tie_embeddings=tie)
    if tie:
        params = numpy_params(TD.model_spec(tcfg), seed=9)
        assert params["head"] == {}
    want, _ = jax.jit(partial(JD.forward, jcfg))(_jax(params), jnp.asarray(tokens))
    got, aux = TD.forward(tcfg, _torch(params), torch.from_numpy(tokens))
    assert float(aux) == 0.0
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def jax_prefill():
    return jax.jit(partial(JD.prefill, J_CFG), static_argnames=("cache_len",))


@pytest.mark.parametrize("prompt", [20, PROMPT])
def test_prefill_logits_and_cache_match_jax(params, tokens, jax_prefill, prompt):
    """20 tokens with a 28-slot cache: identity layout plus padding; 48
    tokens: the last 32 positions, rolled by 48 % 32 (ring-buffer wrap)."""
    cache_len = prompt + GEN
    toks = tokens[:, :prompt]
    wl, wc = jax_prefill(_jax(params), jnp.asarray(toks), cache_len=cache_len)
    gl, gc = TD.prefill(T_CFG, _torch(params), torch.from_numpy(toks),
                        cache_len=cache_len)
    _close(gl.numpy(), wl)
    _close_trees(gc, wc)
    spos = gc["kv"]["slot_pos"][0].numpy()
    P = T_CFG.attention_window
    if prompt > P:
        assert [int(spos[p % P]) for p in range(prompt - P, prompt)] == \
            list(range(prompt - P, prompt))
        assert spos.tolist() != list(range(prompt - P, prompt))   # rolled
    else:
        assert spos.tolist() == list(range(prompt)) + [-1] * GEN


def test_decode_steps_match_jax(params, tokens, jax_prefill):
    jp, tp = _jax(params), _torch(params)
    cache_len = PROMPT + GEN
    wl, wc = jax_prefill(jp, jnp.asarray(tokens), cache_len=cache_len)
    gl, gc = TD.prefill(T_CFG, tp, torch.from_numpy(tokens), cache_len=cache_len)
    jstep = jax.jit(partial(JD.decode_step, J_CFG))
    rng = np.random.default_rng(7)
    for i in range(GEN):
        tok = rng.integers(0, T_CFG.vocab_size, (2, 1), dtype=np.int32)
        wl, wc = jstep(jp, wc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        gl, gc = TD.decode_step(T_CFG, tp, gc, torch.from_numpy(tok), PROMPT + i)
        _close(gl.numpy(), wl, msg=f"step {i}")
    _close_trees(gc, wc)


def test_bf16_prefill_matches_jax(params, tokens):
    jcfg = dataclasses.replace(J_CFG, dtype="bfloat16")
    tcfg = dataclasses.replace(T_CFG, dtype="bfloat16")
    wl, wc = jax.jit(partial(JD.prefill, jcfg), static_argnames=("cache_len",))(
        _jax(params), jnp.asarray(tokens), cache_len=PROMPT + GEN)
    gl, gc = TD.prefill(tcfg, _torch(params), torch.from_numpy(tokens),
                        cache_len=PROMPT + GEN)
    assert gl.dtype == torch.bfloat16 and gc["kv"]["k"].dtype == torch.bfloat16
    assert gc["ssm"]["h"].dtype == torch.float32
    _close(gl.float().numpy(), np.asarray(wl, np.float32), BF16_TOL)
    _close_trees(gc, wc, BF16_TOL)


def test_init_params_matches_jax():
    want = jax.jit(partial(JD.init_params, J_CFG))(jax.random.PRNGKey(0))
    got = TD.init_params(T_CFG, R.PRNGKey(0), device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = pt.flatten_with_paths(got)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    for (_, w), (path, g) in zip(jl, tl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=INIT_RTOL,
                                   atol=INIT_ATOL, err_msg=path)


@pytest.mark.parametrize("shape,range_size", [((3, 5, 7), 16), ((1000,), 999),
                                              ((4, 64), 64)])
def test_normal_in_ranges_is_the_whole_draw_bit_for_bit(shape, range_size):
    key = R.split(R.PRNGKey(11), 3)[2]
    whole = R.normal(key, shape)
    ranged = S.normal_in_ranges(key, shape, range_size)
    assert torch.equal(whole.view(torch.int32), ranged.view(torch.int32))
    np.testing.assert_allclose(
        ranged.numpy(),
        np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(11), 3)[2],
                                     shape)), rtol=INIT_RTOL, atol=INIT_ATOL)


def test_params_numpy_round_trip(params):
    t = TD.params_from_numpy(params, "cpu")
    back = TD.params_to_numpy(t)
    for (path, a), (_, b) in zip(pt.flatten_with_paths(params),
                                 pt.flatten_with_paths(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    bf = pt.tree_map(lambda x: x.to(torch.bfloat16), t)
    again = TD.params_from_numpy(TD.params_to_numpy(bf), "cpu")
    for (path, a), (_, b) in zip(pt.flatten_with_paths(bf),
                                 pt.flatten_with_paths(again)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), path
    # JAX's own tree through numpy, into the port and back out
    jt = _jax(params)
    from_jax = TD.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu")
    _close_trees(from_jax, jt, 0.0)


def test_registry_and_families():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jax_get_config(arch))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # the ssm family builds the reference's spec and cache
    ssm, jssm = get_config("xlstm-125m").reduced(), jax_get_config("xlstm-125m").reduced()
    tspec = pt.flatten_with_paths(TD.model_spec(ssm), is_leaf=S.is_spec)
    jspec = jax.tree_util.tree_flatten_with_path(
        JD.model_spec(jssm), is_leaf=lambda a: hasattr(a, "init"))[0]
    assert [(p, tuple(s.shape)) for p, s in tspec] == [
        ("/".join(str(k.key) for k in p), tuple(s.shape)) for p, s in jspec]
    cache = TD.init_cache(ssm, 1, 4, device="cpu")
    _close_trees(cache, JD.init_cache(jssm, 1, 4), 0.0)
    dense = get_config("qwen2-1.5b").reduced()
    assert sorted(TD.block_spec(dense)) == sorted(JD.block_spec(
        jax_get_config("qwen2-1.5b").reduced()))
