"""The port's encoder-decoder (``repro_torch.models.encdec``, the
seamless-m4t-large-v2 backbone) against the JAX package on the CPU, at the
reduced config (2 encoder + 2 decoder layers, d_model 256) in float32 on
the same numpy-made params: encode, forward, prefill with decode (the
cross K/V cache included), loss and every gradient, cross-attention under a
source mask; the trainer's and the server's bf16 source frames bit for bit;
and the params' round trip through numpy."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.spec import spec_num_params as jax_num_params  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from torch_zoo_utils import (close, close_trees, f32_configs,  # noqa: E402
                             numpy_params, to_jax, to_torch)

# float32 on both sides (PERF.md §2): logits, caches and gradients within
# 2e-5, losses within 1e-5 (matmul order, 4 layers of width 256-1024)
PARITY_TOL = 2e-5
LOSS_TOL = 1e-5
ARCH = "seamless-m4t-large-v2"
T_CFG, J_CFG = f32_configs(ARCH)
B, SRC, TGT, DECODE = 2, 10, 8, 3


@pytest.fixture(scope="module")
def params():
    return numpy_params(TE.model_spec(T_CFG), seed=0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return {"src": (0.1 * rng.standard_normal((B, SRC, T_CFG.d_model))
                    ).astype(np.float32),
            "tokens": rng.integers(0, T_CFG.vocab_size, (B, TGT), dtype=np.int32)}


def test_config_and_spec_match_reference():
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    jshapes = jax.eval_shape(lambda: JE.init_params(J_CFG, jax.random.PRNGKey(0)))
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = pt.flatten_with_paths(TE.model_spec(T_CFG), is_leaf=S.is_spec)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(s.shape) for _, s in tl]
    n = S.spec_num_params(TE.model_spec(full))
    assert n == jax_num_params(JE.model_spec(jfull))
    print(f"{ARCH}: {n:,} params")


def test_encode_and_forward_match_jax(params, inputs):
    jp, tp = to_jax(params), to_torch(params)
    src = torch.from_numpy(inputs["src"])
    want = jax.jit(partial(JE.encode, J_CFG))(jp, jnp.asarray(inputs["src"]))
    close(TE.encode(T_CFG, tp, src).numpy(), want, PARITY_TOL)
    want = jax.jit(partial(JE.forward, J_CFG))(jp, jnp.asarray(inputs["src"]),
                                               jnp.asarray(inputs["tokens"]))
    got = TE.forward(T_CFG, tp, src, torch.from_numpy(inputs["tokens"]))
    close(got.numpy(), want, PARITY_TOL)


def test_cross_attention_under_a_source_mask_matches_jax(params):
    p = jax.tree_util.tree_map(lambda a: a[0], params["dec_blocks"])["cross_attn"]
    rng = np.random.default_rng(2)
    KV, hd = T_CFG.num_kv_heads, T_CFG.resolved_head_dim
    x = rng.standard_normal((B, 3, T_CFG.d_model)).astype(np.float32)
    k = rng.standard_normal((B, SRC, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, SRC, KV, hd)).astype(np.float32)
    valid = np.arange(SRC)[None, :] < np.array([[SRC], [4]])
    want = jax.jit(partial(JL.cross_attention, cfg=J_CFG))(
        to_jax(p), jnp.asarray(x), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
    got = TL.cross_attention(to_torch(p), torch.from_numpy(x), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(valid), T_CFG)
    close(got.numpy(), want, PARITY_TOL)


def test_prefill_and_decode_match_jax(params, inputs):
    """Prefill (logits of the last position; the self K/V ring buffer and
    every layer's cross K/V), then greedy decode steps reading the frozen
    cross K/V, against ``JE.decode_step``."""
    jp, tp = to_jax(params), to_torch(params)
    jl, jcache = jax.jit(partial(JE.prefill, J_CFG, cache_len=TGT + DECODE))(
        jp, jnp.asarray(inputs["src"]), jnp.asarray(inputs["tokens"]))
    tl, tcache = TE.prefill(T_CFG, tp, torch.from_numpy(inputs["src"]),
                            torch.from_numpy(inputs["tokens"]),
                            cache_len=TGT + DECODE)
    assert tl.shape == (B, 1, T_CFG.vocab_size)
    close(tl.numpy(), jl, PARITY_TOL)
    close_trees(tcache, jcache, PARITY_TOL)
    empty = TE.init_cache(T_CFG, B, TGT, src_len=SRC, device="cpu")
    close_trees(empty, JE.init_cache(J_CFG, B, TGT, src_len=SRC), 0.0)

    step = jax.jit(partial(JE.decode_step, J_CFG))
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(DECODE):
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(TGT + i))
        tl, tcache = TE.decode_step(T_CFG, tp, tcache, torch.from_numpy(tok), TGT + i)
        close(tl.numpy(), jl, PARITY_TOL, f"decode step {i}")
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    close_trees(tcache, jcache, PARITY_TOL)


def test_loss_and_grads_match_jax(params, inputs):
    batch = {"src_embeds": inputs["src"], "tokens": inputs["tokens"],
             "labels": np.roll(inputs["tokens"], -1, axis=1)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JE.loss_fn(J_CFG, p, b), has_aux=True))(
        to_jax(params), to_jax(batch))
    (tl, tm), tg = pt.value_and_grad(lambda p, b: TE.loss_fn(T_CFG, p, b),
                                     to_torch(params),
                                     pt.tree_map(torch.from_numpy, batch))
    close(float(tl), float(jl), LOSS_TOL)
    close(float(tm["ce"]), float(jm["ce"]), LOSS_TOL)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    close_trees(tg, jg, PARITY_TOL)


def test_source_frames_bitwise_in_bf16(monkeypatch):
    """``make_batch``'s ``src_embeds`` and ``serve``'s stub at the config's
    own bf16 activations: jax draws 8 random bits a value and rounds every
    op to bf16, and so does the port (float32 draws differ in erfinv's last
    ulps, see ``random.normal``)."""
    tcfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    for step in (0, 3):
        want = jax_train.make_batch(jcfg, step, 2, 6)
        got = train_mod.make_batch(tcfg, step, 2, 6, device="cpu")
        assert sorted(got) == sorted(want) == ["labels", "src_embeds", "tokens"]
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got["src_embeds"].dtype == torch.bfloat16
        assert got["src_embeds"].shape == (2, 6, tcfg.d_model)
        np.testing.assert_array_equal(got["src_embeds"].float().numpy(),
                                      np.asarray(want["src_embeds"], np.float32))
    # serve's stub, as its prefill receives it: the reference's draw from
    # PRNGKey(0) at (batch, prompt_len, d)
    seen = {}
    real = TE.prefill

    def prefill(cfg, params, src_embeds, tokens, **kw):
        seen["src"] = src_embeds
        return real(cfg, params, src_embeds, tokens, **kw)

    monkeypatch.setattr(TE, "prefill", prefill)
    serve_mod.serve(ARCH, batch=2, prompt_len=5, gen=1, device="cpu")
    want = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (2, 5, tcfg.d_model),
                                   jcfg.activation_dtype)
    assert seen["src"].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen["src"].float().numpy(),
                                  np.asarray(want, np.float32))


def test_params_numpy_round_trip(params):
    """``params_from_numpy`` / ``params_to_numpy`` take the encdec tree
    (``enc_blocks``, ``enc_norm``, ``embed``, ``dec_blocks``,
    ``final_norm``, ``head``) unchanged, in float32 and bf16, and JAX's own
    tree through numpy into the port."""
    from repro_torch.models import decoder as TD

    t = TD.params_from_numpy(params, "cpu")
    assert sorted(t) == ["dec_blocks", "embed", "enc_blocks", "enc_norm",
                         "final_norm", "head"]
    back = TD.params_to_numpy(t)
    for (path, a), (_, b) in zip(pt.flatten_with_paths(params),
                                 pt.flatten_with_paths(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    bf = pt.tree_map(lambda x: x.to(torch.bfloat16), t)
    again = TD.params_from_numpy(TD.params_to_numpy(bf), "cpu")
    for (path, a), (_, b) in zip(pt.flatten_with_paths(bf),
                                 pt.flatten_with_paths(again)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), path
    jt = to_jax(params)
    close_trees(TD.params_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu"),
                jt, 0.0)
