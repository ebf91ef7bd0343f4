"""The port's ``vlm`` family (internvl2-2b: the dense decoder over a patch
prefix) and the dense configs it gained (mistral-large-123b,
command-r-plus-104b, qwen2-72b) against the JAX package on the CPU, at the
reduced configs in float32 on the same numpy-made params; and the trainer's
``vlm`` batches."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import decoder as JD  # noqa: E402
from repro.models.spec import spec_num_params as jax_num_params  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from torch_zoo_utils import (close, close_trees, f32_configs,  # noqa: E402
                             numpy_params, to_jax, to_torch)

# float32 on both sides, as tests/test_torch_hybrid_decoder.py's: matmul
# orders differ between XLA and torch (ulps per op, 2 layers of width
# 256-1024); 2e-5 is ~100x the float32 epsilon at O(1) activations
PARITY_TOL = 2e-5
# loss and gradients through 2 layers, as tests/test_torch_train.py's
TRAIN_PARITY_TOL = 1e-5
# the patch embeddings from one key on each side: torch's erfinv against
# XLA's, as in tests/test_torch_random.py
INIT_RTOL, INIT_ATOL = 1e-5, 1e-7
PROMPT, GEN = 24, 6

VLM = "internvl2-2b"
T_VLM, J_VLM = f32_configs(VLM)
NPATCH = T_VLM.vlm.num_patches
DENSE = ("mistral-large-123b", "command-r-plus-104b", "qwen2-72b")


@pytest.fixture(scope="module")
def vlm_inputs():
    rng = np.random.default_rng(0)
    return {"params": numpy_params(TD.model_spec(T_VLM), seed=1),
            "tokens": rng.integers(0, T_VLM.vocab_size, (2, PROMPT), dtype=np.int32),
            "img": (0.1 * rng.standard_normal((2, NPATCH, T_VLM.d_model))
                    ).astype(np.float32)}


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_config_and_spec_match_reference(arch):
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    tcfg, jcfg = f32_configs(arch)
    jshapes = jax.eval_shape(lambda: JD.init_params(jcfg, jax.random.PRNGKey(0)))
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = pt.flatten_with_paths(TD.model_spec(tcfg), is_leaf=S.is_spec)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(s.shape) for _, s in tl]
    assert S.spec_num_params(TD.model_spec(full)) == jax_num_params(
        JD.model_spec(jfull))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_matches_jax(arch):
    tcfg, jcfg = f32_configs(arch)
    params = numpy_params(TD.model_spec(tcfg), seed=2)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 40),
                                             dtype=np.int32)
    want, _ = jax.jit(partial(JD.forward, jcfg))(to_jax(params), jnp.asarray(toks))
    got, aux = TD.forward(tcfg, to_torch(params), torch.from_numpy(toks))
    assert float(aux) == 0.0
    close(got.numpy(), want, PARITY_TOL)


def test_vlm_forward_matches_jax(vlm_inputs):
    p, toks, img = vlm_inputs["params"], vlm_inputs["tokens"], vlm_inputs["img"]
    want, _ = jax.jit(partial(JD.forward, J_VLM))(to_jax(p), jnp.asarray(toks),
                                                  jnp.asarray(img))
    got, _ = TD.forward(T_VLM, to_torch(p), torch.from_numpy(toks),
                        torch.from_numpy(img))
    assert got.shape == (2, NPATCH + PROMPT, T_VLM.vocab_size)
    close(got.numpy(), want, PARITY_TOL)
    with pytest.raises(ValueError, match="img_embeds"):
        TD.forward(T_VLM, to_torch(p), torch.from_numpy(toks))


def test_vlm_prefill_and_decode_match_jax(vlm_inputs):
    """The patch prefix and the prompt fill positions 0 .. P + prompt - 1 of
    the cache; decode continues from P + prompt."""
    p, toks, img = vlm_inputs["params"], vlm_inputs["tokens"], vlm_inputs["img"]
    jp, tp = to_jax(p), to_torch(p)
    start = NPATCH + PROMPT
    cache_len = start + GEN
    wl, wc = jax.jit(partial(JD.prefill, J_VLM), static_argnames=("cache_len",))(
        jp, jnp.asarray(toks), jnp.asarray(img), cache_len=cache_len)
    gl, gc = TD.prefill(T_VLM, tp, torch.from_numpy(toks), torch.from_numpy(img),
                        cache_len=cache_len)
    close(gl.numpy(), wl, PARITY_TOL, "prefill logits")
    close_trees(gc, wc, PARITY_TOL)
    assert gc["kv"]["slot_pos"][0].tolist() == list(range(start)) + [-1] * GEN
    jstep = jax.jit(partial(JD.decode_step, J_VLM))
    rng = np.random.default_rng(4)
    for i in range(GEN):
        tok = rng.integers(0, T_VLM.vocab_size, (2, 1), dtype=np.int32)
        wl, wc = jstep(jp, wc, jnp.asarray(tok), jnp.int32(start + i))
        gl, gc = TD.decode_step(T_VLM, tp, gc, torch.from_numpy(tok), start + i)
        close(gl.numpy(), wl, PARITY_TOL, f"step {i}")
    close_trees(gc, wc, PARITY_TOL)


def test_vlm_loss_and_grads_match_jax(vlm_inputs):
    """The image-prefix logits carry no loss: labels align to the text."""
    p, toks, img = vlm_inputs["params"], vlm_inputs["tokens"], vlm_inputs["img"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "img_embeds": img}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JD.loss_fn(J_VLM, p, to_jax(batch)), has_aux=True)(to_jax(p))
    (tl, tm), tg = pt.value_and_grad(lambda p, b: TD.loss_fn(T_VLM, p, b),
                                     to_torch(p), pt.tree_map(torch.from_numpy, batch))
    close(float(tl), float(jl), TRAIN_PARITY_TOL, "loss")
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    close_trees(tg, jg, TRAIN_PARITY_TOL)


def test_make_batch_vlm_matches_jax():
    for step in (0, 3):
        want = jax_train.make_batch(J_VLM, step, 2, 16)
        got = train_mod.make_batch(T_VLM, step, 2, 16, device="cpu")
        assert sorted(got) == sorted(want) == ["img_embeds", "labels", "tokens"]
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got["img_embeds"].dtype == torch.float32
        np.testing.assert_allclose(got["img_embeds"].numpy(),
                                   np.asarray(want["img_embeds"]),
                                   rtol=INIT_RTOL, atol=INIT_ATOL)
    # bf16: jax draws 8 random bits per value and rounds every op to bf16;
    # the port does the same, and erfinv's float32 ulps vanish in bf16
    got = train_mod.make_batch(get_config(VLM).reduced(), 0, 2, 4, device="cpu")
    want = jax_train.make_batch(jax_get_config(VLM).reduced(), 0, 2, 4)
    assert got["img_embeds"].dtype == torch.bfloat16
    assert got["img_embeds"].shape == (2, NPATCH, T_VLM.d_model)
    np.testing.assert_array_equal(got["img_embeds"].float().numpy(),
                                  np.asarray(want["img_embeds"], np.float32))


def test_train_vlm_on_the_cpu(monkeypatch):
    """Two Adam steps of reduced internvl2 through the trainer, in float32,
    against the reference's losses at its own ``PRNGKey(0)`` weights."""
    monkeypatch.setattr(train_mod, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), dtype="float32"))
    monkeypatch.setattr(jax_train, "get_config", lambda arch: dataclasses.replace(
        jax_get_config(arch), dtype="float32"))
    got = train_mod.train(VLM, steps=2, batch=1, seq=8, device="cpu")
    want = jax_train.train(VLM, steps=2, batch=1, seq=8)
    # weights from one key on each side (erfinv's last ulps), then the loss
    # through 2 layers: TRAIN_PARITY_TOL, as the first step's in
    # tests/test_torch_train.py
    np.testing.assert_allclose(got, want, rtol=TRAIN_PARITY_TOL,
                               atol=TRAIN_PARITY_TOL)
