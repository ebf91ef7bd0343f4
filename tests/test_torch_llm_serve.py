"""The port's LLM serving launcher (``repro_torch.launch.serve``) on the CPU
against the same loop composed of the JAX package's ``ModelApi`` calls:
every family at its reduced config in float32 (hymba, qwen2, internvl2 with
its patch prefix, phi3.5-moe and deepseek-v2 with MLA), weights from
``PRNGKey(0)`` on each side (equal up to ``erfinv``'s last ulps), greedy
decode. Plus the CLI."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.api import ModelApi as JaxModelApi  # noqa: E402
from repro.models import decoder as jax_decoder  # noqa: E402
from repro.models.spec import spec_num_params as jax_num_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import synthetic_tokens  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402

BATCH, PROMPT, GEN = 2, 48, 8     # prompt > window 32: the ring buffer wraps


def _float32_configs(monkeypatch):
    monkeypatch.setattr(serve_mod, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), dtype="float32"))


def _jax_serve_loop(cfg, batch, prompt_len, gen):
    """The reference's ``serve`` loop, unjitted steps made one jit each."""
    api = JaxModelApi(cfg)
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    toks = jnp.asarray(synthetic_tokens(0, batch, prompt_len, cfg.vocab_size))
    inputs, npatch = {"tokens": toks}, 0
    if cfg.family == "vlm":
        npatch = cfg.vlm.num_patches
        inputs["img_embeds"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(0), (batch, npatch, cfg.d_model), cfg.activation_dtype)
    if cfg.family == "audio":
        inputs["src_embeds"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(0), (batch, prompt_len, cfg.d_model),
            cfg.activation_dtype)
    start = prompt_len + npatch
    logits, cache = jax.jit(partial(api.prefill, cache_len=start + gen))(
        params, inputs)
    step = jax.jit(api.decode_step)
    out = []
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, jnp.int32(start + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-1.5b", "internvl2-2b",
                                  "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_serve_matches_jax_loop(monkeypatch, arch):
    _float32_configs(monkeypatch)
    rep = serve_mod.serve(arch, batch=BATCH, prompt_len=PROMPT,
                          gen=GEN, reduced=True, device="cpu")
    jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32").reduced()
    want = _jax_serve_loop(jcfg, BATCH, PROMPT, GEN)
    assert rep["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(rep["tokens"], want)
    assert rep["params"] == jax_num_params(jax_decoder.model_spec(jcfg))
    assert rep["prefill_ms"] > 0 and rep["decode_ms_per_token"] > 0


def test_cli_on_the_cpu(capsys):
    rep = serve_mod.main(["--arch", "hymba-1.5b", "--device", "cpu",
                          "--batch", "1", "--prompt-len", "8", "--gen", "3"])
    assert rep["tokens"].shape == (1, 3)
    assert "on cpu" in capsys.readouterr().out
    sampled = serve_mod.main(["--arch", "hymba-1.5b", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "5", "--gen", "2",
                              "--sample"])
    toks = sampled["tokens"]
    assert toks.shape == (2, 2) and 0 <= toks.min() and toks.max() < 512


def test_unported_archs_raise(monkeypatch):
    """Every arch serves: the last two families (xlstm-125m, the
    encoder-decoder seamless-m4t-large-v2) at their reduced configs in
    float32, 2 greedy tokens against the reference's loop; an unknown arch
    raises ``KeyError``."""
    _float32_configs(monkeypatch)
    for arch in ("xlstm-125m", "seamless-m4t-large-v2"):
        rep = serve_mod.serve(arch, batch=BATCH, prompt_len=8, gen=2,
                              reduced=True, device="cpu")
        jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32").reduced()
        np.testing.assert_array_equal(rep["tokens"], _jax_serve_loop(jcfg, BATCH, 8, 2))
        want_params = JaxModelApi(jcfg).mod.model_spec(jcfg)
        assert rep["params"] == jax_num_params(want_params)
    with pytest.raises(KeyError):
        serve_mod.serve("no-such-arch", device="cpu")
