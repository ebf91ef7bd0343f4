"""The port's ``moe`` family (phi3.5-moe with GQA attention, deepseek-v2 with
MLA) against the JAX package on the CPU, at the reduced configs in float32
(2 layers, d 256, 4 experts, top-2; deepseek: 1 shared expert, MLA with
kv_lora 64, q_lora 96, rope 32, nope / v 64) on the same numpy-made params.

The routing (top-k experts, each slot's position in its expert's queue, the
keep mask, the per-expert counts and the one-hot dispatch) is compared bit
for bit: it is integer arithmetic on the top-k order, which agrees as long
as no two router probabilities are within float rounding of each other on
the inputs here. The reference's routing intermediates are read from its
own ``moe_apply`` by recording what it passes to ``jnp.einsum``,
``jnp.take_along_axis`` and ``jax.lax.top_k`` during one eager call.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decoder as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.spec import spec_num_params as jax_num_params  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from torch_zoo_utils import (close, close_trees, f32_configs, layer0,  # noqa: E402
                             numpy_params, to_jax, to_torch)

# float32 on both sides: matmuls, the router's softmax and the expert
# einsums sum in other orders (XLA vs torch), ulps per op over 2 layers of
# width 256-1024 with O(1) activations; 2e-5 is ~100x the float32 epsilon
PARITY_TOL = 2e-5
# the Switch aux loss is a mean of products of probabilities (~1e-2): 1e-6
# absolute is ~100x their float32 rounding
AUX_TOL = 1e-6
# loss and gradients through 2 layers, as tests/test_torch_train.py's
TRAIN_PARITY_TOL = 1e-5
PROMPT, GEN = 48, 8

ARCHS = {"phi": "phi3.5-moe-42b-a6.6b", "deepseek": "deepseek-v2-236b"}
CFGS = {name: f32_configs(arch) for name, arch in ARCHS.items()}


@pytest.fixture(scope="module")
def params():
    return {name: numpy_params(TD.model_spec(t), seed=i)
            for i, (name, (t, _)) in enumerate(CFGS.items())}


class _Recorder:
    """Stands in for a module the reference's layers module imported: every
    attribute is the module's, except those in ``wrap`` (a function is
    wrapped to record ``(args, result)`` under its name; a ``_Recorder``
    stands in for a submodule)."""

    def __init__(self, mod, wrap, log):
        self._mod, self._wrap, self._log = mod, wrap, log

    def __getattr__(self, name):
        attr = getattr(self._mod, name)
        sub = self._wrap.get(name)
        if isinstance(sub, _Recorder):
            return sub
        if sub is None:
            return attr

        def record(*args, **kw):
            out = attr(*args, **kw)
            self._log.setdefault(name, []).append((args, out))
            return out
        return record


def _reference_route(monkeypatch, jcfg, p, x):
    """The reference's ``moe_apply`` on ``x``, eagerly, with its routing
    read from the calls it makes. Returns (y, aux, route)."""
    log = {}
    monkeypatch.setattr(JL, "jnp", _Recorder(
        jnp, {"einsum": True, "take_along_axis": True}, log))
    monkeypatch.setattr(JL, "jax", _Recorder(
        jax, {"lax": _Recorder(jax.lax, {"top_k": True}, log)}, log))
    y, aux = JL.moe_apply(to_jax(p), jnp.asarray(x), jcfg)
    monkeypatch.undo()
    einsums = {args[0]: args[1:] for args, _ in log["einsum"]}
    (_, (_, gate_idx)), = log["top_k"]
    positions = np.stack([np.asarray(out)[..., 0]
                          for _, out in log["take_along_axis"]], axis=-1)
    dispatch = np.asarray(einsums["gsd,gsec->gecd"][1])
    combine = np.asarray(einsums["gsec,gecd->gsd"][0])
    return y, aux, {"gate_idx": np.asarray(gate_idx), "positions": positions,
                    "dispatch": dispatch, "combine": combine,
                    "counts": dispatch.sum(axis=(1, 3)).astype(np.int32)}


def _port_route(monkeypatch, tcfg, p, x):
    """The port's ``moe_apply`` on ``x``, with the dict of the
    :func:`layers.moe_route` call it makes recorded. Returns (y, aux, route)."""
    log = []
    real = TL.moe_route

    def moe_route(*args, **kw):
        log.append(real(*args, **kw))
        return log[-1]
    monkeypatch.setattr(TL, "moe_route", moe_route)
    y, aux = TL.moe_apply(to_torch(p), torch.from_numpy(x), tcfg)
    monkeypatch.undo()
    (route,) = log
    return y, aux, route


ROUTE_CASES = {
    # name: (config, moe overrides, x shape)
    "phi_padded": ("phi", {}, (3, 100)),        # T = 300: 2 groups, 212 pad rows
    "deepseek_padded": ("deepseek", {}, (3, 100)),
    # the full configs' decode: T = B = 4 in one group, 16 experts, top-2,
    # capacity 1, so tokens sharing an expert are dropped (tokens 0 and 1
    # are equal here, so they share both experts)
    "decode_capacity_1": ("phi", {"num_experts": 16}, (4, 1)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_moe_apply_and_routing_match_jax(monkeypatch, case):
    name, moe_kw, (B, Sx) = ROUTE_CASES[case]
    tcfg, jcfg = CFGS[name]
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
    p = numpy_params(TL.moe_spec(tcfg), seed=3)
    x = np.random.default_rng(4).standard_normal(
        (B, Sx, tcfg.d_model)).astype(np.float32)
    if case == "decode_capacity_1":
        x[1] = x[0]
    want_y, want_aux, want = _reference_route(monkeypatch, jcfg, p, x)
    got_y, got_aux, got = _port_route(monkeypatch, tcfg, p, x)
    cap = TL.moe_capacity(tcfg, min(TL.MOE_GROUP_SIZE, B * Sx))
    assert got["dispatch"].shape[-1] == cap == want["dispatch"].shape[-1]
    for key in ("gate_idx", "positions", "counts", "dispatch"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    np.testing.assert_array_equal(got["keep"].numpy(), want["positions"] < cap)
    close(got["combine"].numpy(), want["combine"], PARITY_TOL, "combine")
    close(got_y.numpy(), want_y, PARITY_TOL, "y")
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
    keep = got["keep"].numpy()
    if case == "decode_capacity_1":
        assert cap == 1 and not keep[0, 1].any() and keep[0, 0].all()
    else:
        # the padding rows tie at 1/E: ties go to the lower index
        pad_idx = got["gate_idx"].reshape(-1, tcfg.moe.top_k)[B * Sx:]
        assert (pad_idx == torch.arange(tcfg.moe.top_k)).all()


def test_mla_attention_matches_jax(params):
    tcfg, jcfg = CFGS["deepseek"]
    p = layer0(params["deepseek"])["attn"]
    x = np.random.default_rng(5).standard_normal(
        (2, PROMPT, tcfg.d_model)).astype(np.float32)
    pos = np.arange(PROMPT, dtype=np.int32)
    want = jax.jit(partial(JL.mla_attention, cfg=jcfg))(
        to_jax(p), jnp.asarray(x), jnp.asarray(pos))
    got, c_kv, k_rope = TL.mla_attention(to_torch(p), torch.from_numpy(x),
                                         torch.from_numpy(pos), tcfg,
                                         return_latent=True)
    close(got.numpy(), want, PARITY_TOL)
    _, _, jc, jk = jax.jit(partial(JL._mla_qkv_latent, cfg=jcfg))(
        to_jax(p), jnp.asarray(x))
    close(c_kv.numpy(), jc, PARITY_TOL)
    close(k_rope.numpy(), JL.apply_rope(jk, jnp.asarray(pos), jcfg.rope_theta),
          PARITY_TOL)


@pytest.mark.parametrize("pos", [5, 40])
def test_mla_decode_attention_matches_jax(params, pos):
    """The absorbed decode on a cache whose slots hold positions 0 .. pos-1
    (the rest empty), updated in place at slot ``pos``."""
    tcfg, jcfg = CFGS["deepseek"]
    a = tcfg.mla
    p = layer0(params["deepseek"])["attn"]
    rng = np.random.default_rng(6)
    P = 48
    cache = {"c_kv": rng.standard_normal((2, P, a.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((2, P, a.rope_head_dim)).astype(np.float32),
             "slot_pos": np.where(np.arange(P) < pos, np.arange(P), -1).astype(np.int32)}
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    want, wcache = jax.jit(partial(JL.mla_decode_attention, cfg=jcfg))(
        to_jax(p), jnp.asarray(x), to_jax(cache), jnp.int32(pos))
    tcache = pt.tree_map(torch.from_numpy, cache)
    got, gcache = TL.mla_decode_attention(to_torch(p), torch.from_numpy(x),
                                          tcache, pos, tcfg)
    assert gcache["c_kv"] is tcache["c_kv"]              # in place
    close(got.numpy(), want, PARITY_TOL)
    close_trees(gcache, wcache, PARITY_TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_matches_reference(name):
    tcfg, jcfg = CFGS[name]
    jshapes = jax.eval_shape(lambda: JD.init_params(jcfg, jax.random.PRNGKey(0)))
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = pt.flatten_with_paths(TD.model_spec(tcfg), is_leaf=S.is_spec)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(s.shape) for _, s in tl]
    full = get_config(ARCHS[name])
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_config(ARCHS[name]))
    assert S.spec_num_params(TD.model_spec(full)) == jax_num_params(
        JD.model_spec(jax_get_config(ARCHS[name])))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_jax(params, name):
    tcfg, jcfg = CFGS[name]
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, PROMPT),
                                             dtype=np.int32)
    want, waux = jax.jit(partial(JD.forward, jcfg))(to_jax(params[name]),
                                                    jnp.asarray(toks))
    got, aux = TD.forward(tcfg, to_torch(params[name]), torch.from_numpy(toks))
    close(got.numpy(), want, PARITY_TOL)
    assert float(waux) > 0 and abs(float(aux) - float(waux)) <= 2 * AUX_TOL


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_match_jax(params, name):
    """Prefill of 48 tokens into a 56-slot cache, then 8 decode steps, each
    held against the reference's ``decode_step`` (a decode step routes its
    B tokens as one group, so it is not the full forward's routing)."""
    tcfg, jcfg = CFGS[name]
    jp, tp = to_jax(params[name]), to_torch(params[name])
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, PROMPT),
                                             dtype=np.int32)
    cache_len = PROMPT + GEN
    wl, wc = jax.jit(partial(JD.prefill, jcfg), static_argnames=("cache_len",))(
        jp, jnp.asarray(toks), cache_len=cache_len)
    gl, gc = TD.prefill(tcfg, tp, torch.from_numpy(toks), cache_len=cache_len)
    close(gl.numpy(), wl, PARITY_TOL, "prefill logits")
    close_trees(gc, wc, PARITY_TOL)
    assert sorted(gc) == (["mla"] if name == "deepseek" else ["kv"])
    assert gc[sorted(gc)[0]]["slot_pos"][0].tolist() == list(range(PROMPT)) + [-1] * GEN
    jstep = jax.jit(partial(JD.decode_step, jcfg))
    rng = np.random.default_rng(9)
    for i in range(GEN):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
        wl, wc = jstep(jp, wc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        gl, gc = TD.decode_step(tcfg, tp, gc, torch.from_numpy(tok), PROMPT + i)
        close(gl.numpy(), wl, PARITY_TOL, f"step {i}")
    close_trees(gc, wc, PARITY_TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_jax(params, name):
    """``loss_fn`` (ce + the aux loss summed over both layers) and every
    gradient, the router's included."""
    tcfg, jcfg = CFGS[name]
    toks = np.random.default_rng(10).integers(0, tcfg.vocab_size, (2, 33),
                                              dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JD.loss_fn(jcfg, p, to_jax(batch)), has_aux=True)(
        to_jax(params[name]))
    (tl, tm), tg = pt.value_and_grad(lambda p, b: TD.loss_fn(tcfg, p, b),
                                     to_torch(params[name]),
                                     pt.tree_map(torch.from_numpy, batch))
    close(float(tl), float(jl), TRAIN_PARITY_TOL, "loss")
    close(float(tm["aux"]), float(jm["aux"]), TRAIN_PARITY_TOL, "aux")
    assert float(tm["aux"]) > 0
    close_trees(tg, jg, TRAIN_PARITY_TOL)
