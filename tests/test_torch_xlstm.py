"""The port's ``ssm`` family (xlstm-125m: mLSTM and sLSTM cells blended by a
per-layer flag) against the JAX package on the CPU, at the reduced config
with 4 layers (so layer 3 is the sLSTM's) in float32 on the same numpy-made
params: each cell's apply and decode, the prefill's final states against
the reference's second scan, forward, prefill with decode, loss and every
gradient (the unused cell's exactly zero), and one bf16 sLSTM case."""
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
from repro.models.spec import spec_num_params as jax_num_params  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from torch_zoo_utils import (close, close_trees, f32_configs,  # noqa: E402
                             numpy_params, to_jax, to_torch)

# float32 on both sides (PERF.md §2): logits, states and gradients within
# 2e-5, losses within 1e-5. The recurrences run the same float32 steps in
# the same order; torch and XLA differ in matmul order and in logsigmoid's
# last ulp, ~1e-6 after 12 positions of 4 layers
PARITY_TOL = 2e-5
LOSS_TOL = 1e-5
# bf16 activations: the cells' float32 states against the reference's, and
# bf16 outputs, whose ulp is 2^-8 of their size
BF16_TOL = 2e-2
ARCH = "xlstm-125m"
LAYERS = 4                                  # flags 0, 0, 0, 1
T_CFG, J_CFG = f32_configs(ARCH, num_layers=LAYERS)
B, SEQ, DECODE = 2, 12, 3


@pytest.fixture(scope="module")
def params():
    return numpy_params(TD.model_spec(T_CFG), seed=0)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, T_CFG.vocab_size, (B, SEQ),
                                             dtype=np.int32)


def _x(seed, S_=SEQ):
    return np.random.default_rng(seed).standard_normal(
        (B, S_, T_CFG.d_model)).astype(np.float32)


def _layer(params, i):
    return jax.tree_util.tree_map(lambda a: a[i], params["blocks"])


def test_config_spec_and_flags_match_reference():
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    jshapes = jax.eval_shape(lambda: JD.init_params(J_CFG, jax.random.PRNGKey(0)))
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = pt.flatten_with_paths(TD.model_spec(T_CFG), is_leaf=S.is_spec)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(s.shape) for _, s in tl]
    n = S.spec_num_params(TD.model_spec(full))
    assert n == jax_num_params(JD.model_spec(jfull))
    print(f"{ARCH}: {n:,} params")
    assert TD._layer_flags(T_CFG) == [float(f) for f in JD._layer_flags(J_CFG)]
    assert TD._layer_flags(full) == [float(f) for f in JD._layer_flags(jfull)]
    # the mLSTM's head dim is d_inner / H, not cfg.head_dim
    assert TL.mlstm_state_shape(full, 4)["C"] == (4, 4, 384, 384)


def _mlstm_state(rng):
    H, _, dh = TL._mlstm_dims(T_CFG)
    return {"C": rng.standard_normal((B, H, dh, dh)).astype(np.float32),
            "n": rng.standard_normal((B, H, dh)).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32)}


def _slstm_state(rng):
    H = T_CFG.num_heads
    dh = T_CFG.d_model // H
    st = {k: rng.standard_normal((B, H, dh)).astype(np.float32)
          for k in ("c", "h", "m")}
    st["n"] = 1.0 + np.abs(rng.standard_normal((B, H, dh))).astype(np.float32)
    return st


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_apply_final_state_and_decode_match_jax(params, cell):
    """The cell over a sequence, its final state against the reference's
    second scan (``_mlstm_final_state`` / ``_slstm_final_state``), and one
    decode step from a random state."""
    p = _layer(params, 0)[cell]
    x = _x(2)
    jp, jx = to_jax(p), jnp.asarray(x)
    apply_t = TL.mlstm_apply if cell == "mlstm" else TL.slstm_apply
    apply_j = JL.mlstm_apply if cell == "mlstm" else JL.slstm_apply
    final_j = JD._mlstm_final_state if cell == "mlstm" else JD._slstm_final_state
    want = jax.jit(partial(apply_j, cfg=J_CFG))(jp, jx)
    want_state = jax.jit(partial(final_j, cfg=J_CFG))(jp, jx)
    got, state = apply_t(to_torch(p), torch.from_numpy(x), T_CFG, return_state=True)
    close(got.numpy(), want, PARITY_TOL)
    close_trees(state, want_state, PARITY_TOL)
    assert torch.equal(apply_t(to_torch(p), torch.from_numpy(x), T_CFG), got)

    rng = np.random.default_rng(3)
    st = _mlstm_state(rng) if cell == "mlstm" else _slstm_state(rng)
    x1 = _x(4, 1)
    dec_t = TL.mlstm_decode if cell == "mlstm" else TL.slstm_decode
    dec_j = JL.mlstm_decode if cell == "mlstm" else JL.slstm_decode
    want_out, want_new = jax.jit(partial(dec_j, cfg=J_CFG))(jp, jnp.asarray(x1),
                                                            to_jax(st))
    got_out, got_new = dec_t(to_torch(p), torch.from_numpy(x1), to_torch(st), T_CFG)
    close(got_out.numpy(), want_out, PARITY_TOL)
    close_trees(got_new, want_new, PARITY_TOL)


def test_forward_matches_jax(params, tokens):
    want, _ = jax.jit(partial(JD.forward, J_CFG))(to_jax(params), jnp.asarray(tokens))
    got, aux = TD.forward(T_CFG, to_torch(params), torch.from_numpy(tokens))
    assert float(aux) == 0.0
    close(got.numpy(), want, PARITY_TOL)


def test_prefill_states_and_decode_match_jax(params, tokens):
    """Prefill (its cache: every layer's final mLSTM and sLSTM state, which
    the reference gets from a second scan per cell), then greedy decode
    steps against ``JD.decode_step``."""
    jparams, tparams = to_jax(params), to_torch(params)
    jl, jcache = jax.jit(partial(JD.prefill, J_CFG, cache_len=SEQ + DECODE))(
        jparams, jnp.asarray(tokens))
    tl, tcache = TD.prefill(T_CFG, tparams, torch.from_numpy(tokens),
                            cache_len=SEQ + DECODE)
    close(tl.numpy(), jl, PARITY_TOL)
    close_trees(tcache, jcache, PARITY_TOL)
    empty = TD.init_cache(T_CFG, B, SEQ, device="cpu")
    close_trees(empty, JD.init_cache(J_CFG, B, SEQ), 0.0)

    step = jax.jit(partial(JD.decode_step, J_CFG))
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(DECODE):
        jl, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(SEQ + i))
        tl, tcache = TD.decode_step(T_CFG, tparams, tcache, torch.from_numpy(tok),
                                    SEQ + i)
        close(tl.numpy(), jl, PARITY_TOL, f"decode step {i}")
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    close_trees(tcache, jcache, PARITY_TOL)


def test_loss_and_grads_match_jax(params, tokens):
    """``loss_fn`` and every gradient. Both cells run in every layer and
    the flag keeps one, so the other cell's params get zero gradients,
    tensors and not ``None``: the sLSTM's in layers 0-2, the mLSTM's in 3."""
    labels = np.roll(tokens, -1, axis=1)
    batch = {"tokens": tokens, "labels": labels}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JD.loss_fn(J_CFG, p, b), has_aux=True))(
        to_jax(params), to_jax(batch))
    (tl, tm), tg = pt.value_and_grad(lambda p, b: TD.loss_fn(T_CFG, p, b),
                                     to_torch(params), pt.tree_map(torch.from_numpy, batch))
    close(float(tl), float(jl), LOSS_TOL)
    close(float(tm["ce"]), float(jm["ce"]), LOSS_TOL)
    close_trees(tg, jg, PARITY_TOL)
    flags = TD._layer_flags(T_CFG)
    for cell, off in (("slstm", 0.0), ("mlstm", 1.0)):
        for path, g in pt.flatten_with_paths(tg["blocks"][cell]):
            for i, f in enumerate(flags):
                unused = f == off
                assert bool(torch.count_nonzero(g[i]) == 0) == unused, (cell, path, i)
                if unused:
                    assert not np.asarray(jg["blocks"][cell][path][i]).any()
    assert all(g is not None for _, g in pt.flatten_with_paths(tg))


def test_slstm_bf16_promotes_to_float32(params):
    """bf16 activations with float32 weights: the gate products run in
    float32 (jnp promotes; the port casts the bf16 operand up), the c, n, m
    states stay float32, h and the output are bf16."""
    p = _layer(params, 3)["slstm"]
    x = _x(5).astype(jnp.bfloat16)
    cfg_j = dataclasses.replace(J_CFG, dtype="bfloat16")
    want = jax.jit(partial(JL.slstm_apply, cfg=cfg_j))(to_jax(p), jnp.asarray(x))
    want_state = jax.jit(partial(JD._slstm_final_state, cfg=cfg_j))(
        to_jax(p), jnp.asarray(x))
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got, state = TL.slstm_apply(to_torch(p), tx, T_CFG, return_state=True)
    assert got.dtype == torch.bfloat16 and state["h"].dtype == torch.bfloat16
    assert all(state[k].dtype == torch.float32 for k in ("c", "n", "m"))
    close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)
    close(state["h"].float().numpy(), np.asarray(want_state["h"], np.float32),
          BF16_TOL, "h")
    # c, n, m are float32 products of the same bf16 inputs: float32 parity
    for k in ("c", "n", "m"):
        assert str(want_state[k].dtype) == "float32"
        close(state[k].numpy(), want_state[k], PARITY_TOL, k)
    # gates formed in bf16 (the weights cast down) move the float32 states
    # by ~1e-3 to 1e-2: beyond PARITY_TOL, within BF16_TOL
    wrong = {k: v.to(torch.bfloat16) for k, v in to_torch(p).items()}
    _, bad = TL.slstm_apply(wrong, tx, T_CFG, return_state=True)
    assert float((bad["c"] - state["c"]).abs().max()) > 10 * PARITY_TOL
