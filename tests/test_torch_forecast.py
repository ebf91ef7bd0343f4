"""The port's forecaster against the JAX package's, on the CPU.

The JAX params are carried across (``params_from_numpy``), so both packages
run the same weights on the same numpy inputs; flash attention runs as the
JAX tests run it (interpret mode) and as the port's CPU path runs it (the
plain version). Tolerances: ``PORT_PARITY_TOL`` between the packages,
``FLASH_ATTN_TOL`` between the port's flash and dense routes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import forecast as JF  # noqa: E402
from repro_torch.core import forecast as TF  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core.forecaster import (Forecaster, get_forecaster,  # noqa: E402
                                         params_from_numpy, params_to_numpy)
from repro_torch.models.spec import is_spec  # noqa: E402

TOL = TF.PORT_PARITY_TOL
SMALL = dict(look_back=64, horizon=4, d_model=32, num_heads=4, d_ff=64,
             patch_len=8, stride=4)
PRESETS = ["logtst", "patchtst", "mlpformer", "idformer"]


def _cfgs(preset, flash, **kw):
    jc = getattr(JF, f"{preset}_config")(use_flash_attn=flash, **kw)
    tc = getattr(TF, f"{preset}_config")(use_flash_attn=flash, **kw)
    return jc, tc


def _numpy_params(tc, seed=0):
    """Params made by numpy from ``seed`` in the spec's scales (biases and
    norm scales perturbed too), as ``(jax_tree, torch_tree)``."""
    rng = np.random.default_rng(seed)

    def draw(s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "scaled":
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else s.shape[0]
            return z / np.float32(np.sqrt(fan_in))
        return (z * np.float32(0.02) + np.float32(s.init == "ones"))

    tree = pt.tree_map(draw, TF.model_spec(tc), is_leaf=is_spec)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def test_configs_and_param_keys_match_reference():
    for preset in PRESETS:
        jc, tc = _cfgs(preset, False, **SMALL)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.name == tc.name and jc.num_tokens == tc.num_tokens
        assert JF.num_params(jc) == TF.num_params(tc)
        jp = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda k: JF.init_params(jc, k), jax.random.PRNGKey(0)))[0]
        fc = Forecaster(tc)
        tp = fc.init_params(torch.Generator().manual_seed(0), device="cpu")
        tflat = pt.flatten_with_paths(tp)
        assert [("/".join(str(k.key) for k in p), tuple(l.shape), str(l.dtype))
                for p, l in jp] == \
            [(k, tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in tflat]
    # the full-width LoGTST of the serving path
    assert TF.num_params(TF.logtst_config()) == 273_284
    assert TF.FLASH_ATTN_TOL == JF.FLASH_ATTN_TOL


def test_init_params_is_seeded_by_the_generator():
    fc = get_forecaster("logtst", **SMALL)
    a = fc.init_params(torch.Generator().manual_seed(3), device="cpu")
    b = fc.init_params(torch.Generator().manual_seed(3), device="cpu")
    c = fc.init_params(torch.Generator().manual_seed(4), device="cpu")
    wa, wb, wc = (p["tokenize"]["w"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.equal(a["revin"]["affine_w"], torch.ones(1))
    # "scaled" init: 1/sqrt(fan_in) times a standard normal draw
    assert abs(float(wa.std()) - SMALL["patch_len"] ** -0.5) < 0.1


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(preset, flash):
    jc, tc = _cfgs(preset, flash, **SMALL)
    jp, tp = _numpy_params(tc, seed=1)
    xm = np.random.default_rng(1).standard_normal(
        (4, 2, SMALL["look_back"])).astype(np.float32)
    x = xm.reshape(8, SMALL["look_back"])
    # forward_multivariate is forward over (B*M, L): one JAX call checks both
    want_m = np.asarray(JF.forward_multivariate(jc, jp, jnp.asarray(xm)))
    got_m = TF.forward_multivariate(tc, tp, torch.from_numpy(xm))
    assert got_m.shape == (4, 2, SMALL["horizon"])
    _close(got_m.numpy(), want_m)
    got = TF.forward(tc, tp, torch.from_numpy(x))
    _close(got.numpy(), want_m.reshape(8, SMALL["horizon"]))
    if flash:  # the port's own flash vs dense contract
        dense = TF.forward(dataclasses.replace(tc, use_flash_attn=False), tp,
                           torch.from_numpy(x))
        assert float((got - dense).abs().max()) <= TF.FLASH_ATTN_TOL


def test_full_width_logtst_flash_matches_jax():
    """The serving path's model: LoGTST at the ev full geometry (look_back
    128, d_model 128, 16 heads of 8, 15 tokens) with flash attention on."""
    jc, tc = _cfgs("logtst", True, look_back=128, horizon=2)
    assert tc.num_tokens == 15 and tc.d_model // tc.num_heads == 8
    jp, tp = _numpy_params(tc, seed=2)
    x = np.random.default_rng(2).standard_normal((4, 3, 128)).astype(np.float32)
    want = jax.jit(JF.forward_multivariate, static_argnums=0)(
        jc, jp, jnp.asarray(x))
    got = TF.forward_multivariate(tc, tp, torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_mse_loss_grads_match_jax(flash):
    jc, tc = _cfgs("logtst", flash, **SMALL)
    jp, tp = _numpy_params(tc, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, SMALL["look_back"])).astype(np.float32)
    y = rng.standard_normal((8, SMALL["horizon"])).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JF.mse_loss(jc, p, jnp.asarray(x), jnp.asarray(y))))(jp)
    for t in jax.tree_util.tree_leaves(tp):
        t.requires_grad_()
    loss = TF.mse_loss(tc, tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), jl)
    tg = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_leaves(tg)):
        _close(got, want)


# Table I's PatchTST at look_back 512 / 336 (63 / 41 tokens, the short flash
# route's largest calls), narrow: 4 heads of 8
LONG = dict(horizon=96, d_model=32, num_heads=4, d_ff=64)


@pytest.mark.parametrize("look_back,tokens", [(512, 63), (336, 41)])
def test_patchtst_long_look_back_flash_matches_jax(look_back, tokens):
    """Forward, loss and grads with flash attention on, against JAX's
    (the Pallas kernel in interpret mode), within ``FLASH_ATTN_TOL``."""
    jc, tc = _cfgs("patchtst", True, look_back=look_back, **LONG)
    assert tc.num_tokens == tokens and tc.name == f"patchtst/{tokens}"
    jp, tp = _numpy_params(tc, seed=7)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, look_back)).astype(np.float32)
    y = rng.standard_normal((4, LONG["horizon"])).astype(np.float32)
    tol = TF.FLASH_ATTN_TOL
    jpred, (jl, jg) = jax.jit(lambda p: (
        JF.forward(jc, p, jnp.asarray(x)),
        jax.value_and_grad(lambda q: JF.mse_loss(jc, q, jnp.asarray(x),
                                                 jnp.asarray(y)))(p)))(jp)
    _close(TF.forward(tc, tp, torch.from_numpy(x)).detach().numpy(), jpred, tol=tol)
    for t in jax.tree_util.tree_leaves(tp):
        t.requires_grad_()
    loss = TF.mse_loss(tc, tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), jl, tol=tol)
    tg = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    for want, got in zip(jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(tg)):
        _close(got, want, tol=tol)


def test_table1_steps_match_jax():
    """Three steps of Table I's centralized training (Adam with
    ``one_cycle(1e-3, steps)``, batch 128 drawn by ``default_rng(0)`` over
    ``ett_like`` windows), LoGTST narrow with flash on (phase 18's path),
    against the same steps in JAX on its dense attention (its flash path
    equals that within ``FLASH_ATTN_TOL``, the test above holds it; in
    interpret mode it costs seconds a step here): the loss before each step
    and after the last within ``PORT_PARITY_TOL + FLASH_ATTN_TOL``; every
    param whose reference gradient is not zero up to rounding within
    ``PORT_PARITY_TOL`` (below)."""
    from repro.data.synthetic import ett_like as jax_ett_like
    from repro.optim import Adam as JAdam, one_cycle as jone_cycle
    from repro_torch.data.synthetic import ett_like
    from repro_torch.data.windowing import table1_windows
    from repro_torch.optim import Adam, one_cycle

    steps = 3
    series = ett_like(seed=2)
    np.testing.assert_array_equal(series, jax_ett_like(seed=2))
    jc, _ = _cfgs("logtst", False, look_back=128, **LONG)
    _, tc = _cfgs("logtst", True, look_back=128, **LONG)
    x, y = table1_windows(series, tc.look_back, tc.horizon)
    jp, tp = _numpy_params(tc, seed=8)
    jopt, topt = JAdam(lr=jone_cycle(1e-3, steps)), Adam(lr=one_cycle(1e-3, steps))
    js, ts = jopt.init(jp), topt.init(tp)

    @jax.jit
    def jstep(p, s, xb, yb):
        loss, g = jax.value_and_grad(lambda q: JF.mse_loss(jc, q, xb, yb))(p)
        new_p, new_s = jopt.update(p, g, s)
        return new_p, new_s, loss, g

    rng = np.random.default_rng(0)
    grad_max = {}                       # each leaf's largest |reference grad|
    for step in range(steps + 1):       # the last batch only reads the loss
        idx = rng.integers(0, x.shape[0], size=128)
        new_jp, new_js, jl, jg = jstep(jp, js, jnp.asarray(x[idx]), jnp.asarray(y[idx]))
        if step < steps:
            for path, g in pt.flatten_with_paths(
                    jax.tree_util.tree_map(np.asarray, jg)):
                grad_max[path] = max(grad_max.get(path, 0.0), float(np.abs(g).max()))
        (tl, _), tg = pt.value_and_grad(
            lambda q: (TF.mse_loss(tc, q, torch.from_numpy(x[idx]),
                                   torch.from_numpy(y[idx])), {}), tp)
        _close(tl.item(), jl, tol=TOL + TF.FLASH_ATTN_TOL)
        if step < steps:
            jp, js = new_jp, new_js
            tp, ts = topt.update(tp, tg, ts)
    # Adam steps each element by about lr * m / sqrt(v), lr up to 1e-3 here:
    # where the reference gradient is zero up to rounding (attn/bk's is zero
    # analytically: softmax ignores a bias shared by every key), both steps
    # are the sign of float noise and may differ by 2 lr, so such leaves are
    # left out; every other param is held at PORT_PARITY_TOL, a hundredth of lr
    top = max(grad_max.values())
    noise = {path for path, g in grad_max.items() if g <= 1e-6 * top}
    assert noise and all(path.endswith("attn/bk") for path in noise), noise
    want = dict(pt.flatten_with_paths(jax.tree_util.tree_map(np.asarray, jp)))
    for path, got in pt.flatten_with_paths(tp):
        if path not in noise:
            np.testing.assert_allclose(got.numpy(), want[path], rtol=TOL,
                                       atol=TOL, err_msg=path)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = TF.gelu(torch.from_numpy(x)).numpy()
    _close(got, jax.nn.gelu(jnp.asarray(x)), tol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(erf - got)) > 1e-4  # the trap is real at this range


def test_revin_and_layernorm_use_population_variance():
    x = np.random.default_rng(4).standard_normal((3, 16)).astype(np.float32)
    p = {"affine_w": np.ones(1, np.float32) * 1.5,
         "affine_b": np.ones(1, np.float32) * 0.25}
    jy, (jm, js) = JF.revin_norm(p, jnp.asarray(x))
    ty, (tm, ts) = TF.revin_norm({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x))
    _close(ts.numpy(), js, tol=1e-6)
    _close(ty.numpy(), jy)
    lp = {"scale": np.full(16, 0.5, np.float32), "bias": np.zeros(16, np.float32)}
    _close(TF._ln({k: torch.from_numpy(v) for k, v in lp.items()},
                  torch.from_numpy(x)).numpy(), JF._ln(lp, jnp.asarray(x)))


def test_revin_denorm_divides_by_eps_only_where_w_is_zero():
    y = np.random.default_rng(5).standard_normal((3, 2)).astype(np.float32)
    mean = np.full((3, 1), 2.0, np.float32)
    std = np.full((3, 1), 3.0, np.float32)
    for w in (0.0, 1e-7, -0.5, 2.0):
        p = {"affine_w": np.full(1, w, np.float32),
             "affine_b": np.full(1, 0.1, np.float32)}
        want = JF.revin_denorm(p, jnp.asarray(y), (jnp.asarray(mean),
                                                   jnp.asarray(std)))
        got = TF.revin_denorm({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(y),
                              (torch.from_numpy(mean), torch.from_numpy(std)))
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy(), want, tol=1e-6)


def test_tokenize_unfold_matches_gather():
    cfg_j, cfg_t = _cfgs("logtst", False, look_back=60, patch_len=16, stride=8,
                         d_model=8, num_heads=2, d_ff=8)
    # (60 - 16) % 8 != 0: the last partial patch is dropped by both
    p = {"w": np.eye(16, 8, dtype=np.float32), "b": np.zeros(8, np.float32),
         "pos": np.zeros((cfg_t.num_tokens, 8), np.float32)}
    x = np.arange(2 * 60, dtype=np.float32).reshape(2, 60)
    want = JF.tokenize(p, jnp.asarray(x), cfg_j)
    got = TF.tokenize({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_numpy_round_trip_is_bitwise():
    jp, _ = _numpy_params(TF.logtst_config(**SMALL), seed=6)
    back = params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
