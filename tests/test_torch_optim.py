"""The port's optimizers and LR schedules (``repro_torch.optim``) against
the JAX package's on the CPU: the same numpy params and gradients through
several steps of each, and the schedules at every step of a run.

``update`` (functional, as the reference's) is compared with JAX run op by
op; ``update_`` (in place, sliced, what the trainers call) must equal
``update`` bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.optim import adam as adam_mod  # noqa: E402

# Adam and SGD against the reference on identical gradients: the same float32
# operations in the same order, except the reductions (the global norm's
# per-leaf sums) and pow / sqrt, which torch and XLA may round an ulp apart;
# over 5 steps at lr 1e-2 the params (O(1)) agree to ~1e-7, and 1e-6
# relative + absolute leaves margin while a wrong bias correction, clip or
# decay term moves them by >= 1e-4
OPTIM_TOL = 1e-6
# bfloat16 moments: an ulp of float32 difference can round a moment to the
# neighbouring bf16 value (2^-8 relative), which Adam passes on to the step
BF16_MOMENT_TOL = 2.0 ** -8
# the schedules: float32 arithmetic on the step; cos may differ by an ulp
SCHEDULE_TOL = 1e-6
STEPS = 5


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((8, 16))).astype(np.float32),
            "b": {"w": (scale * rng.standard_normal((4, 4, 3))).astype(np.float32),
                  "v": (scale * rng.standard_normal((33,))).astype(np.float32)}}


def _grads(step):
    # large enough that the global-norm clip at 1.0 binds on some steps
    return _tree(100 + step, scale=0.3 if step % 2 else 0.05)


def _t(tree):
    return pt.tree_map(torch.from_numpy, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _close_trees(got, want, tol):
    for (path, g), w in zip(pt.flatten_with_paths(got),
                            jax.tree_util.tree_leaves(want)):
        _close(g.float().numpy(), np.asarray(w, np.float32), tol, path)


ADAMS = {
    "default": dict(),
    "no_clip": dict(grad_clip=None),
    "weight_decay": dict(weight_decay=0.1),
    "bf16_moments": dict(moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(ADAMS))
@pytest.mark.parametrize("schedule", ["constant", "one_cycle"])
def test_adam_matches_jax(name, schedule):
    kw = ADAMS[name]
    lrs = {"constant": (JO.schedules.constant(1e-2), TO.schedules.constant(1e-2)),
           "one_cycle": (JO.one_cycle(1e-2, STEPS), TO.one_cycle(1e-2, STEPS))}
    jlr, tlr = lrs[schedule]
    jopt, topt = JO.Adam(lr=jlr, **kw), TO.Adam(lr=tlr, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = _t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    tol = BF16_MOMENT_TOL if name == "bf16_moments" else OPTIM_TOL
    for step in range(STEPS):
        g = _grads(step)
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, _t(g), ts)
        _close_trees(tp, jp, tol)
        _close_trees(ts["m"], js["m"], tol)
        _close_trees(ts["v"], js["v"], tol)
        assert int(ts["t"]) == int(js["t"]) == step + 1
        assert ts["m"]["a"].dtype == getattr(torch, jopt.moment_dtype)


@pytest.mark.parametrize("name", sorted(ADAMS))
def test_adam_in_place_equals_functional(name, monkeypatch):
    monkeypatch.setattr(adam_mod, "SLICE", 50)      # several slices per leaf
    opt = TO.Adam(lr=TO.one_cycle(1e-2, STEPS), **ADAMS[name])
    p_fun = _t(_tree(0))
    p_in = _t(_tree(0))
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    for step in range(STEPS):
        g = _t(_grads(step))
        p_fun, s_fun = opt.update(p_fun, g, s_fun)
        p_ret, s_ret = opt.update_(p_in, g, s_in)
        assert p_ret is p_in and s_ret is s_in
        for a, b in zip(pt.leaves((p_fun, s_fun)), pt.leaves((p_in, s_in))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    jopt = JO.Sgd(lr=JO.one_cycle(0.05, STEPS), momentum=momentum)
    topt = TO.Sgd(lr=TO.one_cycle(0.05, STEPS), momentum=momentum)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(1))
    tp, tp_in = _t(_tree(1)), _t(_tree(1))
    js, ts, ts_in = jopt.init(jp), topt.init(tp), topt.init(tp_in)
    assert sorted(ts) == sorted(js)
    for step in range(STEPS):
        g = _grads(step)
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, _t(g), ts)
        topt.update_(tp_in, _t(g), ts_in)
        _close_trees(tp, jp, OPTIM_TOL)
        if momentum:
            _close_trees(ts["mu"], js["mu"], OPTIM_TOL)
        for a, b in zip(pt.leaves((tp, ts)), pt.leaves((tp_in, ts_in))):
            assert torch.equal(a, b)


def test_adam_converges_quadratic():
    """The reference's own check, run in the port."""
    opt = TO.Adam(lr=lambda t: 0.1)
    p = {"x": torch.tensor([5.0, -3.0])}
    s = opt.init(p)
    for _ in range(200):
        p, s = opt.update(p, {"x": 2 * p["x"]}, s)
    assert float(torch.abs(p["x"]).max()) < 0.1


SCHEDULES = {
    "constant": lambda m: m.schedules.constant(3e-4),
    "cosine": lambda m: m.cosine_decay(3e-4, 100, warmup=10),
    "cosine_floor": lambda m: m.cosine_decay(1.0, 37, warmup=0, floor=0.1),
    "one_cycle": lambda m: m.one_cycle(3e-4, 100),
    "one_cycle_short": lambda m: m.one_cycle(1e-2, 3, pct_start=0.5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    jf, tf = SCHEDULES[name](JO), SCHEDULES[name](TO)
    steps = np.arange(0, 130)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps, jnp.int32)), np.float32)
    got_tensor = tf(torch.from_numpy(steps.astype(np.int32))).numpy()
    got_int = np.array([float(tf(int(s))) for s in steps], np.float32)
    _close(got_tensor, want, SCHEDULE_TOL)
    np.testing.assert_array_equal(got_int, got_tensor)
    assert got_tensor.dtype == np.float32
