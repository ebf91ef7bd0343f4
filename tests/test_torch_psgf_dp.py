"""PSGF-DP in the port (``repro_torch.core.psgf_dp``) against the JAX
package on the CPU, over the reduced qwen2 tree (2 layers, d_model 256, 14
leaves) stacked for 2 and 4 pods from the same numpy values, and the
reference's own checks of ``tests/test_psgf_dp.py`` run in the port.

Selection, leaf gates and wire bytes are integer and 0/1 math: bitwise. The
downlink lerp is elementwise: bitwise. The aggregate sums over pods; at 2
pods that sum has one order, at 4 it is held to ``AGG_TOL``. The
reference's ``test_local_train_step_has_no_collectives`` inspects XLA's
compiled HLO for cross-pod collectives: on one card the pods are a leading
axis and the local step is a loop over them, so it has no counterpart."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import psgf_dp as JP  # noqa: E402
from repro.core.fl import engine as JE  # noqa: E402
from repro.core.fl import masks as JM  # noqa: E402
from repro.core.fl import policies as JPOL  # noqa: E402
from repro.common.pytree_utils import tree_size_bytes as jax_tree_size_bytes  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import psgf_dp as P  # noqa: E402
from repro_torch.core.fl import engine as E  # noqa: E402
from repro_torch.core.fl import masks as M  # noqa: E402
from repro_torch.core.fl import policies as POL  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402

# the aggregate at 4 pods: a float32 sum of 4 terms of O(0.1-1) weights, in
# XLA's and torch's reduction orders (an ulp or two of 1 is ~2e-7)
AGG_TOL = 1e-6
# the local step against the reference's vmapped one (loss and Adam on the
# same data): float32 matmul sums in other orders, ~1e-7 at these sizes
STEP_TOL = 1e-5
CFG = get_config("qwen2-1.5b").reduced()


def qwen2_tree(seed=0):
    """The reduced qwen2 params from numpy, with the tied model's empty
    ``head`` subtree as the reference's tree has it."""
    rng = np.random.default_rng(seed)

    def make(s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if s.init in ("ones", "zeros"):
            return (1.0 if s.init == "ones" else 0.0) + 0.1 * noise
        return (S._scale(s) * noise).astype(np.float32)

    tree = pt.tree_map(make, TD.model_spec(CFG), is_leaf=S.is_spec)
    tree["head"] = {}
    return tree


def pods_of(tree, pods, seed=1):
    """A per-pod perturbation of each leaf: (pods, ...) numpy arrays."""
    rng = np.random.default_rng(seed)
    return pt.tree_map(lambda x: (x[None] + 0.05 * rng.standard_normal(
        (pods,) + x.shape)).astype(np.float32), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return pt.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tkey(jkey):
    return torch.from_numpy(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


def _leaves_equal(got, want, tol=0.0):
    jl = jax.tree_util.tree_leaves(want)
    tl = pt.flatten_with_paths(got)
    assert len(tl) == len(jl)
    for (path, g), w in zip(tl, jl):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        if tol:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_tree_order_is_jax_leaf_order():
    tree = qwen2_tree()
    paths = [p for p, _ in pt.flatten_with_paths(tree)]
    jpaths = ["/".join(str(k.key) for k in kp)
              for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == jpaths and len(paths) == 14
    assert pt.tree_size_bytes(_t(tree)) == jax_tree_size_bytes(_j(tree))


@pytest.mark.parametrize("pods", [2, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_sync_round_selection_and_gates_bitwise(pods, seed):
    """The engine's leaf-granularity selection and gates for one key."""
    glob = qwen2_tree()
    local = pods_of(glob, pods)
    jk = _jkey(seed)
    k_sel, k_share, k_fwd = jax.random.split(jk, 3)
    tk = R.split(_tkey(jk), 3)
    for a, b in zip(tk, (k_sel, k_share, k_fwd)):
        assert a.tolist() == np.asarray(jax.random.key_data(b)).tolist()
    jsel = JM.select_clients(k_sel, pods, 0.5)
    tsel = M.select_clients(tk[0], pods, 0.5)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jpol, tpol = JPOL.LeafPSGF(0.5, 0.3), POL.LeafPSGF(0.5, 0.3)
    jdown = jpol.downlink_gates((k_share, k_fwd), _j(glob), _j(local), jsel)
    tdown = tpol.downlink_gates((tk[1], tk[2]), _t(glob), _t(local), tsel)
    jup = jpol.uplink_gates(k_share, _j(glob), _j(local), jsel)
    tup = tpol.uplink_gates(tk[1], _t(glob), _t(local), tsel)
    _leaves_equal(tdown, jdown)
    _leaves_equal(tup, jup)
    for g in pt.leaves(tdown):
        assert g.shape[0] == pods and all(d == 1 for d in g.shape[1:])
    assert float(E.gate_bytes(tdown, _t(local))) == float(
        JE.gate_bytes(jdown, _j(local)))


@pytest.mark.parametrize("pods", [2, 4])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_psgf_sync_matches_jax(pods, seed):
    cfg = P.PSGFDPConfig(share_ratio=0.4, forward_ratio=0.3, select_ratio=0.5)
    glob = qwen2_tree()
    local = pods_of(glob, pods)
    jk = _jkey(seed)
    jl, jg, js = JP.psgf_sync(_j(local), _j(glob), jk, cfg, pods)
    tl, tg, ts = P.psgf_sync(_t(local), _t(glob), _tkey(jk), cfg, pods)
    assert float(ts["wire_bytes"]) == float(js["wire_bytes"])
    assert int(ts["num_selected"]) == int(js["num_selected"])
    agg_tol = 0.0 if pods == 2 else AGG_TOL
    _leaves_equal(tg, jg, agg_tol)
    if pods == 2:
        _leaves_equal(tl, jl)                 # the lerp of equal inputs
    else:
        _leaves_equal(tl, jl, agg_tol)
    # the pods diverge after a sync: every new local leaf is its own storage
    for leaf in pt.leaves(tl):
        assert leaf.stride(0) != 0


def test_psgf_sync_checks_num_pods():
    glob = qwen2_tree()
    with pytest.raises(ValueError, match="num_pods"):
        P.psgf_sync(_t(pods_of(glob, 2)), _t(glob), R.PRNGKey(0),
                    P.PSGFDPConfig(), 3)


@pytest.mark.parametrize("pods", [2, 4])
def test_psgf_sync_static_matches_jax(pods):
    glob = qwen2_tree()
    local = pods_of(glob, pods)
    share = P.sample_static_gates(np.random.default_rng(5), glob, 0.5)
    fwd = P.sample_static_gates(np.random.default_rng(6), glob, 0.5)
    assert share == JP.sample_static_gates(np.random.default_rng(5), glob, 0.5)
    assert fwd == JP.sample_static_gates(np.random.default_rng(6), glob, 0.5)
    flags = [leaf for leaf in pt.leaves(share)] + [leaf for leaf in pt.leaves(fwd)]
    assert any(flags) and not all(flags)       # every branch of dist is reached
    selected = tuple(i % 2 == 0 for i in range(pods))
    jl, jg, js = JP.psgf_sync_static(_j(local), _j(glob), share, fwd, selected)
    tl, tg, ts = P.psgf_sync_static(_t(local), _t(glob), share, fwd, selected)
    assert ts["wire_bytes"] == js["wire_bytes"]
    _leaves_equal(tg, jg, 0.0 if pods == 2 else AGG_TOL)
    _leaves_equal(tl, jl, 0.0 if pods == 2 else AGG_TOL)


@pytest.mark.parametrize("pods", [2, 4])
def test_full_sync_matches_jax(pods):
    local = pods_of(qwen2_tree(), pods)
    jl, jg, js = JP.full_sync(_j(local), pods)
    tl, tg, ts = P.full_sync(_t(local), pods)
    assert ts["wire_bytes"] == float(js["wire_bytes"])
    _leaves_equal(tg, jg, AGG_TOL)
    _leaves_equal(tl, jl, AGG_TOL)


def test_stack_for_pods_makes_real_copies():
    glob = _t(qwen2_tree())
    local = P.stack_for_pods(glob, 3)
    leaf = local["embed"]["embedding"]
    assert leaf.shape[0] == 3 and leaf.is_contiguous()
    leaf[0].add_(1.0)
    assert torch.equal(leaf[1], glob["embed"]["embedding"])


# --- the reference's checks (tests/test_psgf_dp.py), run in the port ---------


def _toy(key, scale=1.0):
    ks = R.split(key, 3)
    return {"a": scale * R.normal(ks[0], (32, 16)),
            "b": {"w": scale * R.normal(ks[1], (8, 8)),
                  "v": scale * R.normal(ks[2], (128,))}}


def test_full_sync_is_mean():
    g = _toy(R.PRNGKey(0))
    local = P.stack_for_pods(g, 4)
    local = pt.tree_map(
        lambda x: x * torch.arange(1, 5, dtype=x.dtype).reshape((4,) + (1,) * (x.dim() - 1)),
        local)
    new_local, new_global, stats = P.full_sync(local, 4)
    expect = pt.tree_map(lambda x: x * 2.5, g)
    for a, b in zip(pt.leaves(new_global), pt.leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert float(stats["wire_bytes"]) == 2 * 4 * pt.tree_size_bytes(new_global)


def test_psgf_sync_ratio1_selects_everything():
    cfg = P.PSGFDPConfig(share_ratio=1.0, forward_ratio=1.0, select_ratio=1.0)
    g = _toy(R.PRNGKey(1))
    local = P.stack_for_pods(g, 4)
    local = pt.tree_map(lambda x: x + R.normal(R.PRNGKey(9), x.shape), local)
    nl, ng, stats = P.psgf_sync(local, g, R.PRNGKey(2), cfg, 4)
    fl, fg, _ = P.full_sync(local, 4)
    for a, b in zip(pt.leaves(ng), pt.leaves(fg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    for a, b in zip(pt.leaves(nl), pt.leaves(fl)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_psgf_sync_ratio0_is_noop_for_unselected():
    cfg = P.PSGFDPConfig(share_ratio=0.0, forward_ratio=0.0, select_ratio=0.5)
    g = _toy(R.PRNGKey(3))
    local = pt.tree_map(lambda x: x + 1.0, P.stack_for_pods(g, 4))
    nl, ng, stats = P.psgf_sync(local, g, R.PRNGKey(4), cfg, 4)
    for a, b in zip(pt.leaves(ng), pt.leaves(g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(pt.leaves(nl), pt.leaves(local)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(stats["wire_bytes"]) == 0.0


def test_psgf_wire_bytes_scale_with_ratio():
    g = _toy(R.PRNGKey(5))
    local = P.stack_for_pods(g, 8)
    outs = {}
    for r in (0.2, 0.8):
        cfg = P.PSGFDPConfig(share_ratio=r, forward_ratio=r / 2, select_ratio=0.5)
        tot = sum(float(P.psgf_sync(local, g, R.PRNGKey(s), cfg, 8)[2]["wire_bytes"])
                  for s in range(20))
        outs[r] = tot / 20
    full = 2 * 8 * pt.tree_size_bytes(g)
    assert outs[0.2] < outs[0.8] < full


def _linear_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def test_local_train_step_matches_jax_vmap():
    """Two steps of the per-pod loop against the reference's vmapped step on
    the same data: each pod's loss, params and Adam state."""
    def jloss(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2), {}

    n_pods = 4
    rng = np.random.default_rng(0)
    w0 = {"w": rng.standard_normal((3, 1)).astype(np.float32)}
    batches = [{"x": rng.standard_normal((n_pods, 8, 3)).astype(np.float32),
                "y": rng.standard_normal((n_pods, 8, 1)).astype(np.float32)}
               for _ in range(2)]
    jopt, topt = JO.Adam(lr=lambda t: 1e-2), TO.Adam(lr=lambda t: 1e-2)
    jstep = JP.make_local_train_step(jloss, jopt)
    tstep = P.make_local_train_step(_linear_loss, topt)
    jp = JP.stack_for_pods(_j(w0), n_pods)
    jo = jax.vmap(jopt.init)(jp)
    tp = P.stack_for_pods(_t(w0), n_pods)
    to = P.init_pod_opt_state(topt, tp)
    for b in batches:
        jp, jo, jl = jstep(jp, jo, _j(b))
        tp_out, to_out, tl = tstep(tp, to, _t(b))
        assert tp_out is tp and to_out is to           # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    _leaves_equal(tp, jp, STEP_TOL)
    _leaves_equal({"m": to["m"], "v": to["v"]}, {"m": jo["m"], "v": jo["v"]},
                  STEP_TOL)
    np.testing.assert_array_equal(to["t"].numpy(), np.asarray(jo["t"]))


def test_psgf_dp_converges_and_mixes():
    """4 pods with different data; PSGF sync pulls the pod models together."""
    key = R.PRNGKey(0)
    n_pods = 4
    w_true = torch.tensor([[1.0], [-2.0], [0.5]])
    params = {"w": torch.zeros((3, 1))}
    local = P.stack_for_pods(params, n_pods)
    opt = TO.Adam(lr=lambda t: 5e-2)
    opt_state = P.init_pod_opt_state(opt, local)
    step = P.make_local_train_step(_linear_loss, opt)
    g = params
    cfg = P.PSGFDPConfig(share_ratio=0.6, forward_ratio=0.4, select_ratio=0.5,
                         sync_interval=4)
    for r in range(25):
        for h in range(cfg.sync_interval):
            key, k1 = R.split(key)
            x = R.normal(k1, (n_pods, 16, 3))
            y = torch.einsum("pbi,ij->pbj", x, w_true)
            local, opt_state, loss = step(local, opt_state, {"x": x, "y": y})
        key, k2 = R.split(key)
        local, g, _ = P.psgf_sync(local, g, k2, cfg, n_pods)
    assert float(loss.mean()) < 0.1
    assert float(torch.mean(torch.abs(g["w"] - w_true))) < 0.3
