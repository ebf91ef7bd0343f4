"""N-round runs of the port's engine against the JAX package's
``repro.core.fl.engine.run_fl`` (one named driver per test: ``loop`` and
``scan``; ``while`` and ``host`` are in ``test_torch_fl_drivers.py``), the flat parameter vector and the comm accounting, on the CPU.

Bitwise: ``rounds_run``, the round indices of every history entry, the
cumulative comm and wire bytes. Within ``FL_PARITY_TOL``: losses, RMSE and
states (``attn/bk`` left out, see the constant's note).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fl import engine as JE  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from torch_fl_utils import (JCFG, TCFG, TOL, configs, make_data,  # noqa: E402
                            numpy_params, same_state)
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core.forecaster import load_forecaster  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_run_fl_matches_reference(driver, data, tmp_path):
    """Held against ``repro.core.fl.engine.run_fl(driver=...)``: fresh init
    from the key (the port's ``init_params_from_key``), patience stopping
    early, the fused downlink on."""
    tr, te = data[False]
    jfl, tfl = configs(tr.shape[0], policy="psgf", use_pallas_mix=True)
    kw = dict(max_rounds=7, patience=2, eval_every=2, driver=driver)
    jh = JE.run_fl(JCFG, jfl, jnp.asarray(tr), jnp.asarray(te),
                   jax.random.PRNGKey(1), **kw)
    th = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(1), device="cpu",
                   checkpoint_dir=str(tmp_path / "ckpt"), **kw)
    assert th["rounds_run"] == jh["rounds_run"] < 7    # patience fired
    assert th["round"] == jh["round"]
    assert th["comm"] == jh["comm"]
    assert th["final_comm"] == jh["final_comm"]
    assert th["final_comm_bytes"] == jh["final_comm_bytes"]
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=TOL, atol=TOL)
    assert [r for r, _ in th["rmse"]] == [r for r, _ in jh["rmse"]]
    np.testing.assert_allclose([v for _, v in th["rmse"]],
                               [v for _, v in jh["rmse"]], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(th["final_rmse"], jh["final_rmse"], rtol=TOL)
    same_state(jh["state"], th["state"], th["meta"])
    # the checkpoint restores the trained global model
    fc, params, extra = load_forecaster(str(tmp_path / "ckpt"), device="cpu")
    vec, _ = pt.tree_flatten_to_vector(params)
    assert torch.equal(vec, th["state"]["w_global"])
    assert extra["policy"] == "psgf" and fc.cfg == TCFG


def test_run_fl_refuses_what_is_not_ported(data):
    from repro_torch.launch.mesh import Mesh

    tr, te = data[False]
    _, tfl = configs(tr.shape[0])
    two_shards = Mesh("clients", (torch.device("cpu"), torch.device("cpu")))
    for kw, match in ((dict(driver="loop", client_mesh=two_shards),
                       "client_mesh"),
                      (dict(driver="bogus"), "unknown driver")):
        with pytest.raises(ValueError, match=match):
            TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(0), device="cpu", **kw)
    with pytest.raises(ValueError, match="streaming_windows"):
        TE.run_fl(TCFG, tfl, data[True][0], data[True][1], R.PRNGKey(0),
                  device="cpu")


def test_flat_vector_and_accounting_match_reference():
    """The flat ``(D,)`` vector (leaf order, ``meta.sizes``), ``count_params``,
    ``tree_lerp``, ``gate_count``/``gate_bytes``/``wire_scale_count`` and
    ``aggregate`` (with its no-client-selected branch) against the
    reference's, on the same numpy inputs."""
    from repro.common import pytree_utils as JPT

    jparams, tparams = numpy_params(seed=3)
    jvec, jmeta = JPT.tree_flatten_to_vector(jparams)
    tvec, tmeta = pt.tree_flatten_to_vector(tparams)
    assert tmeta.sizes == jmeta.sizes and tmeta.shapes == jmeta.shapes
    assert tmeta.total == jmeta.total == pt.count_params(tparams) == \
        JPT.count_params(jparams)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    back = pt.tree_unflatten_from_vector(tvec, tmeta)
    assert all(torch.equal(a, b) for a, b in zip(pt.leaves(back), pt.leaves(tparams)))
    rng = np.random.default_rng(4)
    gate = pt.tree_map(lambda t: torch.from_numpy(
        (rng.random(tuple(t.shape)) < 0.5).astype(np.float32)), tparams)
    jgate = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), gate)
    zero = pt.tree_map(torch.zeros_like, tparams)
    jzero = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    for a, b in zip(pt.leaves(pt.tree_lerp(tparams, zero, gate)),
                    jax.tree_util.tree_leaves(JPT.tree_lerp(jparams, jzero, jgate))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    K, D = 5, 300
    w = rng.standard_normal((K, D)).astype(np.float32)
    g = rng.standard_normal(D).astype(np.float32)
    up = (rng.random((K, D)) < 0.3).astype(np.float32)
    up[3] = 0.0                                   # a client that sends nothing
    tw, tg, tup = (torch.from_numpy(a) for a in (w, g, up))
    assert float(TE.gate_count(tup, tw)) == float(JE.gate_count(jnp.asarray(up), jnp.asarray(w)))
    assert float(TE.wire_scale_count(tup)) == float(JE.wire_scale_count(jnp.asarray(up))) == 4
    for bits in (None, 8, 16, 32):
        assert float(TE.gate_bytes(tup, tw, bits)) == \
            float(JE.gate_bytes(jnp.asarray(up), jnp.asarray(w), bits))
    for sel in (np.array([1, 0, 1, 1, 0], bool), np.zeros(K, bool)):
        got = TE.aggregate(tw, tg, tup * torch.from_numpy(sel)[:, None],
                           torch.from_numpy(sel))
        want = JE.aggregate(jnp.asarray(w), jnp.asarray(g),
                            jnp.asarray(up * sel[:, None]), jnp.asarray(sel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert torch.equal(got, tg)                   # nobody selected: kept as is
