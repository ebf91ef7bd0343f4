"""The port's ``while`` and ``host`` drivers on the CPU: each against the JAX
package's driver of the same name, and against the port's own driver that
runs the same rounds (``while`` against ``scan``, ``host`` against
``loop``); the host driver's refusals; the deprecated shims.

Against the reference, bitwise: ``rounds_run``, the round indices of every
history entry, the cumulative comm and wire bytes; within ``FL_PARITY_TOL``:
losses, RMSE and states (``attn/bk`` left out, see the constant's note).
Against the port's own drivers every field is bitwise, states included,
except the host driver's RMSE, which streams the test set in client chunks.
The card's versions of these checks are in ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fl import client_store as JCS  # noqa: E402
from repro.core.fl import engine as JE  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.fl import client_store as TCS  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from torch_fl_utils import (JCFG, TCFG, TOL, configs, make_data,  # noqa: E402
                            numpy_params, same_state)


@pytest.fixture(scope="module")
def data():
    return make_data()


WHILE_CASES = {
    "patience_fires": (dict(policy="psgf", use_pallas_mix=True),
                       dict(max_rounds=7, patience=2, eval_every=2)),
    "ragged_last_chunk": (dict(policy="pso"),
                          dict(max_rounds=7, patience=50, eval_every=3)),
    "cohort_streaming": (dict(policy="psgf", participation=4,
                              streaming_windows=True),
                         dict(max_rounds=5, patience=50, eval_every=2)),
}
_PORT = {}


def port_run(case, data, driver):
    """The port's history for ``case`` under ``driver`` (cached per module)."""
    if (case, driver) not in _PORT:
        fl_kw, run_kw = WHILE_CASES[case]
        tr, te = data[fl_kw.get("streaming_windows", False)]
        _, tfl = configs(tr.shape[0], **fl_kw)
        _PORT[(case, driver)] = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(1),
                                          device="cpu", driver=driver, **run_kw)
    return _PORT[(case, driver)]


def assert_matches_reference(th, jh):
    assert th["rounds_run"] == jh["rounds_run"]
    assert th["round"] == jh["round"]
    assert th["comm"] == jh["comm"]
    assert th["final_comm"] == jh["final_comm"]
    assert th["final_comm_bytes"] == jh["final_comm_bytes"]
    assert [r for r, _ in th["rmse"]] == [r for r, _ in jh["rmse"]]
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose([v for _, v in th["rmse"]],
                               [v for _, v in jh["rmse"]], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(th["final_rmse"], jh["final_rmse"], rtol=TOL)
    same_state(jh["state"], th["state"], th["meta"])


@pytest.mark.parametrize("case", sorted(WHILE_CASES))
def test_while_driver_matches_reference(case, data):
    """Held against ``repro.core.fl.engine.run_fl(driver="while")``."""
    fl_kw, run_kw = WHILE_CASES[case]
    tr, te = data[fl_kw.get("streaming_windows", False)]
    jfl, _ = configs(tr.shape[0], **fl_kw)
    jh = JE.run_fl(JCFG, jfl, jnp.asarray(tr), jnp.asarray(te),
                   jax.random.PRNGKey(1), driver="while", **run_kw)
    th = port_run(case, data, "while")
    assert_matches_reference(th, jh)
    if case == "patience_fires":
        assert th["rounds_run"] < run_kw["max_rounds"]
    if case == "ragged_last_chunk":
        assert run_kw["max_rounds"] % run_kw["eval_every"] != 0
        assert th["rmse"][-1][0] == run_kw["max_rounds"] - 1


@pytest.mark.parametrize("case", sorted(WHILE_CASES))
def test_while_driver_equals_scan_driver(case, data):
    """The port's while and scan drivers run the same chunks: every history
    field and every state tensor bitwise. The while run replays each chunk
    length it needs, and at most one chunk past the stop."""
    wh, sh = port_run(case, data, "while"), port_run(case, data, "scan")
    for name in ("rounds_run", "round", "train_loss", "comm", "rmse",
                 "final_rmse", "final_comm", "final_comm_bytes",
                 "final_scale_bytes"):
        assert wh[name] == sh[name], name
    assert set(wh["state"]) == set(sh["state"])
    for name, t in sh["state"].items():
        assert torch.equal(wh["state"][name], t), name
    run = wh["while_run"]
    chunks_run = len(wh["rmse"])
    assert chunks_run <= sum(run["replays"].values()) <= chunks_run + 1
    assert run["captured"] == []                  # the CPU runs eagerly


HOST_CASES = {
    "cohort_chunked": dict(participation=4, client_chunk=2),
    "full_fleet_int8": dict(policy="online", comm_bits=8),
}


def host_inputs(data, case):
    tr, te = data[True]
    return tr, te, configs(tr.shape[0], streaming_windows=True,
                           **HOST_CASES[case])


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_driver_equals_loop_driver(case, data):
    """Same key, same rounds: states, comm and ``rounds_run`` bitwise."""
    tr, te, (_, tfl) = host_inputs(data, case)
    kw = dict(max_rounds=5, patience=2, eval_every=2)
    lh = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(2), device="cpu",
                   driver="loop", **kw)
    hh = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(2), device="cpu",
                   driver="host", **kw)
    for name in ("rounds_run", "round", "train_loss", "comm", "final_comm",
                 "final_comm_bytes", "final_scale_bytes"):
        assert hh[name] == lh[name], name
    assert [r for r, _ in hh["rmse"]] == [r for r, _ in lh["rmse"]]
    np.testing.assert_allclose([v for _, v in hh["rmse"]],
                               [v for _, v in lh["rmse"]], rtol=1e-6)
    # the store's set-up and each round are timed apart
    assert hh["client_store_setup_s"] > 0
    assert len(hh["round_s"]) == hh["rounds_run"]
    assert all(t > 0 for t in hh["round_s"])
    assert set(hh["state"]) == set(lh["state"])
    for name, t in lh["state"].items():
        assert torch.equal(hh["state"][name], t), name


def test_host_driver_matches_reference(data):
    """Held against ``repro.core.fl.client_store.run_fl_host`` (the JAX
    ``driver="host"``), with a sampled cohort and warm-started params."""
    tr, te = data[True]
    jfl, tfl = configs(tr.shape[0], streaming_windows=True, participation=4)
    jparams, tparams = numpy_params(seed=5)
    kw = dict(max_rounds=5, patience=2, eval_every=2)
    jh = JE.run_fl(JCFG, jfl, tr, te, jax.random.PRNGKey(4), driver="host",
                   init_params=jparams, **kw)
    th = TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(4), device="cpu",
                   driver="host", init_params=tparams, **kw)
    assert isinstance(jh["client_store"], JCS.ClientStore)
    assert_matches_reference(th, jh)
    js, ts = jh["client_store"], th["client_store"]
    assert (ts.state_nbytes, ts.series_nbytes, ts.nbytes) == \
        (js.state_nbytes, js.series_nbytes, js.nbytes)
    np.testing.assert_allclose(ts.evaluate_rmse(th["state"]["w_global"]),
                               js.evaluate_rmse(jh["state"]["w_global"]),
                               rtol=TOL)


def test_host_driver_refusals_and_residency(data):
    """It needs ``streaming_windows``, holds the multi-process partition
    mode to its alignment conditions, and keeps its client-axis state on the
    host."""
    tr, te = data[True]
    _, tfl = configs(tr.shape[0])
    with pytest.raises(ValueError, match="streaming_windows"):
        TE.run_fl(TCFG, tfl, tr, te, R.PRNGKey(0), device="cpu",
                  driver="host")
    _, sfl = configs(tr.shape[0], streaming_windows=True, participation=3)
    with pytest.raises(ValueError, match="participation=3"):
        TCS.run_fl_host(TCFG, sfl, tr, te, R.PRNGKey(0), device="cpu",
                        partition=(0, 2))
    half = TCS.ClientStore(TCFG, sfl, tr, te, R.PRNGKey(0), device="cpu",
                           partition=(1, 2))
    assert (half.lo, half.hi) == (3, 6) and half.w_clients.shape[0] == 3
    assert torch.equal(half.train, torch.from_numpy(tr[3:]))
    with pytest.raises(ValueError, match="clients"):
        TCS.ClientStore(TCFG, sfl, tr[:3], te, R.PRNGKey(0), device="cpu")
    h = TE.run_fl(TCFG, sfl, tr, te, R.PRNGKey(0), device="cpu",
                  driver="host", max_rounds=2, eval_every=2)
    store = h["client_store"]
    for name in TE._CLIENT_AXIS_KEYS:
        assert h["state"][name] is getattr(store, name)
        assert h["state"][name].device.type == "cpu"
    assert not store.pinned                       # pinned only for the card
    D = h["meta"].total
    assert store.state_nbytes == 6 * D * 4 * 3 + 6 * 4
    assert store.series_nbytes == tr.nbytes + te.nbytes
    # the cohort's rows come back from gather as they are in the store
    cohort = torch.tensor([4, 0, 2])
    sub = store.gather(cohort)
    assert torch.equal(sub["w_clients"], store.w_clients[cohort])
    assert torch.equal(store.gather_train(cohort),
                       torch.from_numpy(tr[[4, 0, 2]]))


def test_deprecated_shims_reexport_the_engine(data):
    """``core.fl.simulator`` and ``core.fl.strategies`` keep the reference's
    legacy names; ``strategies.fl_round`` is the engine's round and
    ``_local_update`` one client's LocalUpdate, held against the
    reference's."""
    from repro.core.fl import strategies as JS
    from repro_torch.core import fl
    from repro_torch.core.fl import masks, simulator, strategies

    assert simulator.run_fl is TE.run_fl
    assert simulator.evaluate_rmse is TE.evaluate_rmse
    assert strategies.FLConfig is TE.FLConfig
    assert strategies.ACCOUNTING_DTYPE is TE.ACCOUNTING_DTYPE
    assert strategies.init_fl_state is TE.init_fl_state
    assert strategies._local_update is TE._local_update
    assert strategies._topk_mask is masks.topk_mask
    assert fl.ClientStore is TCS.ClientStore and fl.run_fl_host is TCS.run_fl_host

    tr, _ = data[False]
    jfl, tfl = configs(tr.shape[0])
    jparams, tparams = numpy_params()
    tstate, meta = TE.init_fl_state(TCFG, tfl, R.PRNGKey(0),
                                    init_params=tparams, device="cpu")
    got, _ = strategies.fl_round(tstate, tr, R.PRNGKey(3), TCFG, tfl, meta,
                                 device="cpu")
    want, _ = TE.fl_round(tstate, tr, R.PRNGKey(3), TCFG, tfl, meta,
                          device="cpu")
    assert all(torch.equal(got[k], want[k]) for k in want)

    jstate, jmeta = JS.init_fl_state(JCFG, jfl, jax.random.PRNGKey(0),
                                     init_params=jparams)
    j = JS._local_update(JCFG, jfl, jmeta, jstate["w_global"],
                         jstate["adam_m"][0], jstate["adam_v"][0],
                         jstate["adam_t"][0], jnp.asarray(tr[1]),
                         jax.random.PRNGKey(7))
    t = strategies._local_update(TCFG, tfl, meta, tstate["w_global"],
                                 tstate["adam_m"][0], tstate["adam_v"][0],
                                 tstate["adam_t"][0], torch.from_numpy(tr[1]),
                                 R.PRNGKey(7))
    keep = TE.bk_free(meta).numpy()
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep],
                                   rtol=TOL, atol=TOL)
    assert int(t[3]) == int(j[3]) == tfl.local_steps
    np.testing.assert_allclose(float(t[4]), float(j[4]), rtol=TOL, atol=TOL)
