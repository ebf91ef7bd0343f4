"""The port's DTW clustering and ``run_experiment`` against the JAX
package's, on the CPU: equal cluster labels on the quick and full ``ev``
tasks (the full task's 58 stations fall into 21 / 27 / 10), DTW distances
within ``DTW_TOL``, and a small two-cluster ``run_experiment`` with equal
labels, rows and manifest clusters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tasks as JT  # noqa: E402
from repro.data import clustering as JC  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core.fl.engine import FL_PARITY_TOL as TOL  # noqa: E402
from repro_torch.core.forecaster import get_forecaster  # noqa: E402
from repro_torch.data import clustering as TC  # noqa: E402

TINY = dict(look_back=16, horizon=2, d_model=8, num_heads=2, d_ff=16,
            patch_len=8, stride=4)
# Distances: each DP cell is the reference's float32 c + min(...) (min is
# exact), so they differ only through the z-normalization (mean/std summed
# in other orders) and the reference's row-0 cumsum; seen: 1e-6 relative
# on distances ~30-60. 1e-5 relative keeps a margin.
DTW_TOL = 1e-5


def _weekly(series):
    K, T = series.shape
    wk = T // 7
    return series[:, : wk * 7].reshape(K, wk, 7).mean(axis=2)


@pytest.mark.parametrize("quick", [True, False])
def test_dtw_and_labels_match_reference(quick):
    task = TT.get_task("ev", quick=quick, clusters=3, num_days=420,
                       min_cluster_clients=4)
    series = task.series()
    weekly = _weekly(series)
    want = np.asarray(JC.dtw_distance_matrix(jnp.asarray(weekly)))
    got = TC.dtw_distance_matrix(weekly, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=DTW_TOL, atol=0)
    assert (np.diag(got) == 0).all() and (got == got.T).all()
    jl, jmed = JC.cluster_clients(series, 3)
    tl, tmed = TC.cluster_clients(series, 3, device="cpu")
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tmed, jmed)
    np.testing.assert_array_equal(task.cluster_labels(series, device="cpu"), jl)
    if not quick:   # the paper-sized task of the chip run
        assert np.bincount(tl).tolist() == [21, 27, 10]


def test_dtw_pairs_is_the_textbook_recursion():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3, 9)).astype(np.float32)
    got = TC.dtw_pairs(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for p in range(3):
        dp = np.full((10, 10), np.inf, np.float64)
        dp[0, 0] = 0
        for i in range(1, 10):
            for j in range(1, 10):
                dp[i, j] = abs(a[p, i - 1] - b[p, j - 1]) + min(
                    dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1])
        np.testing.assert_allclose(got[p], dp[9, 9], rtol=1e-6)


EXPERIMENTS = {
    # two DTW clusters of the quick ev task, one grid entry
    "clusters": (dict(clusters=2, num_clients=12),
                 dict(grid=(("psgf", {"use_pallas_mix": True}),), max_rounds=3,
                      eval_every=2)),
    # Tables II-III's grid ends: online and psgf_topk (the fused downlink on)
    # over the pooled fleet, patience firing (the loop driver tests it after
    # every round)
    "policy_grid": (dict(clusters=0, num_clients=6),
                    dict(grid=(("online", {"use_pallas_mix": True}),
                               ("psgf_topk", {"share_ratio": 0.3, "forward_ratio": 0.2,
                                              "use_pallas_mix": True})),
                         max_rounds=8, eval_every=4, patience=2, driver="loop")),
}
# psgf_topk's masks are the top k of |global - client|, a step function of
# float noise: from round 3 on, elements within ulps of the k-th largest
# difference swap between the packages (their matmuls sum in other orders)
# and the runs drift apart (RMSE 5.2e-5 relative after 4 rounds, seen), so
# its RMSE is held to 1e-3 relative, not FL_PARITY_TOL; its counts, which
# k fixes, stay exact. A round from the same state is bitwise
# (test_torch_masks.py).
TOPK_RMSE_RTOL = 1e-3


@pytest.mark.parametrize("case", sorted(EXPERIMENTS))
def test_run_experiment_matches_reference(case, tmp_path):
    """Held against ``repro.core.tasks.run_experiment`` (scan driver): the
    same DTW labels, rows and manifest clusters at a tiny width, fresh init
    from the per-cluster key."""
    task_kw, spec_kw = EXPERIMENTS[case]
    task_kw = dict(num_days=120, look_back=16, min_cluster_clients=2, **task_kw)
    jtask = JT.get_task("ev", quick=True, **task_kw)
    ttask = TT.get_task("ev", quick=True, **task_kw)
    jmodel = JT.task_forecaster(jtask, "logtst", **TINY)
    tmodel = get_forecaster("logtst", **TINY)
    common = dict(local_steps=2, batch_size=8, seed=5, **spec_kw)
    jres = JT.run_experiment(JT.ExperimentSpec(task=jtask, model=jmodel, **common),
                             checkpoint_dir=str(tmp_path / "jax"))
    tres = TT.run_experiment(TT.ExperimentSpec(task=ttask, model=tmodel, **common),
                             checkpoint_dir=str(tmp_path / "torch"), device="cpu")
    assert tres["cluster_sizes"] == jres["cluster_sizes"]
    assert len(tres["rows"]) == len(jres["rows"]) == 2
    if case == "policy_grid":
        assert [r["policy"] for r in tres["rows"]] == ["online", "psgf_topk-s30"]
        assert all(r["rounds"] < spec_kw["max_rounds"] for r in tres["rows"])
    for t, j in zip(tres["rows"], jres["rows"]):
        for k in ("policy", "cluster", "clients", "rounds", "comm_params",
                  "comm_bytes"):
            assert t[k] == j[k], k
        np.testing.assert_allclose(t["rmse"], j["rmse"], rtol=TOPK_RMSE_RTOL
                                   if t["policy"].startswith("psgf_topk") else TOL)
    _, jman = JT.read_routing_manifest(str(tmp_path / "jax"))
    _, tman = TT.read_routing_manifest(str(tmp_path / "torch"))
    for k in ("station_cluster", "policies", "clusters", "model", "task"):
        assert tman[k] == jman[k], k
