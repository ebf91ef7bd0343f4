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


def test_run_experiment_matches_reference(tmp_path):
    """Held against ``repro.core.tasks.run_experiment`` (scan driver): the
    same DTW labels, rows and manifest clusters, two clusters of the quick
    ``ev`` task at a tiny width, fresh init from the per-cluster key."""
    jtask = JT.get_task("ev", quick=True, clusters=2, num_clients=12,
                        num_days=120, look_back=16, min_cluster_clients=2)
    ttask = TT.get_task("ev", quick=True, clusters=2, num_clients=12,
                        num_days=120, look_back=16, min_cluster_clients=2)
    jmodel = JT.task_forecaster(jtask, "logtst", **TINY)
    tmodel = get_forecaster("logtst", **TINY)
    common = dict(grid=(("psgf", {"use_pallas_mix": True}),), max_rounds=3,
                  eval_every=2, local_steps=2, batch_size=8, seed=5)
    jres = JT.run_experiment(JT.ExperimentSpec(task=jtask, model=jmodel, **common),
                             checkpoint_dir=str(tmp_path / "jax"))
    tres = TT.run_experiment(TT.ExperimentSpec(task=ttask, model=tmodel, **common),
                             checkpoint_dir=str(tmp_path / "torch"), device="cpu")
    assert tres["cluster_sizes"] == jres["cluster_sizes"]
    assert len(tres["rows"]) == len(jres["rows"]) == 2
    for t, j in zip(tres["rows"], jres["rows"]):
        for k in ("policy", "cluster", "clients", "rounds", "comm_params",
                  "comm_bytes"):
            assert t[k] == j[k], k
        np.testing.assert_allclose(t["rmse"], j["rmse"], rtol=TOL)
    _, jman = JT.read_routing_manifest(str(tmp_path / "jax"))
    _, tman = TT.read_routing_manifest(str(tmp_path / "torch"))
    for k in ("station_cluster", "policies", "clusters", "model", "task"):
        assert tman[k] == jman[k], k
