"""Each cell's loop at a tiny size on the CPU, through the harness (the
chip checks of ``bench/run.py`` left out), the program's plain kernels in
place of the CUDA ones."""
import pytest

from bench import harness
from bench.tests.tiny import tiny_root, workloads


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", workloads())
def test_cell_runs_and_is_correct(root, name, trace):
    r = harness.run_cell(root, name, 2 ** 31 + 977, 0.2, bool(trace), "cpu")
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    for c in r["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    if trace:
        # device metrics are never read from a CPU run
        assert r["metrics"] == {}
    else:
        assert set(r["metrics"]) == {"setup_s", "train_windows_per_s"}
        assert r["metrics"]["train_windows_per_s"]["value"] > 0


def test_same_seed_same_inputs(root):
    from bench import datagen, weights

    a = datagen.ev_fleet(5, 8, 200, 32, 2, True)
    b = datagen.ev_fleet(5, 8, 200, 32, 2, True)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    c = datagen.ev_fleet(6, 8, 200, 32, 2, True)
    assert a[0].shape == c[0].shape and (a[0] != c[0]).any()
    m = {"look_back": 32, "horizon": 2, "patch_len": 16, "stride": 8,
         "d_model": 16, "num_heads": 4, "d_ff": 32, "mixers": ["id", "attn"],
         "revin": True}
    assert (weights.draw(m, 3, 1, "cpu")[0] == weights.draw(m, 3, 1, "cpu")[0]).all()
