"""The port's public names against the JAX package's, on the CPU: each
package ``__init__`` (``core``, ``common``, ``data``) exports the names the
reference's exports, and each public name is held against its reference
counterpart on the same numpy inputs (the registries, ``all_configs``, the
tree helpers, ``attention_ref``, ``layer_norm``, the data and clustering
functions, the Forecaster and task presets)."""
import ast
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.common as jcommon  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro_torch.common as tcommon  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro.configs import all_configs as jax_all_configs  # noqa: E402
from repro.core import forecaster as JFC  # noqa: E402
from repro.core import tasks as JT  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.layers import layer_norm as jax_layer_norm  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.core import forecaster as TFC  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.core.forecast import PORT_PARITY_TOL as TOL  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.layers import layer_norm  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PACKAGES = {"core": (jcore, tcore), "common": (jcommon, tcommon),
            "data": (jdata, tdata)}


def _exports(package: str, root: str) -> set:
    """The names an ``__init__.py`` binds by import."""
    path = os.path.join(SRC, root, package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names
            if a.name != "annotations"}


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_package_exports_are_the_references(package):
    want = _exports(package, "repro")
    assert _exports(package, "repro_torch") == want
    ref, port = PACKAGES[package]
    for name in want:
        assert hasattr(port, name) and hasattr(ref, name), name


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": {"w": rng.standard_normal((5,)).astype(np.float32),
                  "v": rng.standard_normal((2, 2, 2)).astype(np.float32)}}


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _check_trees(got, want):
    jleaves = jax.tree_util.tree_leaves(want)
    tleaves = tcommon.pytree_utils.leaves(got)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def case_tree_helpers():
    a, b = _tree(0), _tree(1)
    ja, jb = _as(a, jnp.asarray), _as(b, jnp.asarray)
    ta, tb = _as(a, torch.from_numpy), _as(b, torch.from_numpy)
    _check_trees(tcommon.tree_zeros_like(ta), jcommon.tree_zeros_like(ja))
    _check_trees(tcommon.tree_add(ta, tb), jcommon.tree_add(ja, jb))
    _check_trees(tcommon.tree_scale(ta, 0.37), jcommon.tree_scale(ja, 0.37))
    assert tcommon.count_params(ta) == jcommon.count_params(ja) == 25
    assert tcommon.tree_size_bytes(ta) == jcommon.tree_size_bytes(ja)
    tv, tmeta = tcommon.tree_flatten_to_vector(ta)
    jv, jmeta = jcommon.tree_flatten_to_vector(ja)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tmeta.shapes == jmeta.shapes and tmeta.sizes == jmeta.sizes
    _check_trees(tcommon.tree_unflatten_from_vector(tv * 2, tmeta),
                 jcommon.tree_unflatten_from_vector(jv * 2, jmeta))


def case_hw():
    """Both modules hold one target's peaks for the roofline: the same
    quantities under the port's names, the H100's values in the port."""
    pairs = {"PEAK_FLOPS_BF16": "BF16_FLOP_PER_S", "HBM_BW": "HBM_BYTES_PER_S",
             "ICI_BW": "NVLINK_BYTES_PER_S", "VMEM_BYTES": "SMEM_BYTES_PER_BLOCK"}
    for ref_name, name in pairs.items():
        assert getattr(jcommon.hw, ref_name) > 0 and getattr(tcommon.hw, name) > 0
    assert tcommon.hw.BF16_FLOP_PER_S == 989e12
    assert tcommon.hw.HBM_BYTES_PER_S == 3.35e12


def case_attention_ref():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 9, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    for mask in (dict(causal=True), dict(causal=False),
                 dict(causal=True, window=3), dict(causal=False, window=2)):
        got = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), **mask)
        want = jax_attention_ref(*(jnp.asarray(t) for t in (q, k, v)), **mask)
        _close(got, want)


def case_layer_norm():
    rng = np.random.default_rng(3)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((4, 7, 16), (16,), (16,)))
    got = layer_norm(*(torch.from_numpy(t) for t in (x, scale, bias)))
    _close(got, jax_layer_norm(*(jnp.asarray(t) for t in (x, scale, bias))))
    got = layer_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    want = jax_layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                          jnp.asarray(bias))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), tol=0)


def case_all_configs():
    got, want = all_configs(), jax_all_configs()
    assert list(got) == list(want)
    for arch in want:
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(want[arch]), arch


def case_register_forecaster(monkeypatch):
    monkeypatch.setattr(JFC, "_REGISTRY", dict(JFC._REGISTRY))
    monkeypatch.setattr(TFC, "_REGISTRY", dict(TFC._REGISTRY))
    kw = dict(look_back=32, horizon=3, d_model=16, num_heads=2, d_ff=32)
    jcore.register_forecaster(
        "mixed", lambda **k: jcore.get_forecaster("logtst", **k).cfg.__class__(
            mixers=("mlp", "attn"), **k))
    tcore.register_forecaster(
        "mixed", lambda **k: tcore.get_forecaster("logtst", **k).cfg.__class__(
            mixers=("mlp", "attn"), **k))
    assert tcore.forecaster_names() == jcore.forecaster_names()
    assert "mixed" in tcore.forecaster_names()
    jf, tf = jcore.get_forecaster("mixed", **kw), tcore.get_forecaster("mixed", **kw)
    assert dataclasses.asdict(tf.cfg) == dataclasses.asdict(jf.cfg)
    assert tf.name == jf.name and tf.num_params() == jf.num_params()
    assert isinstance(tf, tcore.Forecaster)


def case_register_task(monkeypatch):
    monkeypatch.setattr(JT, "_TASKS", dict(JT._TASKS))
    monkeypatch.setattr(TT, "_TASKS", dict(TT._TASKS))
    geometry = dict(seed=7, num_days=90, look_back=16, horizon=3)
    for pkg in (jcore, tcore):
        pkg.register_task("fleet", pkg.ForecastTask("fleet", "nn5", num_clients=4,
                                                     **geometry),
                          pkg.ForecastTask("fleet", "nn5", num_clients=8, **geometry))
    assert tcore.task_names() == jcore.task_names()
    for quick in (True, False):
        jt, tt = jcore.get_task("fleet", quick=quick), tcore.get_task("fleet", quick=quick)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        np.testing.assert_array_equal(tt.series(), jt.series())
    jm = jcore.task_forecaster(jt, "patchtst")
    tm = tcore.task_forecaster(tt, "patchtst")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    spec = dict(grid=(("online", {}),), max_rounds=3)
    assert (dataclasses.asdict(tcore.ExperimentSpec(task=tt, model=tm, **spec))["grid"]
            == dataclasses.asdict(jcore.ExperimentSpec(task=jt, model=jm, **spec))["grid"])
    assert tcore.run_experiment is TT.run_experiment


def case_forecaster_checkpoint(tmp_path):
    """``save_forecaster`` of either package restores through the other's
    ``load_forecaster`` with the same params."""
    kw = dict(look_back=16, horizon=2, d_model=8, num_heads=2, d_ff=16,
              patch_len=8, stride=4)
    tf = tcore.get_forecaster("logtst", **kw)
    params = tf.init_params(torch.Generator().manual_seed(0), device="cpu")
    tcore.save_forecaster(str(tmp_path / "t"), tf, params)
    jf, jparams, _ = jcore.load_forecaster(str(tmp_path / "t"))
    assert dataclasses.asdict(jf.cfg) == dataclasses.asdict(tf.cfg)
    _check_trees(params, jparams)
    jcore.save_forecaster(str(tmp_path / "j"), jf, jparams)
    back, tparams, _ = tcore.load_forecaster(str(tmp_path / "j"), device="cpu")
    assert back.cfg == tf.cfg
    _check_trees(tparams, jparams)


def case_data():
    for name in ("ev_synthetic", "nn5_synthetic", "household_synthetic"):
        got = getattr(tdata, name)(seed=3, num_clients=3, num_days=60)
        np.testing.assert_array_equal(got, getattr(jdata, name)(
            seed=3, num_clients=3, num_days=60))
    for name in ("ett_like", "weather_like"):
        np.testing.assert_array_equal(getattr(tdata, name)(seed=2),
                                      getattr(jdata, name)(seed=2))
    series = tdata.ev_synthetic(seed=1, num_clients=4, num_days=80)
    for name in ("make_windows", "split_windows", "split_series",
                 "client_datasets", "client_series", "client_series_datasets",
                 "series_norm_stats", "window_split_counts"):
        assert getattr(tdata, name).__name__ == getattr(jdata, name).__name__
    for streaming in (False, True):
        build = "client_series_datasets" if streaming else "client_datasets"
        got = getattr(tdata, build)(series, 16, 2)
        want = getattr(jdata, build)(series, 16, 2)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
    weekly = series[:, :77].reshape(4, 11, 7).mean(axis=2)
    dist = tdata.dtw_distance_matrix(weekly, device="cpu")
    want = np.asarray(jdata.dtw_distance_matrix(weekly))
    np.testing.assert_allclose(np.asarray(dist), want, rtol=1e-5)
    got_labels, got_medoids = tdata.kmedoids(want, 2, seed=0)
    want_labels, want_medoids = jdata.kmedoids(want, 2, seed=0)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_medoids, want_medoids)


CASES = {"tree_helpers": case_tree_helpers, "hw": case_hw,
         "attention_ref": case_attention_ref, "layer_norm": case_layer_norm,
         "all_configs": case_all_configs,
         "register_forecaster": case_register_forecaster,
         "register_task": case_register_task,
         "forecaster_checkpoint": case_forecaster_checkpoint, "data": case_data}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_name_matches_reference(name, monkeypatch, tmp_path):
    case = CASES[name]
    args = {"monkeypatch": monkeypatch, "tmp_path": tmp_path}
    case(*(args[a] for a in case.__code__.co_varnames[:case.__code__.co_argcount]))
