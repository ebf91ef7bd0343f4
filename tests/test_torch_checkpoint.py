"""Checkpoints, wire quantization, routing manifests and data: the port and
the JAX package read and write each other's files, bit for bit."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as JC  # noqa: E402
from repro.core import forecaster as JFC  # noqa: E402
from repro.core import tasks as JT  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro.data import windowing as JW  # noqa: E402
from repro_torch import checkpoint as TC  # noqa: E402
from repro_torch.core import forecaster as TFC  # noqa: E402
from repro_torch.core import tasks as TT  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402
from repro_torch.data import windowing as TW  # noqa: E402

SMALL = dict(look_back=32, horizon=2, d_model=16, num_heads=4, d_ff=32,
             patch_len=8, stride=4)


@pytest.fixture(scope="module")
def jax_model():
    fc = JFC.get_forecaster("logtst", use_flash_attn=True, **SMALL)
    return fc, jax.jit(fc.init_params)(jax.random.PRNGKey(0))


def _leaves_equal(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = jax.tree_util.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_jax_checkpoint_loads_into_port(jax_model, tmp_path):
    fc, params = jax_model
    d = str(tmp_path / "ck")
    JFC.save_forecaster(d, fc, params, step=7, extra={"note": "jax"})
    tfc, tparams, extra = TFC.load_forecaster(d, device="cpu")
    assert tfc.cfg.use_flash_attn is True
    assert json.dumps(vars(tfc.cfg), default=list) == \
        json.dumps(vars(fc.cfg), default=list)
    assert extra["note"] == "jax"
    _leaves_equal(params, tparams)


def test_port_checkpoint_loads_into_jax(jax_model, tmp_path):
    fc, params = jax_model
    tfc = TFC.get_forecaster("logtst", use_flash_attn=True, **SMALL)
    tparams = TFC.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                    device="cpu")
    d = str(tmp_path / "ck")
    TFC.save_forecaster(d, tfc, tparams, step=3, extra={"note": "torch"})
    jfc, jparams, extra = JFC.load_forecaster(d)
    assert jfc.cfg == fc.cfg and extra["note"] == "torch"
    _leaves_equal(jparams, tparams)
    # the two packages write the same manifest
    JFC.save_forecaster(str(tmp_path / "jk"), fc, params, step=3,
                        extra={"note": "torch"})
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        mine = json.load(f)
    with open(tmp_path / "jk" / "step_00000003" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs


def test_bf16_leaves_round_trip_both_ways(tmp_path):
    bits = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    jtree = {"a": jnp.asarray(bits).astype(jnp.bfloat16),
             "b": jnp.arange(4, dtype=jnp.int32)}
    JC.save_checkpoint(str(tmp_path / "j"), 0, jtree)
    template = {"a": torch.empty(5, 3, dtype=torch.bfloat16, device="meta"),
                "b": torch.empty(4, dtype=torch.int32, device="meta")}
    got, _ = TC.load_checkpoint(str(tmp_path / "j"), template)
    assert got["a"].dtype == torch.bfloat16 and got["b"].dtype == torch.int32
    np.testing.assert_array_equal(got["a"].view(torch.int16).numpy(),
                                  np.asarray(jtree["a"]).view(np.int16))
    TC.save_checkpoint(str(tmp_path / "t"), 0, got)
    back, _ = JC.load_checkpoint(str(tmp_path / "t"), jtree)
    assert back["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]).view(np.int16),
                                  np.asarray(jtree["a"]).view(np.int16))
    np.testing.assert_array_equal(np.asarray(back["b"]), np.arange(4))


@pytest.mark.parametrize("bits", [16, 8])
def test_quantize_tree_bitwise_equal_to_jax(jax_model, bits, tmp_path):
    _, params = jax_model
    tparams = TFC.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                    device="cpu")
    _leaves_equal(JC.quantize_tree(params, bits), TC.quantize_tree(tparams, bits))
    # and through load_forecaster's comm_bits
    fc = jax_model[0]
    d = str(tmp_path / "ck")
    JFC.save_forecaster(d, fc, params)
    _leaves_equal(JFC.load_forecaster(d, comm_bits=bits)[1],
                  TFC.load_forecaster(d, comm_bits=bits, device="cpu")[1])


def test_quantize_tree_edges():
    tree = {"w": torch.tensor([0.5, -1.25, 3.0]), "z": torch.zeros(3),
            "t": torch.arange(3)}
    assert TC.quantize_tree(tree, 32) is tree
    q8 = TC.quantize_tree(tree, 8)
    assert torch.equal(q8["z"], torch.zeros(3))      # all-zero leaf stays 0
    assert q8["t"].dtype == torch.int64 and torch.equal(q8["t"], tree["t"])
    # half-way points round to even, as jnp.round does
    half = {"h": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5])}
    jhalf = {"h": jnp.asarray([127.0, 0.5, 1.5, 2.5, -0.5])}
    _leaves_equal(JC.quantize_tree(jhalf, 8), TC.quantize_tree(half, 8))
    with pytest.raises(ValueError, match="8, 16 or 32"):
        TC.quantize_tree(tree, 12)
    # stochastic rounding (the training wire; bitwise against JAX in
    # test_torch_random.py) keeps the same edges and the int8 grid
    from repro_torch import random as R

    qs = TC.quantize_tree(tree, 8, key=R.PRNGKey(0))
    assert torch.equal(qs["z"], torch.zeros(3)) and torch.equal(qs["t"], tree["t"])
    steps = qs["w"] / (3.0 / 127.0)
    assert torch.equal(steps, torch.round(steps))
    assert (qs["w"] - tree["w"]).abs().max() < 3.0 / 127.0


def test_missing_flash_flag_restores_off(tmp_path):
    tfc = TFC.get_forecaster("logtst", **SMALL)
    d = str(tmp_path / "ck")
    TFC.save_forecaster(d, tfc, tfc.init_params(torch.Generator().manual_seed(0),
                                                device="cpu"), step=1)
    mpath = os.path.join(d, "step_00000001", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["extra"]["forecast_config"]["use_flash_attn"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert TFC.load_forecaster(d, device="cpu")[0].cfg.use_flash_attn is False


def test_latest_step_skip_rules_agree(tmp_path):
    root = tmp_path / "ck"
    tree = {"w": torch.ones(2)}
    TC.save_checkpoint(str(root), 2, tree)
    TC.save_checkpoint(str(root), 5, tree)
    os.makedirs(root / "step_00000009")                      # no manifest yet
    (root / "step_00000009" / "arrays.npz").write_bytes(b"")
    os.makedirs(root / "step_final")                         # non-numeric
    (root / "step_00000011").write_text("stray file")        # not a dir
    (root / "notes.txt").write_text("x")
    assert TC.latest_step(str(root)) == JC.latest_step(str(root)) == 5
    assert TC.latest_step(str(tmp_path / "missing")) is None
    assert TC.read_manifest(str(root))[0] == 5
    with pytest.raises(FileNotFoundError):
        TC.read_manifest(str(tmp_path / "empty"))


def _rows():
    return [{"policy": "psgf", "cluster": 0}, {"policy": "psgf", "cluster": 1}]


def test_routing_manifests_identical_both_ways(tmp_path):
    jtask = JT.get_task("ev", quick=True, num_clients=6, num_days=120,
                        look_back=32, horizon=2, clusters=2)
    ttask = TT.get_task("ev", quick=True, num_clients=6, num_days=120,
                        look_back=32, horizon=2, clusters=2)
    series = jtask.series()
    labels = np.array([0, 1, 0, 1, 1, 0])
    jm = JFC.get_forecaster("logtst", **SMALL)
    tm = TFC.get_forecaster("logtst", **SMALL)
    jp = JT.write_routing_manifest(str(tmp_path / "j"), jtask, jm, labels,
                                   _rows(), series=series)
    tp = TT.write_routing_manifest(str(tmp_path / "t"), ttask, tm, labels,
                                   _rows(), series=series)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    # generation bumps and per-cluster updates, each package on the other's
    JT.update_routing_manifest(str(tmp_path / "t"), "psgf", {1: "psgf_c1_g1"},
                               station_norm={2: (1.5, 2.5)})
    TT.update_routing_manifest(str(tmp_path / "j"), "psgf", {1: "psgf_c1_g1"},
                               station_norm={2: (1.5, 2.5)})
    for root in ("j", "t"):
        assert TT.manifest_generations(str(tmp_path / root)) == \
            JT.manifest_generations(str(tmp_path / root)) == [0, 1]
        assert TT.read_routing_manifest(str(tmp_path / root)) == \
            JT.read_routing_manifest(str(tmp_path / root))
        assert TT.read_routing_manifest(str(tmp_path / root), generation=0) == \
            JT.read_routing_manifest(str(tmp_path / root), generation=0)
    for name in ("routing.json", "routing.g000000.json", "routing.g000001.json"):
        with open(tmp_path / "j" / name, "rb") as a, \
                open(tmp_path / "t" / name, "rb") as b:
            assert a.read() == b.read(), name
    # a torn routing.json falls back to the newest snapshot in both
    (tmp_path / "t" / "routing.json").write_text("{torn")
    assert TT.read_routing_manifest(str(tmp_path / "t"))[0] == 1
    with pytest.raises(KeyError, match="unknown policy"):
        TT.update_routing_manifest(str(tmp_path / "t"), "nope", {})


@pytest.mark.parametrize("name,kw", [
    ("ev_synthetic", dict(seed=0, num_clients=7, num_days=150)),
    ("nn5_synthetic", dict(seed=1, num_clients=5, num_days=100)),
    ("household_synthetic", dict(seed=4, num_clients=5, num_days=120)),
    ("ett_like", dict(seed=2, num_channels=3, length=500)),
    ("weather_like", dict(seed=3, num_channels=2, length=600)),
    ("synthetic_tokens", dict(seed=5, batch=2, seq_len=16, vocab=50)),
])
def test_synthetic_data_bitwise(name, kw):
    a, b = getattr(JS, name)(**kw), getattr(TS, name)(**kw)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_windowing_bitwise():
    series = JS.ev_synthetic(seed=0, num_clients=8, num_days=160)
    for fn in ("client_datasets", "client_series_datasets"):
        ja, ta = getattr(JW, fn)(series, 32, 2), getattr(TW, fn)(series, 32, 2)
        for x, y in zip(ja[:3], ta[:3]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ja[3]["kept"], ta[3]["kept"])
        for x, y in zip(ja[3]["norm"], ta[3]["norm"]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(JW.make_windows(series, 16, 4),
                                  TW.make_windows(series, 16, 4))
    assert JW.window_split_counts(160, 32, 2) == TW.window_split_counts(160, 32, 2)
    js, ji, jinfo = JW.client_series(series, 32, 2)
    ts, ti, tinfo = TW.client_series(series, 32, 2)
    np.testing.assert_array_equal(js, ts)
    assert ji == ti
    jtask = JT.get_task("ev", quick=False)
    ttask = TT.get_task("ev", quick=False)
    assert vars(jtask) == vars(ttask)
    np.testing.assert_array_equal(jtask.series(), ttask.series())
