"""Zoo training in the port (``repro_torch.launch.{steps,train}``) against the
JAX package on the CPU, in float32 at the reduced configs (2 layers,
d_model 256): qwen2's and hymba's ``loss_fn`` and gradients on the same
numpy params, then the trainers end to end (``train``: 4 steps;
``train_psgf``: 2 pods, 2 syncs) from ``PRNGKey(0)`` on both sides, their
wire bytes, checkpoints and the CLI."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import psgf_dp as JP  # noqa: E402
from repro.common.pytree_utils import tree_size_bytes as jax_tree_size_bytes  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.models import decoder as JD  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fl import masks as M  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import decoder as TD  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from repro_torch import random as R  # noqa: E402

# float32 on both sides (no TF32 on the CPU). The loss and its gradients go
# through 2 layers of width 256-1024, attention and a 512-way softmax, whose
# matmuls and reductions torch and XLA sum in other orders: ulps per op,
# ~1e-6 relative on the losses (~6) and gradients seen here. 1e-5 relative
# + absolute leaves that margin; a wrong mask, bias, norm or Adam term moves
# them by 1e-3 or more. Unlike the forecaster's, qwen2's ``attn/bk`` has a
# real gradient (RoPE rotates the key bias by position), so every leaf is
# compared.
TRAIN_PARITY_TOL = 1e-5
BATCH, SEQ = 2, 16
STEPS, PODS, INTERVAL = 4, 2, 2
LR = 3e-4                      # the trainers' default peak of the 1cycle
# Parameters after training: Adam moves an element by ~lr whatever its
# gradient's size (m / sqrt(v) is +-1 at the first step), so an element whose
# gradient is at float-noise level can step the other way in the other
# package. Such elements are rare (1 of 524,288 seen); each is within one
# step of 2 lr per Adam step. Every other element is within TRAIN_PARITY_TOL.
ADAM_FLIP_SHARE = 1e-4


def _f32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


T_QWEN = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="float32")
J_QWEN = dataclasses.replace(jax_get_config("qwen2-1.5b").reduced(), dtype="float32")
T_HYMBA = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="float32")
J_HYMBA = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(), dtype="float32")


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if s.init in ("ones", "zeros"):
            return (1.0 if s.init == "ones" else 0.0) + 0.1 * noise
        return (S._scale(s) * noise).astype(np.float32)

    return pt.tree_map(make, TD.model_spec(cfg), is_leaf=S.is_spec)


def _close(got, want, msg="", tol=TRAIN_PARITY_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _batch(cfg, seq=SEQ):
    toks = R.randint(R.PRNGKey(3), (BATCH, seq + 1), 0, cfg.vocab_size).numpy()
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("arch,seq", [("qwen2", SEQ), ("hymba", 40)])
def test_loss_and_grads_match_jax(arch, seq):
    """``loss_fn`` and every gradient (hymba at 40 tokens, past its window of
    32; its SSM trains through the scan's plain version on the CPU)."""
    tcfg, jcfg = (T_QWEN, J_QWEN) if arch == "qwen2" else (T_HYMBA, J_HYMBA)
    params = numpy_params(tcfg)
    batch = _batch(tcfg, seq)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JD.loss_fn(jcfg, p, jax.tree_util.tree_map(jnp.asarray, batch)),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
    tparams = TD.params_from_numpy(params, "cpu")
    tbatch = pt.tree_map(torch.from_numpy, batch)
    (tl, tm), tg = pt.value_and_grad(lambda p, b: TD.loss_fn(tcfg, p, b),
                                     tparams, tbatch)
    _close(float(tl), float(jl), "loss")
    _close(float(tm["ce"]), float(jm["ce"]), "ce")
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = pt.flatten_with_paths(tg)
    assert len(tleaves) == len(jleaves)
    for (path, g), (_, w) in zip(tleaves, jleaves):
        _close(g.numpy(), np.asarray(w), path)


def test_remat_leaves_the_gradients_unchanged():
    params = TD.params_from_numpy(numpy_params(T_QWEN), "cpu")
    batch = pt.tree_map(torch.from_numpy, _batch(T_QWEN))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(T_QWEN, remat=remat)
        out[remat] = pt.value_and_grad(lambda p, b: TD.loss_fn(cfg, p, b),
                                       params, batch)
    assert torch.equal(out[True][0][0], out[False][0][0])
    for a, b in zip(pt.leaves(out[True][1]), pt.leaves(out[False][1])):
        assert torch.equal(a, b)


def test_cross_entropy_loss_masked():
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = TL.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        _close(float(got), float(want))


def test_make_optimizer_and_build_train_step():
    opt = steps_mod.make_optimizer(T_QWEN, total_steps=100)
    assert opt.moment_dtype == "float32"
    big = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=500)
    assert steps_mod.make_optimizer(big).moment_dtype == "bfloat16"   # > 20B
    fn, api, opt = steps_mod.build_train_step(T_QWEN, device="cpu")
    params = api.init_params(R.PRNGKey(0))
    state = opt.init(params)
    batch = pt.tree_map(torch.from_numpy, _batch(T_QWEN))
    before = params["embed"]["embedding"].clone()
    p2, s2, metrics = fn(params, state, batch)
    assert p2 is params and s2 is state and int(state["t"]) == 1
    assert set(metrics) == {"ce", "aux", "loss"}
    assert not torch.equal(before, params["embed"]["embedding"])


# --- the trainers end to end against the reference's --------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``train`` and ``train_psgf`` in float32, the reference's
    syncs recorded through ``psgf_dp.psgf_sync``."""
    root = tmp_path_factory.mktemp("train")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train, "get_config", _f32(jax_get_config))
    mp.setattr(train_mod, "get_config", _f32(get_config))
    syncs = []
    real_sync = JP.psgf_sync

    def recording_sync(local, glob, key, cfg, pods):
        out = real_sync(local, glob, key, cfg, pods)
        syncs.append({"key": np.asarray(jax.random.key_data(key)).tolist(),
                      "wire_bytes": float(out[2]["wire_bytes"]),
                      "full_bytes": 2.0 * pods * jax_tree_size_bytes(out[1])})
        return out

    mp.setattr(JP, "psgf_sync", recording_sync)
    kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, reduced=True, lr=LR,
              log_every=100)
    pkw = dict(kw, pods=PODS, sync_interval=INTERVAL)
    try:
        out = {
            "jax_train": jax_train.train("qwen2-1.5b", **kw),
            "jax_psgf": jax_train.train_psgf("qwen2-1.5b", **pkw,
                                             ckpt_dir=str(root / "jax")),
            "jax_syncs": syncs,
            "hist": {}, "psgf_hist": {}, "root": root,
        }
        out["train"] = train_mod.train("qwen2-1.5b", **kw, device="cpu",
                                       history=out["hist"])
        out["psgf"] = train_mod.train_psgf("qwen2-1.5b", **pkw, device="cpu",
                                           ckpt_dir=str(root / "port"),
                                           history=out["psgf_hist"])
    finally:
        mp.undo()
    return out


def test_train_losses_match_jax(runs):
    assert len(runs["train"]) == STEPS
    _close(runs["train"], runs["jax_train"])
    assert runs["train"][-1] < runs["train"][0]
    assert len(runs["hist"]["step_s"]) == STEPS


def test_train_psgf_losses_match_jax(runs):
    assert len(runs["psgf"]) == STEPS
    _close(runs["psgf"], runs["jax_psgf"])
    assert runs["psgf"][-1] < runs["psgf"][0]


def test_train_psgf_wire_bytes_exact(runs):
    hist = runs["psgf_hist"]
    syncs = runs["jax_syncs"]
    assert len(syncs) == len(hist["wire_bytes"]) == STEPS // INTERVAL
    assert hist["sync_keys"] == [s["key"] for s in syncs]
    assert hist["wire_bytes"] == [s["wire_bytes"] for s in syncs]
    assert hist["psgf_bytes"] == sum(s["wire_bytes"] for s in syncs)
    assert hist["full_bytes"] == sum(s["full_bytes"] for s in syncs)
    assert 0 < hist["psgf_bytes"] < hist["full_bytes"]
    # the bytes from the realised gates: each leaf's bytes times its share
    # gate for every selected pod, up and down, and its forward gate for
    # every unselected pod
    params = train_mod.ModelApi(T_QWEN, "cpu").init_params(R.PRNGKey(0))
    for key, wire in zip(hist["sync_keys"], hist["wire_bytes"]):
        k_sel, k_share, k_fwd = R.split(torch.tensor(key), 3)
        c = int(M.select_clients(k_sel, PODS, 0.5).sum())
        share = pt.leaves(M.leaf_gates(k_share, params, 0.3))
        fwd = pt.leaves(M.leaf_gates(k_fwd, params, 0.2))
        want = sum(leaf.numel() * 4 * (2 * c * float(s) + (PODS - c) * float(f))
                   for leaf, s, f in zip(pt.leaves(params), share, fwd))
        assert wire == want


def test_train_psgf_checkpoint_restores(runs):
    root = runs["root"]
    template = {"params": TD.init_params(T_QWEN, R.PRNGKey(1), "cpu")}
    glob, extra = load_checkpoint(str(root / "port"), template)
    assert extra == {"arch": "qwen2-1.5b", "final_loss": runs["psgf"][-1],
                     "sync": "psgf", "pods": PODS}
    assert sorted(os.listdir(root / "port")) == [f"step_{STEPS:08d}"]
    # the restored global model is the reference's
    jglob, jextra = jax_load_checkpoint(str(root / "jax"),
                                        {"params": jax.eval_shape(
                                            lambda: JD.init_params(J_QWEN,
                                                                   jax.random.PRNGKey(0)))})
    jleaves = dict((("/".join(str(k.key) for k in kp)), v) for kp, v in
                   jax.tree_util.tree_flatten_with_path(jglob["params"])[0])
    for path, leaf in pt.flatten_with_paths(glob["params"]):
        got, want = leaf.numpy(), np.asarray(jleaves[path])
        diff = np.abs(got - want)
        off = diff > TRAIN_PARITY_TOL * (1 + np.abs(want))
        assert off.sum() <= ADAM_FLIP_SHARE * off.size, path
        assert diff.max() <= 2 * LR * STEPS, path
    _close(jextra["final_loss"], extra["final_loss"])


def test_cli_on_the_cpu(capsys, tmp_path):
    losses = train_mod.main(["--arch", "qwen2-1.5b", "--device", "cpu",
                             "--steps", "2", "--batch", "1", "--seq", "8"])
    assert len(losses) == 2
    out = capsys.readouterr().out
    assert "final loss" in out
    losses = train_mod.main(["--arch", "hymba-1.5b", "--device", "cpu",
                             "--steps", "3", "--batch", "1", "--seq", "8",
                             "--sync", "psgf", "--pods", "2",
                             "--sync-interval", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "PSGF sync wire bytes" in out and "final loss" in out
    assert os.listdir(tmp_path) == ["step_00000003"]


def test_unported_families_raise(monkeypatch):
    """Every family trains: one step of xlstm-125m and of the
    encoder-decoder seamless-m4t-large-v2 at their reduced configs in
    float32; the first loss against the reference's ``loss_fn`` at its own
    ``PRNGKey(0)`` weights on its own first batch."""
    from repro.launch.api import ModelApi as JaxModelApi

    monkeypatch.setattr(train_mod, "get_config", _f32(get_config))
    for arch in ("xlstm-125m", "seamless-m4t-large-v2"):
        losses = train_mod.train(arch, steps=1, batch=1, seq=8, device="cpu")
        jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32").reduced()
        api = JaxModelApi(jcfg)
        params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
        want, _ = jax.jit(api.loss_fn)(params, jax_train.make_batch(jcfg, 0, 1, 8))
        assert len(losses) == 1
        # weights from one key on each side (erfinv's last ulps)
        _close(losses[0], float(want), arch)


def test_seamless_losses_follow_the_reference_under_one_cycle(monkeypatch):
    """Four ``train`` steps of reduced seamless-m4t-large-v2 in float32 under
    the trainers' 1cycle (lr/25 at step 0, the peak at step 1, cosine down),
    every loss against the reference's ``train`` from ``PRNGKey(0)``. The
    reference's loss rises at the last of the four steps, and the port's
    with it: the rise is the trainer's schedule, taken step for step."""
    monkeypatch.setattr(jax_train, "get_config", _f32(jax_get_config))
    monkeypatch.setattr(train_mod, "get_config", _f32(get_config))
    kw = dict(steps=4, batch=1, seq=8, reduced=True, lr=LR, log_every=100)
    want = jax_train.train("seamless-m4t-large-v2", **kw)
    got = train_mod.train("seamless-m4t-large-v2", **kw, device="cpu")
    assert len(got) == 4
    _close(got, want)
    assert want[3] > want[2] and got[3] > got[2]
    assert got[-1] < got[0]
