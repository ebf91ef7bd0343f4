"""Training of the zoo's moe and vlm families on the card against the CPU,
and ``train`` on a one-rank NCCL group's host mesh (through ``main`` and
``--processes 1``) against the plain one.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports no JAX, so it runs on a GPU machine without the reference package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_zoo_training_cuda.py
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_BF16_ATOL, FLASH_BF16_RTOL, flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import decoder, layers  # noqa: E402

# card against CPU in float32 after two Adam steps: the reason is beside
# chip_smoke.TRAIN_CPU_TOL (matmul orders; Adam's ~lr steps)
TRAIN_CPU_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _float32_config(monkeypatch):
    real = TR._config
    monkeypatch.setattr(TR, "_config", lambda a, reduced: dataclasses.replace(
        real(a, reduced), dtype="float32"))


def _train_recording_routes(monkeypatch, arch, seq, device):
    """Two reduced float32 ``train`` steps on ``device``: the losses and
    every MoE call's top-k experts (forward and remat recompute)."""
    routes = []
    real = layers.moe_route

    def moe_route(*args, **kw):
        route = real(*args, **kw)
        routes.append(route["gate_idx"].cpu())
        return route

    monkeypatch.setattr(layers, "moe_route", moe_route)
    losses = TR.train(arch, steps=2, batch=2, seq=seq, log_every=100, device=device)
    monkeypatch.setattr(layers, "moe_route", real)
    return losses, routes


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq", [("phi3.5-moe-42b-a6.6b", 64),
                                      ("deepseek-v2-236b", 4096),
                                      ("internvl2-2b", 64)])
def test_reduced_training_on_the_card_matches_the_cpu(cuda, monkeypatch, arch, seq):
    _float32_config(monkeypatch)
    got, got_routes = _train_recording_routes(monkeypatch, arch, seq, cuda)
    want, want_routes = _train_recording_routes(monkeypatch, arch, seq, "cpu")
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TRAIN_CPU_TOL, atol=TRAIN_CPU_TOL)
    assert len(got_routes) == len(want_routes)
    assert all(torch.equal(a, b) for a, b in zip(got_routes, want_routes))
    if arch != "internvl2-2b":
        assert got_routes


@pytest.mark.cuda
def test_flash_at_phi_psgf_shape_matches_plain(cuda):
    """(4, 512, 32/8, 128), bf16, causal: the tensor-core route within its
    relative bound of the float32 plain version on the same inputs."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((4, 512, 32, 128), (4, 512, 8, 128), (4, 512, 8, 128)))
    assert ops.kernel_route(q.dtype, 128, tuple(q.shape), tuple(k.shape)) == "tensor_core"
    before = ops.ROUTE_LAUNCHES["tensor_core"]
    got = flash_attention(q, k, v, causal=True).float()
    assert ops.ROUTE_LAUNCHES["tensor_core"] == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    err = (got - want).abs()
    assert bool((err <= FLASH_BF16_RTOL * want.abs() + FLASH_BF16_ATOL).all())
    assert float(err.max()) <= BF16_TOL


_NCCL_CHILD = r"""
import json, sys
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as T
fa.reset_launch_counts()
losses = T.main(sys.argv[1:])       # joins the group the environment names
print(json.dumps({"losses": losses, "tc": fa.ROUTE_LAUNCHES["tensor_core"]}))
"""
NCCL_TRAIN = ["--arch", "qwen2-1.5b", "--steps", "2", "--batch", "2",
              "--seq", "128", "--device", "cuda"]


@pytest.mark.cuda
def test_train_on_one_nccl_rank_is_the_plain_train(cuda, tmp_path):
    """``chip_smoke.py`` phase 16 (a) at reduced size: ``launch.train.main``
    in a fresh process of a one-rank group (what ``--processes 1`` starts:
    it joins over NCCL and trains on the (1, 1) host mesh), bitwise the
    plain ``train``, through the tensor-core flash kernel."""
    procs = D.spawn_processes(1, [sys.executable, "-c", _NCCL_CHILD,
                                  *NCCL_TRAIN],
                              env=D.child_env(), timeout=600,
                              coordinator=f"file://{tmp_path / 'store'}")
    assert procs[0].returncode == 0, procs[0].stderr[-4000:]
    rep = json.loads(procs[0].stdout.strip().splitlines()[-1])
    ops.reset_launch_counts()
    plain = TR.train("qwen2-1.5b", steps=2, batch=2, seq=128, device="cuda",
                     log_every=100)
    assert rep["losses"] == plain
    assert rep["tc"] == ops.ROUTE_LAUNCHES["tensor_core"] > 0


@pytest.mark.cuda
def test_processes_one_on_the_card_writes_the_plain_checkpoint(cuda, tmp_path):
    """``python -m repro_torch.launch.train --processes 1`` on the card
    (``distributed.launch_processes``: one child, one NCCL rank) writes the
    checkpoint that the plain CLI writes, bit for bit."""
    TR.main(NCCL_TRAIN + ["--processes", "1", "--ckpt-dir", str(tmp_path / "mesh")])
    TR.main(NCCL_TRAIN + ["--ckpt-dir", str(tmp_path / "plain")])
    cfg = get_config("qwen2-1.5b").reduced()
    template = {"params": decoder.abstract_params(cfg)}   # meta, float32
    mesh, extra = load_checkpoint(str(tmp_path / "mesh"), template)
    plain, extra_plain = load_checkpoint(str(tmp_path / "plain"), template)
    assert extra == extra_plain
    for (path, a), (_, b) in zip(pt.flatten_with_paths(mesh),
                                 pt.flatten_with_paths(plain)):
        assert torch.equal(a, b), path
