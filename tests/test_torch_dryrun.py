"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.cost``): a
record per combo on meta tensors, matmul FLOPs against an analytic count,
the depth and length extrapolation against a direct count, and the one-device
peak estimate against the bytes it must at least hold."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import hw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.api import ModelApi, input_structs  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.models.spec import spec_num_params  # noqa: E402


def _dense_forward_flops(cfg, B, S, head_positions):
    """Analytic matmul FLOPs of a dense decoder's forward: 2 x (matmul
    params) x tokens for the projections (q, k, v, o; the gated MLP's three
    matrices) and 2 x 2 x B x H x S^2 x hd for QK^T and PV over every
    (query, key) pair (the plain version's full products), plus the tied
    head over ``head_positions`` positions."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    proj = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff
    layer = 2 * proj * B * S + 2 * 2 * B * H * S * S * hd
    return cfg.num_layers * layer + 2 * B * head_positions * d * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_account_combo_writes_a_record(arch, tmp_path, monkeypatch):
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path))
    cfg = get_config(arch).reduced()
    # in this process: the collectives (a fake process group of the mesh's
    # ranks) are counted in a child, tests/test_torch_collectives.py
    rec = DR.account_combo(arch, "train_4k", False, cfg_override=cfg, peak=True,
                           collectives=False)
    path = tmp_path / DR.save(rec)
    saved = json.loads(path.read_text())
    assert saved["status"] == "ok" and saved["mesh_shape"] == {"data": 16, "model": 16}
    args = saved["memory"]["argument_bytes_per_device"]
    assert args["total"] == args["params"] + args["opt_state"] + args["batch"] > 0
    assert saved["memory"]["peak_one_device"]["peak_bytes"] > 0
    flops = saved["cost"]["flops"]
    assert flops > 0 and saved["cost"]["flops_per_device"] == flops / 256
    roof = saved["roofline"]
    assert roof["compute_s"] == pytest.approx(flops / 256 / hw.BF16_FLOP_PER_S)
    assert roof["memory_s"] == pytest.approx(args["total"] / hw.HBM_BYTES_PER_S)
    assert roof["roofline_s"] == max(roof["compute_s"], roof["memory_s"])
    assert "extrapolated" not in saved["cost"]
    # the reduced widths do not divide a 16-way axis: recorded, not raised
    assert saved["dropped_shardings"]


def test_dense_forward_flops_match_analytic_count():
    cfg = get_config("qwen2-1.5b").reduced()
    B, S = 2, 48
    api = ModelApi(cfg, "meta")
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    with torch.inference_mode():
        got = cost.cost_summary(decoder.forward, cfg, api.abstract_params(), tokens)
    assert got["flops"] == _dense_forward_flops(cfg, B, S, S)
    # the dry run's prefill (its logits at the last position only), counted
    # at depths 1 and 2 and extrapolated to 5 layers
    deep = dataclasses.replace(cfg, num_layers=5)
    flops, points = DR.extrapolated_flops(deep, InputShape("p", S, B, "prefill"))
    assert flops == _dense_forward_flops(deep, B, S, 1)
    assert [p["depths"]["num_layers"] for p in points] == [1, 2]


@pytest.mark.parametrize("arch,kind", [("xlstm-125m", "prefill"),
                                       ("hymba-1.5b", "train")])
def test_length_and_depth_extrapolation_matches_a_direct_count(arch, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=3)
    shape = InputShape("x", 40, 2, kind)
    flops, points = DR.extrapolated_flops(cfg, shape, (8, 16, 24))
    assert len(points) == 6 and max(p["seq_len"] for p in points) == 24
    direct = DR.step_flops(cfg, shape)
    assert flops == pytest.approx(direct, rel=1e-2)


def test_one_device_peak_holds_params_grads_and_moments():
    cfg = get_config("qwen2-1.5b").reduced()
    param_bytes = 4 * spec_num_params(decoder.model_spec(cfg))
    one = DR.one_device_peak(cfg, 2, 32)
    # params, their gradients and Adam's two float32 moments, at least
    assert one["peak_bytes"] >= 4 * param_bytes
    assert one["arguments_bytes"] >= 3 * param_bytes
    two = DR.one_device_peak(cfg, 2, 32, pods=2)
    # the global model, two pods' params and moments, one pod's gradients
    assert two["peak_bytes"] >= 8 * param_bytes > one["peak_bytes"]


def test_argument_bytes_sum_the_shard_shapes():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import sharded_serve_inputs
    from repro_torch.sharding.rules import make_rules

    cfg = get_config("qwen2-1.5b")
    rules = make_rules(make_production_mesh(), "serve")
    params, batch = sharded_serve_inputs(cfg, InputShape("p", 64, 32, "prefill"), rules)
    got = cost.argument_bytes(params=params, batch=batch)
    assert got["batch"] == 32 // 16 * 64 * 4
    emb = params["embed"]["embedding"]       # (vocab, embed_tbl): vocab on model
    assert emb.spec == ("model",) and emb.shard_shape == (151936 // 16, 1536)
    assert emb.shard_nbytes == 151936 // 16 * 1536 * 2       # bf16 when serving
    assert got["total"] == got["params"] + got["batch"]
    assert input_structs(cfg, InputShape("p", 64, 32, "prefill"))["tokens"].is_meta
