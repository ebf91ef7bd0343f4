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
    # in this process, what needs no process group: the per-device counts
    # (a fake process group of the mesh's ranks) are held in a child,
    # tests/test_torch_collectives.py
    rec = DR.account_combo(arch, "train_4k", False, cfg_override=cfg, peak=True,
                           per_device=False)
    path = tmp_path / DR.save(rec)
    saved = json.loads(path.read_text())
    assert saved["status"] == "ok" and saved["mesh_shape"] == {"data": 16, "model": 16}
    memory = saved["memory"]
    args = memory["argument_bytes"]
    assert memory["argument_size_in_bytes"] == args["total"] == (
        args["params"] + args["opt_state"] + args["batch"]) > 0
    assert memory["peak_one_device"]["peak_bytes"] > 0
    assert saved["cost"]["flops_global"] > 0 and "flops" not in saved["cost"]
    assert "flops_per_device_ideal" not in saved["cost"]
    assert "roofline" not in saved and "collectives" not in saved
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


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_flash_meta_forward_allocates_only_q_k_v_and_the_output():
    """On ``meta`` the flash wrapper's forward is the kernel's: its output
    and nothing else (no (B, H, Sq, Skv) score tensor), with the plain
    version's FLOPs (the full S x S products) and an exponential a score
    by formula (``kernels._meta``); the backward stays the plain one."""
    from repro_torch.kernels.flash_attention import ops

    B, S, H, KV, hd = 2, 256, 8, 2, 64
    q, k, v = _meta(B, S, H, hd, dtype=torch.bfloat16), _meta(B, S, KV, hd, dtype=torch.bfloat16), \
        _meta(B, S, KV, hd, dtype=torch.bfloat16)
    with torch.no_grad():
        got = cost.account(lambda q, k, v: ops.flash_attention(q, k, v), q, k, v)
    assert got["peak_bytes"] == _nbytes(q, k, v) + _nbytes(q)
    assert got["output_bytes"] == _nbytes(q) and got["alias_bytes"] == 0
    assert got["flops"] == 4 * B * H * S * S * hd
    assert got["transcendentals"] == B * H * S * S
    # the kernel's traffic: q, k, v read once, the output written once
    assert got["bytes_accessed"] == _nbytes(q, k, v) + _nbytes(q)
    # under autograd the backward is the plain version's: it makes scores
    qg, kg, vg = (t.requires_grad_() for t in (_meta(B, S, H, hd), _meta(B, S, KV, hd),
                                                _meta(B, S, KV, hd)))
    got = cost.account(lambda q, k, v: torch.autograd.grad(
        ops.flash_attention(q, k, v).sum(), (q, k, v)), qg, kg, vg)
    assert got["peak_by_phase"]["forward"] == 2 * _nbytes(qg, kg, vg) - _nbytes(kg, vg) + 4
    assert got["peak_by_phase"]["backward"] >= 4 * B * H * S * S


def test_ssm_scan_and_psgf_mix_meta_forwards_allocate_only_their_outputs():
    from repro_torch.kernels.psgf_mix import ops as mix
    from repro_torch.kernels.ssm_scan import ops as ssm

    Bsz, S, D, N = 2, 64, 32, 16
    x, dt = _meta(Bsz, S, D), _meta(Bsz, S, D)
    Bm, Cm, A = _meta(Bsz, S, N), _meta(Bsz, S, N), _meta(D, N)
    got = cost.account(lambda *a: ssm.ssm_scan(*a, return_state=True), x, dt, Bm, Cm, A)
    assert got["peak_bytes"] == _nbytes(x, dt, Bm, Cm, A) + _nbytes(x) + Bsz * D * N * 4
    assert got["flops"] == 0 and got["transcendentals"] == Bsz * S * D * N
    w_global, w_rows, mask = _meta(1000), _meta(4, 1000), _meta(4, 1000)
    got = cost.account(mix.psgf_mix_batch, w_global, w_rows, mask)
    assert got["peak_bytes"] == _nbytes(w_global, w_rows, mask) + _nbytes(w_rows) + 4
    assert got["bytes_accessed"] == _nbytes(w_global, w_rows, mask) + _nbytes(w_rows) + 4


def test_counts_of_single_ops():
    """The counter's rules on plain ops: matmul FLOPs two a multiply-add,
    transcendentals the result elements of exp / tanh / softmax and of pow
    at a fractional exponent only, bytes each op's operands and results
    (none for a view, the written argument of ``copy_`` not read)."""
    x, w = _meta(8, 16), _meta(16, 4)
    got = cost.cost_summary(lambda x, w: torch.tanh(x @ w), x, w)
    assert got["flops"] == 2 * 8 * 16 * 4 and got["transcendentals"] == 8 * 4
    assert got["bytes_accessed"] == _nbytes(x, w) + 3 * 8 * 4 * 4
    assert cost.cost_summary(lambda x: x ** 2, x)["transcendentals"] == 0
    assert cost.cost_summary(lambda x: x ** 0.5, x)["transcendentals"] == 8 * 16
    assert cost.cost_summary(lambda x: torch.softmax(x, -1), x)["transcendentals"] == 8 * 16
    assert cost.cost_summary(lambda x: torch.log_softmax(x, -1), x)["transcendentals"] == (
        8 * 16 + 8)
    assert cost.cost_summary(lambda x: x.view(16, 8).t(), x)["bytes_accessed"] == 0
    y = _meta(8, 16)
    assert cost.cost_summary(lambda x, y: y.copy_(x), x, y)["bytes_accessed"] == 2 * _nbytes(x)


def test_fake_and_meta_counts_agree():
    """The counter runs on meta tensors as they are; a view of one shares
    its base's storage, so every count equals the count on fake tensors."""
    cfg = get_config("qwen2-1.5b").reduced()
    fn, args = DR._train_peak_args(cfg, InputShape("x", 32, 2, "train"),
                                   DR.make_optimizer(cfg), 1)
    fake = cost.account(fn, *args, fake=True)
    meta = cost.account(fn, *args)
    assert fake == meta
    assert set(fake["peak_by_phase"]) == {"forward", "backward", "after"}
    assert fake["alias_bytes"] == fake["output_bytes"] - 4 * 3 > 0   # params, moments
