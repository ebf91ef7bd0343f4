"""FLOP and byte counts against hand counts."""
import json

import pytest

from bench import counts
from bench.tests.tiny import ROOT


def _model(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())["model"]


def test_logtst_flops_by_hand():
    # 15 tokens, d 128, d_ff 256, one attention block of three, horizon 2
    embed = 2 * 15 * 16 * 128
    mlp = 3 * 2 * 15 * (128 * 256 + 256 * 128)
    proj = 2 * 15 * 4 * 128 * 128
    pairs = 2 * 2 * 15 * 15 * 128
    head = 2 * 15 * 128 * 2
    assert counts.forward_flops(_model("logtst-psgf")) == embed + mlp + proj + pairs + head == 8_048_640
    assert counts.train_flops(_model("logtst-psgf")) == 24_145_920


def test_patchtst63_flops_by_hand():
    embed = 2 * 63 * 16 * 128
    mlp = 3 * 2 * 63 * (128 * 256 + 256 * 128)
    proj = 3 * 2 * 63 * 4 * 128 * 128
    pairs = 3 * 2 * 2 * 63 * 63 * 128
    head = 2 * 63 * 128 * 96
    assert counts.forward_flops(_model("patchtst63")) == embed + mlp + proj + pairs + head == 57_447_936
    assert counts.train_flops(_model("patchtst63")) == 172_343_808


@pytest.mark.parametrize("shape", [(8192, 15, 16, 8), (2688, 63, 16, 8),
                                   (120832, 15, 16, 8), (128, 63, 16, 8)])
def test_attention_bound_by_hand(shape):
    b, s, h, d = shape
    nbytes = 4 * b * s * h * d * 4          # q, k, v read, o written, fp32
    flops = 4 * b * h * d * s * s           # QK^T and P.V, 2 a multiply-add
    want = max(nbytes / 3.35e12, min(flops / 67e12, 3 * flops / 495e12))
    assert counts.attention_bound_s(b, s, h, d) == pytest.approx(want, rel=1e-12)
    # these shapes are all bound by bytes
    assert counts.attention_bound_s(b, s, h, d) == pytest.approx(nbytes / 3.35e12)


def test_attention_bound_matches_the_programs_formula():
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.flash_attention.bound import attention_bound

    for shape in [(8192, 15, 16, 8), (2688, 63, 16, 8), (4, 2048, 16, 64)]:
        got = counts.attention_bound_s(*shape)
        want = attention_bound(shape, shape, torch.float32, causal=False)["ms"] / 1e3
        assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("k", [1, 58, 256])
def test_mix_bound_by_hand(k):
    d = 273_284
    nbytes = (3 * k * d + d) * 4
    assert counts.mix_bound_s(k, d) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
