"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's: every parameter's spec and the dropped set for all ten configs,
both modes and both production meshes, and the reference's own rule cases.
The reference's rules run on a stand-in mesh that has only ``.shape`` (no
256-device jax mesh)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.api import ModelApi as JaxModelApi  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.api import ModelApi  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.sharding.rules import (is_axes, logical_to_sharding,  # noqa: E402
                                        logical_to_spec, make_rules, shard_shape)


class FakeMesh:
    """A mesh with only ``.shape`` (no devices), for both packages' rules."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _jax_specs(arch, mode, mesh, rules=None):
    """The reference's param specs {path: tuple} and dropped set (under
    ``rules`` when given)."""
    api = JaxModelApi(jax_get_config(arch))
    rules = rules or jax_rules.make_rules(FakeMesh(mesh), mode)
    shapes = jax.tree_util.tree_map(lambda s: s.shape, api.abstract_params())
    specs = jax_rules.logical_to_spec(api.param_axes(), rules, shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return ({"/".join(str(k.key) for k in path): tuple(s) for path, s in flat},
            rules.dropped)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_dropped_match_reference(arch, mode, mesh_name):
    mesh = MESHES[mesh_name]
    want, want_dropped = _jax_specs(arch, mode, mesh)
    api = ModelApi(get_config(arch), "meta")
    rules = make_rules(FakeMesh(mesh), mode)
    specs = logical_to_spec(api.param_axes(), rules, api.abstract_params())
    got = dict(pt.flatten_with_paths(specs, is_leaf=lambda x: isinstance(x, tuple)))
    assert got == want
    assert rules.dropped == want_dropped


def test_production_meshes_are_the_reference_layouts():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert dict(single.shape) == MESHES["single"] and single.size == 256
    assert list(multi.shape) == ["pod", "data", "model"] and multi.size == 512
    assert single.devices == () and multi.axis_names == ("pod", "data", "model")


def test_host_mesh_keeps_every_param_whole():
    """One local device: (1, 1) over ("data", "model"), so every shard shape
    is the parameter's whole shape and no rule drops."""
    mesh = make_host_mesh(device="cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),)
    api = ModelApi(get_config("phi3.5-moe-42b-a6.6b"), "meta")
    rules = make_rules(mesh, "train")
    got = logical_to_sharding(api.param_axes(), rules, api.abstract_params())
    pairs = pt.leaves(got, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                      and isinstance(x[1], tuple))
    shapes = [tuple(s.shape) for s in pt.leaves(api.abstract_params())]
    assert [shp for _, shp in pairs] == shapes and rules.dropped == set()


def test_divisibility_drop():
    rules = make_rules(FakeMesh({"data": 16, "model": 16}), "train")
    # qwen2-1.5b: 12 heads % 16 != 0 -> dropped; mlp 8960 % 16 == 0 -> kept
    spec = logical_to_spec({"wq": ("embed", "heads", "head_dim")}, rules,
                           {"wq": (1536, 12, 128)})
    assert spec["wq"] == ("data",)
    assert ("heads", 12, 16) in rules.dropped
    spec2 = logical_to_spec({"w": ("embed", "mlp")}, rules, {"w": (1536, 8960)})
    assert spec2["w"] == ("data", "model")
    assert shard_shape((1536, 8960), spec2["w"], rules.mesh) == (96, 560)


def test_batch_axes_multipod():
    rules = make_rules(FakeMesh({"pod": 2, "data": 16, "model": 16}), "train")
    spec = logical_to_spec({"t": ("batch", None)}, rules, {"t": (256, 4096)})
    assert spec["t"] == (("pod", "data"),)
    assert shard_shape((256, 4096), spec["t"], rules.mesh) == (8, 4096)
    # batch=1 is not divisible -> replicated
    spec1 = logical_to_spec({"t": ("batch", None)}, rules, {"t": (1, 1)})
    assert spec1["t"] == ()


def test_duplicate_mesh_axis_dropped():
    rules = make_rules(FakeMesh({"data": 4, "model": 4}), "train")
    # two logical axes both mapping to "model": the second drops
    spec = logical_to_spec({"w": ("vocab", "mlp")}, rules, {"w": (1024, 1024)})
    assert spec["w"] == ("model",)


def test_serve_rules_no_fsdp():
    rules = make_rules(FakeMesh({"data": 16, "model": 16}), "serve")
    spec = logical_to_spec({"w": ("embed", "mlp")}, rules, {"w": (4096, 14336)})
    assert spec["w"] == (None, "model")
    got = logical_to_sharding({"w": ("embed", "mlp")}, rules, {"w": (4096, 14336)})
    assert got["w"] == ((None, "model"), (4096, 896))


def test_serve_step_rule_overrides_match_reference():
    """``build_serve_step(..., rule_overrides={"embed": "data"})``: the 2-D
    serve-time weight split, the rule table and the param specs the
    reference's ``build_serve_step`` makes on an abstract (2, 2) mesh."""
    from repro.launch.steps import build_serve_step as jax_build_serve_step
    from repro_torch.launch.steps import build_serve_step

    class DeviceMeshShape:
        """What ``build_serve_step`` reads of a ``DeviceMesh``."""
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    arch = "qwen2-1.5b"
    overrides = {"embed": "data"}
    jmesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    jrules = jax_build_serve_step(jax_get_config(arch), jmesh,
                                  rule_overrides=overrides)[2]
    _, api, rules = build_serve_step(get_config(arch), "meta", mesh=DeviceMeshShape(),
                                     rule_overrides=overrides)
    assert rules.table == jrules.table and rules.table["embed"] == "data"
    assert build_serve_step(get_config(arch), "meta", mesh=DeviceMeshShape()
                            )[2].table["embed"] is None
    want, _ = _jax_specs(arch, "serve", None, rules=jrules)
    specs = logical_to_spec(api.param_axes(), rules, api.abstract_params())
    assert dict(pt.flatten_with_paths(
        specs, is_leaf=lambda x: isinstance(x, tuple))) == want


def test_fl_rules_follow_the_reference():
    for shape in ({"clients": 4}, {"data": 2}):
        want = jax_rules.make_rules(FakeMesh(shape), "fl").table
        assert make_rules(FakeMesh(shape), "fl").table == want


@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v2-236b", "hymba-1.5b",
                                  "seamless-m4t-large-v2"])
def test_param_axes_match_shapes(arch):
    """Every param's logical-axes tuple has one entry per dimension."""
    api = ModelApi(get_config(arch), "meta")
    axes = pt.leaves(api.param_axes(), is_leaf=is_axes)
    shapes = pt.leaves(api.abstract_params())
    assert len(axes) == len(shapes) > 0
    for a, s in zip(axes, shapes):
        assert len(a) == s.dim(), (a, tuple(s.shape))


def test_moe_expert_axis_sharded():
    rules = make_rules(FakeMesh({"data": 16, "model": 16}), "train")
    api = ModelApi(get_config("deepseek-v2-236b"), "meta")
    specs = logical_to_spec(api.param_axes(), rules, api.abstract_params())
    # (layers, experts, embed, mlp): experts (160) -> model, embed -> data
    assert specs["blocks"]["moe"]["w_gate"] == (None, "model", "data")
