"""The port's named shapes and abstract inputs (``repro_torch.launch.shapes``,
``launch.api.input_structs`` / ``input_specs``, ``launch.steps``'
``sharded_*_inputs``) against the reference's, for all ten configs and four
shapes on both production meshes: support and variants, every input's shape,
dtype and spec (decode caches included), and the per-device argument bytes
against the sum of the reference's shard shapes. The reference's sharded
inputs run on jax's ``AbstractMesh`` (no devices)."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import api as jax_api  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.sharding.rules import make_rules as jax_make_rules  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import api, cost, shapes, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.sharding.rules import make_rules  # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _configs(arch, shape_name):
    """(port, reference) configs of ``arch`` after the shape's variant."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    return (shapes.shape_variant(cfg, shapes.SHAPES[shape_name]),
            jax_shapes.shape_variant(jcfg, jax_shapes.SHAPES[shape_name]))


def _jax_leaves(tree):
    """{path: (shape, dtype name, spec, shard shape)} of a tree of
    ShapeDtypeStructs; one without a sharding (the reference's ``pos``) is
    replicated, spec ``()`` (the port's ``ShardedStruct`` for it)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, s in flat:
        sh = getattr(s, "sharding", None)
        out["/".join(str(getattr(k, "key", k)) for k in path)] = (
            tuple(s.shape), str(np.dtype(s.dtype)),
            () if sh is None else tuple(sh.spec),
            tuple(s.shape) if sh is None else tuple(sh.shard_shape(s.shape)))
    return out


def _port_leaves(tree):
    out = {}
    for path, s in pt.flatten_with_paths(tree):
        if isinstance(s, api.ShardedStruct):
            out[path] = (tuple(s.shape), str(s.dtype).replace("torch.", ""),
                         s.spec, s.shard_shape)
        else:
            out[path] = (tuple(s.shape), str(s.dtype).replace("torch.", ""),
                         (), tuple(s.shape))
    return out


def test_shapes_table_matches_reference():
    assert shapes.LONG_WINDOW == jax_shapes.LONG_WINDOW
    assert ({k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()})
    small = shapes.reduced_shape(shapes.SHAPES["decode_32k"], 32, 2)
    assert dataclasses.asdict(small) == dataclasses.asdict(
        jax_shapes.reduced_shape(jax_shapes.SHAPES["decode_32k"], 32, 2))


@pytest.mark.parametrize("shape_name", list(jax_shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_specs_and_bytes_match_reference(arch, shape_name):
    shape, jshape = shapes.SHAPES[shape_name], jax_shapes.SHAPES[shape_name]
    assert (shapes.shape_supported(get_config(arch), shape)
            == jax_shapes.shape_supported(jax_get_config(arch), jshape))
    cfg, jcfg = _configs(arch, shape_name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = _port_leaves(api.input_structs(cfg, shape))
    assert got == _jax_leaves(jax_api.input_structs(jcfg, jshape))
    mode = "train" if shape.kind == "train" else "serve"
    for multi_pod, (sizes, names) in MESHES.items():
        jrules = jax_make_rules(AbstractMesh(sizes, names), mode)
        rules = make_rules(make_production_mesh(multi_pod=multi_pod), mode)
        want = _jax_leaves(jax_api.input_specs(jcfg, jshape, jrules))
        got = _port_leaves(api.input_specs(cfg, shape, rules))
        assert got == want, multi_pod
        if shape.kind == "train":
            trees = steps.sharded_train_inputs(cfg, shape, rules,
                                               steps.make_optimizer(cfg))
            jtrees = jax_steps.sharded_train_inputs(
                jcfg, jshape, jrules, jax_steps.make_optimizer(jcfg))
        else:
            trees = steps.sharded_serve_inputs(cfg, shape, rules)
            jtrees = jax_steps.sharded_serve_inputs(jcfg, jshape, jrules)
        want_bytes = sum(math.prod(shard) * np.dtype(dt).itemsize
                         for tree in jtrees
                         for _, dt, _, shard in _jax_leaves(tree).values())
        got_bytes = cost.argument_bytes(
            **{str(i): t for i, t in enumerate(trees)})["total"]
        assert got_bytes == want_bytes, multi_pod
