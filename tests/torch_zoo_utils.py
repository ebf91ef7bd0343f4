"""Shared helpers of the zoo parity tests (``tests/test_torch_moe_decoder.py``,
``test_torch_long_attention.py``, ``test_torch_zoo_families.py``): float32
reduced configs of both packages, numpy-made params and tree comparisons."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.common import pytree_utils as pt
from repro_torch.configs import get_config
from repro_torch.models import decoder as TD
from repro_torch.models import spec as S


def f32_configs(arch, **kw):
    """(port, reference) reduced configs of ``arch`` in float32."""
    return (dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32", **kw))


def numpy_params(spec_tree, seed=0):
    """Params of the spec's shapes from numpy: scaled normals, and ones /
    zeros leaves perturbed (so the norm scales and biases matter)."""
    rng = np.random.default_rng(seed)

    def make(s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "ones":
            return 1.0 + 0.1 * noise
        if s.init == "zeros":
            return 0.1 * noise
        return (S._scale(s) * noise).astype(np.float32)

    return pt.tree_map(make, spec_tree, is_leaf=S.is_spec)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree):
    return TD.params_from_numpy(tree, "cpu")


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def close_trees(got, want, tol):
    """A port tree (tensors) against a JAX tree: the same paths, shapes and
    values within ``tol``."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = pt.flatten_with_paths(got)
    assert [("/".join(str(k.key) for k in p)) for p, _ in jl] == [p for p, _ in tl]
    for (_, w), (path, g) in zip(jl, tl):
        assert tuple(g.shape) == tuple(w.shape), path
        close(g.detach().float().numpy(), w, tol, path)


def layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
