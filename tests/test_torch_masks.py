"""The port's masks, gating policies and ``FLConfig`` against the JAX
package's, on the CPU, bit for bit from the same keys (the port's threefry
is bit-exact): Bernoulli, exact-k and top-k masks (``lax.top_k``'s
lowest-index tie-break), client selection (Python's ``round``), leaf gates,
and the downlink/uplink gates and train sets of all four element policies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fl import engine as JE  # noqa: E402
from repro.core.fl import masks as JM  # noqa: E402
from repro.core.fl import policies as JP  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from repro_torch.core.fl import masks as TM  # noqa: E402
from repro_torch.core.fl import policies as TP  # noqa: E402


def test_masks_bitwise():
    jk, tk = jax.random.PRNGKey(4), R.PRNGKey(4)
    for D, ratio in ((1, 0.3), (1_001, 0.3), (20_001, 0.2)):
        np.testing.assert_array_equal(
            TM.bernoulli_mask(tk, D, ratio).numpy(),
            np.asarray(JM.bernoulli_mask(jk, D, ratio)))
        np.testing.assert_array_equal(
            TM.client_masks(tk, 5, D, ratio).numpy(),
            np.asarray(JM.client_masks(jk, 5, D, ratio)))
    for D, k in ((10, 3), (1_001, 300), (50, 0), (7, 9)):
        got = TM.exact_k_mask(tk, D, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JM.exact_k_mask(jk, D, k)))
        assert int(got.sum()) == min(max(k, 0), D)
    for K, ratio in ((10, 0.5), (21, 0.5), (27, 0.5), (5, 0.5), (58, 0.1), (1, 0.5)):
        np.testing.assert_array_equal(TM.select_clients(tk, K, ratio).numpy(),
                                      np.asarray(JM.select_clients(jk, K, ratio)))
    tree = {"b": np.zeros(3), "a": np.zeros((2, 2)), "c": {"z": np.zeros(1)}}
    jg = JM.leaf_gates(jk, tree, 0.5)
    tg = TM.leaf_gates(tk, tree, 0.5)
    assert [float(x) for x in jax.tree_util.tree_leaves(jg)] == \
        [float(x) for x in pt.leaves(tg)]


def test_topk_mask_breaks_ties_to_the_lowest_index():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 3, (4, 40)).astype(np.float32)   # many ties
    scores[0] = 0.0                                           # all tied
    for k in (1, 5, 17, 40):
        got = TM.topk_mask(torch.from_numpy(scores), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(JM.topk_mask(jnp.asarray(scores), k)))
        assert (got.sum(axis=1) == k).all()
    assert TM.topk_mask(torch.zeros(1, 9), 3).numpy()[0].tolist() == [True] * 3 + [False] * 6


@pytest.mark.parametrize("policy", ["online", "pso", "psgf", "psgf_topk"])
def test_policy_gates_bitwise(policy):
    rng = np.random.default_rng(1)
    K, D = 7, 503
    g = rng.standard_normal(D).astype(np.float32)
    w = np.tile(g, (K, 1))
    w[2:] += rng.standard_normal((K - 2, D)).astype(np.float32)  # rows 0-1 tie
    sel = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    cfg = dict(policy=policy, num_clients=K)
    jp, tp = JP.from_config(JE.FLConfig(**cfg)), TP.from_config(TE.FLConfig(**cfg))
    assert tp.granularity == jp.granularity == "element"
    jk = jax.random.split(jax.random.PRNGKey(2), 3)
    tk = R.split(R.PRNGKey(2), 3)
    args_j = (jnp.asarray(g), jnp.asarray(w), jnp.asarray(sel))
    args_t = (torch.from_numpy(g), torch.from_numpy(w), torch.from_numpy(sel))
    down_j = jp.downlink_gates((jk[0], jk[1]), *args_j)
    down_t = tp.downlink_gates((tk[0], tk[1]), *args_t)
    up_j = jp.uplink_gates(jk[2], *args_j)
    up_t = tp.uplink_gates(tk[2], *args_t)
    for t, j in ((down_t, down_j), (up_t, up_j)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tp.train_mask(args_t[2]).numpy(),
                                  np.asarray(jp.train_mask(args_j[2])))


def test_fl_config_validation_matches_reference():
    for kw in (dict(comm_bits=12), dict(client_chunk=0),
               dict(participation=0), dict(participation=True),
               dict(participation=1.5), dict(participation=3, client_chunk=4),
               dict(participation=59)):
        with pytest.raises(ValueError):
            JE.FLConfig(**kw)
        with pytest.raises(ValueError):
            TE.FLConfig(**kw)
    for kw in (dict(participation=0.25), dict(participation=7), dict()):
        assert TE.FLConfig(**kw).participation_size() == \
            JE.FLConfig(**kw).participation_size()
