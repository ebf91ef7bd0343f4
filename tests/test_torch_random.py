"""The port's threefry (``repro_torch.random``) against ``jax.random``, bit
for bit: keys, split/fold_in chains, raw bits, uniform, randint and
permutation, single keys and batches of keys (``jax.vmap`` over keys), plus
the stochastic int8 ``quantize_tree`` that draws from it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import quantize_tree as jax_quantize_tree  # noqa: E402
from repro.core import forecast as JF  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.checkpoint import quantize_tree  # noqa: E402
from repro_torch.core import forecast as TF  # noqa: E402
from repro_torch.models import spec as S  # noqa: E402
from repro_torch.common import pytree_utils as pt  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (65_537,), (2, 3, 4)]


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + [2 ** 40 + 3])
def test_keys_and_split_fold_in_chains(seed):
    jk = jax.random.PRNGKey(seed) if seed < 2 ** 32 else None
    tk = R.PRNGKey(seed)
    if jk is None:   # a 64-bit seed: the high and low words
        assert tk.tolist() == [seed >> 32, seed & 0xFFFFFFFF]
        return
    _same(_u32(jk), tk)
    for step in range(4):     # split -> fold_in -> split(5) chain
        jk, jsub = jax.random.split(jk)
        tk, tsub = R.split(tk).unbind(0)
        _same(_u32(jsub), tsub)
        jk = jax.random.fold_in(jk, 8 + step)
        tk = R.fold_in(tk, 8 + step)
        _same(_u32(jk), tk)
    _same(_u32(jax.random.split(jk, 5)), R.split(tk, 5))
    _same(_u32(jax.random.split(jk, (2, 3))), R.split(tk, (2, 3)))
    # fold_in of a tensor of data = vmap of fold_in over it
    idx = jnp.arange(1, 6)
    _same(_u32(jax.vmap(lambda i: jax.random.fold_in(jk, i))(idx)),
          R.fold_in(tk, torch.arange(1, 6)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    _same(_u32(jax.random.bits(jk, shape)), R.bits(tk, shape))
    u = R.uniform(tk, shape)
    assert u.dtype == torch.float32 and float(u.min()) >= 0 and float(u.max()) < 1
    _same(jax.random.uniform(jk, shape), u)
    for lo, hi in ((0, 97), (0, 1), (-5, 2 ** 31 - 1), (3, 3), (0, 70_001)):
        _same(jax.random.randint(jk, shape, lo, hi), R.randint(tk, shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 10, 58, 1_001, 1_626, 70_001])
def test_permutation(seed, n):
    """One sort round up to n = 1625, two above (ceil(3 ln n / ln 2^32))."""
    got = R.permutation(R.PRNGKey(seed), n)
    _same(jax.random.permutation(jax.random.PRNGKey(seed), n), got)
    assert sorted(got.tolist()) == list(range(n))


def test_batched_keys_equal_vmap():
    jks = jax.random.split(jax.random.PRNGKey(11), 6)
    tks = R.split(R.PRNGKey(11), 6)
    _same(jax.vmap(lambda k: jax.random.uniform(k, (33,)))(jks), R.uniform(tks, 33))
    _same(jax.vmap(lambda k: jax.random.randint(k, (9,), 0, 50))(jks),
          R.randint(tks, 9, 0, 50))
    _same(jax.vmap(lambda k: jax.random.permutation(k, 2_000))(jks),
          R.permutation(tks, 2_000))
    _same(_u32(jax.vmap(lambda k: jax.random.split(k, 3))(jks)), R.split(tks, 3))
    _same(_u32(jax.vmap(lambda k: jax.random.fold_in(k, 7))(jks)),
          R.fold_in(tks, 7))
    # (K, steps) batches, as LocalUpdate draws its minibatch indices
    jss = jax.vmap(lambda k: jax.random.split(k, 4))(jks)
    tss = R.split(tks, 4)
    _same(jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 40)))(jss),
          R.randint(tss, 5, 0, 40))


def test_normal_and_spec_init_match_reference():
    """Uniform draws are bitwise; ``erfinv`` is torch's, within a few ulps
    of XLA's, so normal draws and a fresh spec init agree to 1e-5 relative."""
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (20_000,)))
    tn = R.normal(R.PRNGKey(5), (20_000,)).numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=1e-6)
    cfg = dict(look_back=32, horizon=2, d_model=16, num_heads=2, d_ff=16,
               patch_len=8, stride=4)
    jp = JF.init_params(JF.logtst_config(**cfg), jax.random.PRNGKey(7))
    tp = S.init_params_from_key(TF.model_spec(TF.logtst_config(**cfg)),
                                R.PRNGKey(7), torch.device("cpu"))
    pairs = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [("/".join(str(k.key) for k in p)) for p, _ in pairs] == \
        [p for p, _ in pt.flatten_with_paths(tp)]
    for (_, a), b in zip(pairs, pt.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("start", [0, 5])
def test_narrow_uniform_and_normal(seed, start):
    """16-bit draws: uniform bitwise in bf16 (8 random bits a value) and
    float16 (16); normal bitwise in bf16, where erfinv's float32 ulps vanish
    in the rounding, and in float16 within 2**-8 (a float16 ulp at the
    largest draws, |x| in [4, 8))."""
    key, n = jax.random.PRNGKey(seed), 70_001
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)):
        ju = np.asarray(jax.random.uniform(key, (start + n,), jdt), np.float32)
        tu = R.uniform(R.PRNGKey(seed), (n,), start, dtype=tdt)
        assert tu.dtype == tdt
        np.testing.assert_array_equal(tu.float().numpy(), ju[start:])
        jn = np.asarray(jax.random.normal(key, (start + n,), jdt), np.float32)
        tn = R.normal(R.PRNGKey(seed), (n,), start, dtype=tdt).float().numpy()
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(tn, jn[start:])
        else:
            np.testing.assert_allclose(tn, jn[start:], rtol=0, atol=2.0 ** -8)


@pytest.mark.parametrize("seed", [0, 3])
def test_stochastic_int8_quantize_tree_bitwise(seed):
    rng = np.random.default_rng(seed)
    tree = {"b": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                  "zero": np.zeros(3, np.float32),
                  "n": np.arange(4, dtype=np.int32)},
            "a": (rng.standard_normal(1_001) * 3).astype(np.float32)}
    want = jax_quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), 8,
                             key=jax.random.PRNGKey(seed))
    got = quantize_tree(pt.tree_map(torch.from_numpy, tree), 8,
                        key=R.PRNGKey(seed))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            pt.leaves(got)):
        _same(np.asarray(w), g.numpy())
    # stochastic differs from round-to-nearest somewhere, and is unbiased-ish
    nearest = quantize_tree(pt.tree_map(torch.from_numpy, tree), 8)
    assert not torch.equal(nearest["a"], got["a"])
