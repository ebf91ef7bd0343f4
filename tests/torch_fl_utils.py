"""Shared pieces of the FL parity tests (``test_torch_fl*.py``): a tiny
LoGTST in both packages, numpy-made params, six stations' windows in both
layouts, and the state comparison (``FL_PARITY_TOL``, without the
``attn/bk`` leaf: see the constant's note)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import forecast as JF
from repro.core.fl import engine as JE
from repro.data.synthetic import ev_synthetic
from repro.data.windowing import client_datasets, client_series_datasets
from repro_torch.common import pytree_utils as pt
from repro_torch.core import forecast as TF
from repro_torch.core.fl import engine as TE
from repro_torch.core.forecaster import params_from_numpy
from repro_torch.models.spec import is_spec

TOL = TE.FL_PARITY_TOL
TINY = dict(look_back=16, horizon=2, d_model=8, num_heads=2, d_ff=16,
            patch_len=8, stride=4)
JCFG, TCFG = JF.logtst_config(**TINY), TF.logtst_config(**TINY)
COUNTERS = ("comm_down", "comm_up", "comm_scales", "round", "adam_t")


def numpy_params(seed=0):
    rng = np.random.default_rng(seed)

    def draw(s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "scaled":
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else s.shape[0]
            return z / np.float32(np.sqrt(fan_in))
        return z * np.float32(0.02) + np.float32(s.init == "ones")

    tree = pt.tree_map(draw, TF.model_spec(TCFG), is_leaf=is_spec)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def make_data():
    series = ev_synthetic(seed=0, num_clients=6, num_days=120)
    mat = client_datasets(series, TINY["look_back"], TINY["horizon"])
    raw = client_series_datasets(series, TINY["look_back"], TINY["horizon"])
    return {False: (mat[0], mat[2]), True: (raw[0], raw[2])}


def same_state(jstate, tstate, meta):
    assert set(jstate) == set(tstate)
    keep = TE.bk_free(meta).numpy()
    for name, j in jstate.items():
        j, t = np.asarray(j), tstate[name].cpu().numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, name
        if name in COUNTERS:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t[..., keep], j[..., keep], atol=TOL,
                                       rtol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# one round, N rounds, one experiment
# ---------------------------------------------------------------------------



def configs(K, **kw):
    kw = dict(num_clients=K, batch_size=8, local_steps=2, **kw)
    return JE.FLConfig(**kw), TE.FLConfig(**kw)
