"""One FL round of the port's engine against the JAX package's
``repro.core.fl.engine.fl_round``, on the CPU.

Both packages get the same keys (the port's threefry is bit-exact), the same
numpy-made warm-start params and the same numpy windows. Bitwise: comm
counters, round and Adam step counters, ``num_selected``. Within
``FL_PARITY_TOL``: states and the loss (float32 gradients summed in other
orders; see the constant's note, which also says why the attention key bias
``attn/bk`` is left out of state comparisons). N-round runs are in
``test_torch_fl_run.py``, masks and policies in ``test_torch_masks.py``,
``run_experiment`` in ``test_torch_clustering.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fl import engine as JE  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from torch_fl_utils import (JCFG, TCFG, TOL, configs, make_data,  # noqa: E402
                            numpy_params, same_state)
from repro_torch.kernels.psgf_mix import ops as mix_ops  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return make_data()


ROUND_CASES = {
    "psgf_fused_mix": dict(policy="psgf", use_pallas_mix=True),
    "psgf_bf16_streaming_chunked": dict(policy="psgf", comm_bits=16,
                                        streaming_windows=True, client_chunk=4),
    "online_int8_participation": dict(policy="online", comm_bits=8,
                                      participation=4, streaming_windows=True),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_fl_round_matches_reference(case, data):
    """Held against ``repro.core.fl.engine.fl_round``."""
    kw = ROUND_CASES[case]
    tr, _ = data[kw.get("streaming_windows", False)]
    jfl, tfl = configs(tr.shape[0], **kw)
    jparams, tparams = numpy_params()
    jstate, jmeta = JE.init_fl_state(JCFG, jfl, jax.random.PRNGKey(0),
                                     init_params=jparams)
    tstate, tmeta = TE.init_fl_state(TCFG, tfl, R.PRNGKey(0),
                                     init_params=tparams, device="cpu")
    assert tmeta.sizes == jmeta.sizes and tmeta.total == jmeta.total
    same_state(jstate, tstate, tmeta)
    before = {k: v.clone() for k, v in tstate.items()}
    mix_ops.LAUNCHES = 0
    jnew, jmet = JE.fl_round(jstate, jnp.asarray(tr), jax.random.PRNGKey(3),
                             JCFG, jfl, jmeta)
    tnew, tmet = TE.fl_round(tstate, tr, R.PRNGKey(3), TCFG, tfl, tmeta,
                             device="cpu")
    assert mix_ops.LAUNCHES == 0       # the CPU path runs the plain version
    assert all(torch.equal(before[k], tstate[k]) for k in tstate)  # untouched
    same_state(jnew, tnew, tmeta)
    assert set(tmet) == set(jmet)
    for name in tmet:
        if name == "train_loss":
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                       rtol=TOL, atol=TOL)
        else:
            assert float(tmet[name]) == float(jmet[name]), name
