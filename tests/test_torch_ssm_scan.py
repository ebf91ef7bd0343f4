"""The ssm_scan wrapper's CPU path (its plain version) against the JAX
package: its Pallas kernel in interpret mode, its jnp oracle, and the final
state its decoder's prefill derives by a second scan. Plus the wrapper's
checks.

The port computes in the TPU kernel's arithmetic (x, dt, B, C cast to
float32 first). The reference's oracle (``ref.py:15``) forms ``dt*x`` in the
input type before the cast, which differs in bfloat16: the reference's own
test holds its kernel against that oracle at 5e-2 there
(``tests/test_kernels.py:270``), and so does this file (ROADMAP Queue C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_scan_ref  # noqa: E402
from repro.models import decoder as JD  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

# float32, same arithmetic on both sides but sums of h*C in other orders
F32_TOL = 1e-5
# bfloat16 against the JAX kernel: both compute in float32 and round y once
# to bf16, so a float32-level difference can flip that rounding: one bf16
# ulp (2^-8 relative, 2^-7 to be safe at either side) plus F32_TOL
BF16_RTOL = 2.0 ** -7
# bfloat16 against the reference's oracle, which rounds dt*x to bf16 first:
# the reference's own tolerance for its kernel against it
ORACLE_BF16_TOL = 5e-2

# the reference's SSM_CASES (tests/test_kernels.py:251): B, S, D, N, dtype
SSM_CASES = [
    (2, 64, 128, 16, "float32"),
    (1, 200, 300, 8, "float32"),
    (3, 128, 256, 16, "bfloat16"),
    (1, 37, 64, 4, "float32"),
]


def _inputs(seed, B, S, D, N, dtype):
    """numpy float32 draws, rounded to ``dtype`` once, then the same values
    on both sides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(0.1 * rng.standard_normal((D, N))).astype(np.float32)
    jd = jnp.dtype(dtype)
    jx = [jnp.asarray(a).astype(jd) for a in (x, dt, Bm, Cm)] + [jnp.asarray(A)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in jx[:4]] + [torch.from_numpy(A)]
    return jx, tx


@pytest.mark.parametrize("case", SSM_CASES)
def test_plain_version_matches_jax_kernel(case):
    B, S, D, N, dtype = case
    jx, tx = _inputs(B * S + N, B, S, D, N, dtype)
    want = np.asarray(jax_ssm_scan(*jx, chunk=32, d_block=128, interpret=True),
                      np.float32)
    got = ops.ssm_scan(*tx)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == (B, S, D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("case", SSM_CASES)
def test_plain_version_matches_jax_oracle(case):
    B, S, D, N, dtype = case
    jx, tx = _inputs(B * S + N + 1, B, S, D, N, dtype)
    want = np.asarray(jax_ssm_scan_ref(*jx), np.float32)
    got = ops.ssm_scan(*tx).float().numpy()
    tol = ORACLE_BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_final_state_matches_reference_prefill_scan():
    """``ssm_apply(return_state=True)`` (the kernel's final h and the last
    K-1 inputs) against ``decoder._ssm_final_state``, the reference's second
    scan, on hymba's reduced SSM layer in float32."""
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="float32")
    rng = np.random.default_rng(3)
    spec = TL.ssm_spec(tcfg)
    p = {k: (0.5 * rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
             ).astype(np.float32) for k, s in spec.items()}
    h = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p_, h_: JD._ssm_final_state(p_, h_, jcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
    _, got = TL.ssm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(h), tcfg, return_state=True)
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == tuple(want[name].shape)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)


def test_return_state_is_the_last_step_of_the_scan():
    _, tx = _inputs(9, 2, 33, 40, 8, "float32")
    y, h = ops.ssm_scan(*tx, return_state=True)
    assert torch.equal(y, ops.ssm_scan(*tx))
    # one more step by hand from h gives the next y of a longer scan
    x, dt, Bm, Cm, A = tx
    y_all = ssm_scan_ref(*(torch.cat([t, t[:, :1]], dim=1) for t in tx[:4]), A)
    h1 = torch.exp(dt[:, 0, :, None] * A) * h + (dt[:, 0] * x[:, 0])[..., None] * Bm[:, 0, None, :]
    torch.testing.assert_close(y_all[:, -1], (h1 * Cm[:, 0, None, :]).sum(-1),
                               atol=F32_TOL, rtol=F32_TOL)


def test_wrapper_checks():
    _, (x, dt, Bm, Cm, A) = _inputs(0, 1, 8, 16, 4, "float32")
    with pytest.raises(ValueError, match="shapes do not match"):
        ops.ssm_scan(x, dt[:, :4], Bm, Cm, A)
    with pytest.raises(ValueError, match="shapes do not match"):
        ops.ssm_scan(x, dt, Bm, Cm, A[:8])
    with pytest.raises(ValueError, match="wants"):
        ops.ssm_scan(x[0], dt, Bm, Cm, A)
    # meta tensors (the dry run's) run the plain version on shapes alone
    before = ops.LAUNCHES
    y, h = ops.ssm_scan(*(t.to("meta") for t in (x, dt, Bm, Cm, A)),
                        return_state=True)
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    assert h.is_meta and h.shape == (1, 16, 4) and ops.LAUNCHES == before
    with pytest.raises(ValueError, match="different devices"):
        ops.ssm_scan(x, dt, Bm, Cm, A.to("meta"))
    # the kernel's own checks, which raise before anything reaches the card
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._launch(x.half(), dt.half(), Bm.half(), Cm.half(), A, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._launch(x, dt.to(torch.bfloat16), Bm, Cm, A, False)
    with pytest.raises(TypeError, match="float32 A"):
        ops._launch(x, dt, Bm, Cm, A.double(), False)
    with pytest.raises(ValueError, match="contiguous"):
        ops._launch(x.transpose(1, 2).contiguous().transpose(1, 2), dt, Bm,
                    Cm, A, False)
    # inputs that require grad differentiate through the plain version here
    y_grad = ops.ssm_scan(x.clone().requires_grad_(), dt, Bm, Cm, A)
    assert y_grad.grad_fn is not None
    _, t5 = _inputs(0, 1, 8, 16, 5, "float32")
    with pytest.raises(ValueError, match="state dim 5"):
        ops._launch(*t5, False)
    before = ops.LAUNCHES
    ops.ssm_scan(x, dt, Bm, Cm, A)            # CPU: the plain version
    assert ops.LAUNCHES == before


# the backward against autograd of the plain version: the same float32
# products, summed over n, d or the batch in other orders
GRAD_TOL = 1e-5


@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_matches_autograd(case, with_state):
    """``ssm_scan_ref_backward`` (the CUDA kernel's backward) against
    autograd through ``ssm_scan_ref``, for the output's cotangent and, where
    the final state is an output too, the state's."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref_backward

    _, tx = _inputs(5, *case)
    ins = [t.clone().requires_grad_() for t in tx]
    y, h = ssm_scan_ref(*ins, return_state=True)
    gen = torch.Generator().manual_seed(1)
    dy = torch.randn(y.shape, generator=gen).to(y.dtype)
    dh = torch.randn(h.shape, generator=gen) if with_state else None
    outs, cots = ([y, h], [dy, dh]) if with_state else ([y], [dy])
    want = torch.autograd.grad(outs, ins, cots)
    got = ssm_scan_ref_backward(*tx, dy, dh)
    for name, g, w, t in zip(("x", "dt", "Bm", "Cm", "A"), got, want, tx):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=BF16_RTOL, atol=BF16_RTOL, err_msg=name)
        else:
            scale = max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL * scale, err_msg=name)


def test_plain_backward_matches_jax_oracle_grad():
    """The float32 gradients against ``jax.grad`` of the reference's oracle."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref_backward

    jx, tx = _inputs(6, 2, 64, 128, 16, "float32")
    dy = np.random.default_rng(2).standard_normal((2, 64, 128)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_ssm_scan_ref(*a) * dy),
                    argnums=(0, 1, 2, 3, 4))(*jx)
    got = ssm_scan_ref_backward(*tx, torch.from_numpy(dy))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, float(np.abs(w).max())))
