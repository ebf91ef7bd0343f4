"""The psgf_mix wrapper's CPU path (its plain version) against the JAX
package's kernel in interpret mode and its jnp oracle, for 0/1 and
non-binary float masks and ragged D. Plus the wrapper's shape checks and the
engine's dispatch of the fused downlink.

What is bitwise: the mix against the reference's oracle (``ref.py``, eager
jnp: ``m*g``, ``1-m``, ``(1-m)*w`` and the sum each rounded once, as the
port's plain version and CUDA kernel round them) for every mask; against the
reference's kernel for 0/1 masks. Under ``jit`` the reference's kernel
contracts ``m*g + (1-m)*w`` into one FMA on the CPU (measured: 24% of
elements differ from its own oracle for uniform masks), so for non-binary
masks the two agree to one rounding of ``m*g`` (``FMA_TOL``). The count is
bitwise for 0/1 and quarter masks (exact float32 sums in any order), and to
float32 rounding for arbitrary float masks (sums in another order)."""
import numpy as np
import pytest

# one rounding of m*g, |m*g| < 5 at these inputs: under 2^-21
FMA_TOL = 1e-6

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fl import engine as JE  # noqa: E402
from repro.kernels.psgf_mix import ops as jops  # noqa: E402
from repro.kernels.psgf_mix import ref as jref  # noqa: E402
from repro_torch.core.fl import engine as TE  # noqa: E402
from repro_torch.kernels.psgf_mix import ops  # noqa: E402
from repro_torch.kernels.psgf_mix.ref import psgf_mix_batch_ref  # noqa: E402


def _masks(rng, kind, shape):
    if kind == "binary":
        return (rng.random(shape) < 0.3).astype(np.float32)
    if kind == "quarters":
        return rng.integers(0, 5, shape).astype(np.float32) / np.float32(4)
    return rng.random(shape).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["binary", "quarters", "uniform"])
@pytest.mark.parametrize("K,D", [(3, 1_001), (2, 4_096), (5, 2_052), (1, 7)])
def test_batch_cpu_path_matches_jax_kernel(kind, K, D):
    rng = np.random.default_rng(K * D)
    g = rng.standard_normal(D).astype(np.float32)
    w = rng.standard_normal((K, D)).astype(np.float32)
    m = _masks(rng, kind, (K, D))
    mixed, count = ops.psgf_mix_batch(torch.from_numpy(g), torch.from_numpy(w),
                                      torch.from_numpy(m))
    assert ops.LAUNCHES == 0          # CPU tensors never launch the kernel
    jmixed, jcount = jops.psgf_mix_batch(jnp.asarray(g), jnp.asarray(w),
                                         jnp.asarray(m), interpret=True)
    omixed, ocount = jref.psgf_mix_batch_ref(jnp.asarray(g), jnp.asarray(w),
                                             jnp.asarray(m))
    assert mixed.shape == (K, D) and count.dtype == torch.float32
    np.testing.assert_array_equal(_bits(mixed.numpy()), _bits(omixed))
    if kind == "binary":
        np.testing.assert_array_equal(_bits(mixed.numpy()), _bits(jmixed))
    else:
        np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed),
                                   atol=FMA_TOL, rtol=0)
    if kind == "uniform":
        np.testing.assert_allclose(float(count), float(jcount), rtol=1e-6)
    else:
        assert float(count) == float(jcount) == float(ocount)


@pytest.mark.parametrize("kind", ["binary", "uniform"])
@pytest.mark.parametrize("D", [1, 1_001, 4_096])
def test_single_vector_cpu_path_matches_jax_kernel(kind, D):
    rng = np.random.default_rng(D)
    g, w = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    m = _masks(rng, kind, (D,))
    mixed, count = ops.psgf_mix(*(torch.from_numpy(a) for a in (g, w, m)))
    assert ops.LAUNCHES_SINGLE == 0   # CPU tensors never launch the kernel
    jmixed, jcount = jops.psgf_mix(jnp.asarray(g), jnp.asarray(w),
                                   jnp.asarray(m), interpret=True)
    omixed, _ = jref.psgf_mix_ref(jnp.asarray(g), jnp.asarray(w), jnp.asarray(m))
    np.testing.assert_array_equal(_bits(mixed.numpy()), _bits(omixed))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed), atol=FMA_TOL,
                               rtol=0)
    if kind == "binary":
        np.testing.assert_array_equal(_bits(mixed.numpy()), _bits(jmixed))
    np.testing.assert_allclose(float(count), float(jcount), rtol=1e-6)
    # bool masks are cast as the reference casts them
    b = m > 0.5
    mixed_b, count_b = ops.psgf_mix(torch.from_numpy(g), torch.from_numpy(w),
                                    torch.from_numpy(b))
    jb = jops.psgf_mix(jnp.asarray(g), jnp.asarray(w), jnp.asarray(b),
                       interpret=True)
    np.testing.assert_array_equal(_bits(mixed_b.numpy()), _bits(jb[0]))
    assert float(count_b) == float(jb[1]) == float(b.sum())


def test_wrapper_rejects_bad_shapes():
    g, w = torch.zeros(5), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="psgf_mix_batch wants"):
        ops.psgf_mix_batch(g, w, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="psgf_mix_batch wants"):
        ops.psgf_mix_batch(torch.zeros(4), w, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="psgf_mix wants"):
        ops.psgf_mix(g, torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="different devices"):
        ops.psgf_mix_batch(g, w.to("meta"), w)
    # meta tensors (the dry run's) run the plain version on shapes alone
    out, count = ops.psgf_mix_batch(g.to("meta"), w.to("meta"), w.to("meta"))
    assert out.is_meta and out.shape == w.shape and count.is_meta


def test_engine_fused_downlink_equals_two_pass_and_reference():
    """``mix_down_count(use_pallas=True)`` on an eligible (K, D) f32 leaf is
    bitwise the two-pass ``mix_down`` + ``gate_count``, and equals the
    reference's fused downlink; ineligible calls take the two-pass path."""
    rng = np.random.default_rng(9)
    K, D = 4, 1_003
    g = rng.standard_normal(D).astype(np.float32)
    w = rng.standard_normal((K, D)).astype(np.float32)
    m = (rng.random((K, D)) < 0.25).astype(np.float32)
    tg, tw, tm = (torch.from_numpy(a) for a in (g, w, m))
    fused = TE.mix_down_count(tw, tg, tm, use_pallas=True)
    two = TE.mix_down_count(tw, tg, tm, use_pallas=False)
    assert torch.equal(fused[0], two[0]) and torch.equal(fused[1], two[1])
    assert torch.equal(fused[0], psgf_mix_batch_ref(tg, tw, tm)[0])
    jm, jc = JE.mix_down_count(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                               use_pallas=True, interpret=True)
    np.testing.assert_array_equal(_bits(fused[0].numpy()), _bits(jm))
    assert float(fused[1]) == float(jc) == float(m.sum())
    # a dict tree of one leaf is eligible too; a float64 leaf is not
    tree = TE.mix_down_count({"w": tw}, {"w": tg}, {"w": tm}, use_pallas=True)
    assert torch.equal(tree[0]["w"], fused[0])
    d64 = TE.mix_down_count(tw.double(), tg.double(), tm.double(),
                            use_pallas=True)
    assert d64[0].dtype == torch.float64 and float(d64[1]) == float(m.sum())
