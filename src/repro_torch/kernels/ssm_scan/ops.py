"""Public wrapper of the ssm_scan kernel (counterpart of
``repro.kernels.ssm_scan.ops``): the Mamba-style selective scan of hymba's
SSM heads.

    y = ssm_scan(x, dt, Bm, Cm, A)                        # (B, S, D)
    y, h = ssm_scan(x, dt, Bm, Cm, A, return_state=True)  # h (B, D, N) fp32

  * CUDA tensors launch the hand-written kernel
    (``repro_torch/csrc/ssm_scan.cu``, built at first use): x, dt, Bm, Cm
    float32 or bfloat16 (one type), A float32, contiguous, one device, N in
    :data:`STATE_DIMS`. Anything else RAISES — there is no fallback;
  * CPU tensors run the plain PyTorch version (:mod:`.ref`); ``meta``
    tensors (the dry run's, ``launch.dryrun``) get the kernel's output and
    state alone under the kernel's autograd (``kernels._meta``: no
    per-position temporaries, the exponentials by formula), and nothing
    launches.

Unlike the reference's wrapper there is no ``chunk`` or ``d_block``: the
kernel walks S and D as they are (ragged edges by loop bounds), so nothing
is padded, and the reference's ``test_ssm_scan_chunk_invariance`` shows the
two only tiled the TPU's work.

Replaces ``src/repro/kernels/ssm_scan/kernel.py::ssm_scan_kernel``
(``pallas_call`` at kernel.py:73). Bound: the B*S*D*N exponentials on the
special-function units (see the source's header).

Differentiation follows flash attention's design (``flash_attention/ops.py``):
a ``torch.autograd.Function`` whose forward is the kernel and whose backward
is the plain version's gradient, recomputed from the saved inputs
(``ref.ssm_scan_ref_backward``, a reverse scan in torch ops). The reference
has no ssm VJP kernel and trains hymba through ``lax.scan``
(``models/layers.py:723-737`` there), so there is no backward kernel here
either.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, _meta, _sharded
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref, ssm_scan_ref_backward

STATE_DIMS = (4, 8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # gridDim.y (batch)

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssm_scan").ssm_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check_shapes(x, dt, Bm, Cm, A):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan wants x, dt (B,S,D), Bm, Cm (B,S,N), A (D,N);"
                         f" got x {tuple(x.shape)}, A {tuple(A.shape)}")
    batch, S, D = x.shape
    N = A.shape[1]
    if (tuple(dt.shape) != (batch, S, D) or tuple(Bm.shape) != (batch, S, N)
            or tuple(Cm.shape) != (batch, S, N) or A.shape[0] != D):
        raise ValueError(
            f"ssm_scan shapes do not match: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
            f"A {tuple(A.shape)}")


def _launch(x, dt, Bm, Cm, A, return_state):
    """Checks, then one kernel launch on the current stream."""
    global LAUNCHES
    if x.device.type == "meta":
        # the dry run (launch.dryrun): the kernel's output and state alone,
        # its cost by formula (kernels._meta), under the kernel's autograd;
        # nothing launches
        out = _meta.ssm_scan(x, dt, Bm, Cm, A, bool(return_state))
        return tuple(out) if return_state else out[0]
    tensors = (x, dt, Bm, Cm, A)
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError("ssm_scan kernel takes float32 or bfloat16 x, dt, Bm, Cm "
                        f"of one type; got {[str(t.dtype) for t in tensors[:4]]}")
    if A.dtype != torch.float32:
        raise TypeError(f"ssm_scan kernel takes a float32 A; got {A.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan kernel takes contiguous tensors")
    batch, S, D = x.shape
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not supported by the kernel "
                         f"(supported: {STATE_DIMS})")
    if batch > _GRID_LIMIT:
        raise ValueError(f"batch {batch} above the grid limit {_GRID_LIMIT}")
    y = torch.empty_like(x)
    h = (torch.zeros(batch, D, N, dtype=torch.float32, device=x.device)
         if return_state else None)
    if y.numel() == 0:
        return (y, h) if return_state else y
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                 _DTYPE_CODES[x.dtype], batch, S, D, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return (y, h) if return_state else y


class _SsmScan(torch.autograd.Function):
    """The kernel under autograd: forward launches the kernel; backward is
    :func:`ssm_scan_ref_backward` on the saved inputs."""

    @staticmethod
    def forward(x, dt, Bm, Cm, A, return_state):
        return _launch(x, dt, Bm, Cm, A, return_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.return_state = inputs[5]

    @staticmethod
    def backward(ctx, dy, dh=None):
        grads = ssm_scan_ref_backward(*ctx.saved_tensors, dy,
                                      dh if ctx.return_state else None)
        return (*grads, None)


def ssm_scan(x, dt, Bm, Cm, A, *, return_state=False):
    """x, dt: (B, S, D); Bm, Cm: (B, S, N); A: (D, N) -> y (B, S, D) in
    x.dtype; with ``return_state`` also the final state h (B, D, N) float32
    (zeros for S = 0)."""
    _check_shapes(x, dt, Bm, Cm, A)
    if _sharded.any_dtensor(x, dt, Bm, Cm, A):
        return _ssm_scan_sharded(x, dt, Bm, Cm, A, return_state)
    devices = {t.device for t in (x, dt, Bm, Cm, A)}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan: tensors on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return ssm_scan_ref(x, dt, Bm, Cm, A, return_state=return_state)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm_scan runs on CUDA, CPU or meta tensors, not {device}")
    return _SsmScan.apply(x, dt, Bm, Cm, A, return_state)


def _ssm_scan_sharded(x, dt, Bm, Cm, A, return_state):
    """:func:`ssm_scan` over DTensors, on each rank's shards (the
    wrapper's own dispatch inside): per mesh dimension of ``x``'s
    placements, a batch split stays local (dt, Bm, Cm split alike, A
    whole), and so does a channel split (dt and A's rows alike, Bm and Cm
    whole); a sequence split is made whole first (``kernels._sharded``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = _sharded.mesh_of(x, dt, Bm, Cm, A)
    Bsz, _, D = x.shape
    xpl = x.placements if isinstance(x, DTensor) else (Replicate(),) * mesh.ndim
    xd, bc, a, y, h, bc_grad, a_grad = [], [], [], [], [], [], []
    for i, p in enumerate(xpl):
        n = mesh.size(i)
        # a whole input used by every rank's part gets a summed gradient
        if p.is_shard(0) and Bsz % n == 0:
            row = (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0),
                   Shard(0), Partial())
        elif p.is_shard(2) and D % n == 0:
            row = (Shard(2), Replicate(), Shard(0), Shard(2), Shard(1),
                   Partial(), Shard(0))
        else:
            row = (Replicate(),) * 7
        for lst, pl in zip((xd, bc, a, y, h, bc_grad, a_grad), row):
            lst.append(pl)
    xd, bc, a, y, h, bc_grad, a_grad = map(tuple, (xd, bc, a, y, h, bc_grad,
                                                   a_grad))

    def local(xl, dtl, bl, cl, al):
        return ssm_scan(xl, dtl, bl, cl, al, return_state=return_state)

    return _sharded.run_local(local, mesh, (x, dt, Bm, Cm, A),
                              (xd, xd, bc, bc, a), (y, h) if return_state else y,
                              (xd, xd, bc_grad, bc_grad, a_grad))
