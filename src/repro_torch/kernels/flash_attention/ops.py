"""Public wrapper of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v)`` dispatches on where the tensors lie:

  * CUDA tensors launch one of three hand-written kernels after the checks
    below, chosen by :func:`kernel_route` from the dtype, head dim and
    shape: bfloat16 at hd 64 or 128 takes the tensor-core kernel
    (``repro_torch/csrc/flash_attention_tc.cu``: wgmma, TMA, one block per
    kv head's query group); short sequences at hd 8-32 (the forecaster's
    attention, :data:`SHORT_HEAD_DIMS` within :data:`SHORT_MAX_THREADS` and
    :data:`SHORT_SMEM_BUDGET`) the short kernel
    (``repro_torch/csrc/flash_attention_short.cu``: a block per batch row
    with its q, k and v slabs in shared memory, a thread or two lanes per
    (query, head), an exact two-pass softmax); every other case (long
    sequences, float32 at every head dim) the general kernel, whose route
    keeps its historical name ``"scalar"``
    (``repro_torch/csrc/flash_attention.cu``: 3xTF32 products on the tensor
    cores, a block per kv head's query group, a cp.async K/V ring). All are
    built at first use.
    Anything the kernels do not take RAISES — there is no fallback;
  * CPU tensors run the plain PyTorch version (:mod:`.ref`), the same
    function computed densely; ``meta`` tensors (the dry run's,
    ``launch.dryrun``) get the kernel's output alone under the kernel's
    autograd (``kernels._meta``: no score tensor, the plain version's
    FLOPs by formula), and nothing launches;
  * DTensors (a step over a mesh, ``launch.steps``) run one of the above on
    each rank's local shards when the batch, or the heads (q heads and kv
    heads alike, or one kv head for all), are what is sharded; a sharded
    sequence or head dim is first made whole, a counted collective
    (``kernels._sharded``).

Differentiation is the reference's design (``ops.py:47-65`` there): a
``torch.autograd.Function`` whose forward is the kernel and whose backward is
the plain version's gradient on the saved ``(q, k, v)``, written out in torch
ops (``ref.flash_attention_ref_backward``). At the forecaster's token counts
(15-63) the dense backward recompute is cheap, and the reference has no
backward kernel either. The Function is in ``setup_context`` form with a
``vmap`` rule, so ``torch.func.vmap(torch.func.grad(...))`` — the FL engine's
per-client LocalUpdate — runs through the kernel on the card.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel; ``ROUTE_LAUNCHES`` splits the
same count by route (it sums to ``LAUNCHES``). A call made while the calling
thread's current stream is capturing a CUDA graph records a launch that
runs at each replay of the graph; it counts once in ``LAUNCHES`` and also in
this thread's :func:`captured_calls`, so a run that captures beside other
threads' launches can tell its graphs' calls apart.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build, _meta, _sharded
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_ref_backward)

HEAD_DIMS = (8, 16, 32, 64, 128)
TENSOR_CORE_HEAD_DIMS = (64, 128)
# The short route's envelope (its source note says why): the head dims it
# is built for, the (query, head) pairs a block may hold at each (one
# thread each; the launch bounds that keep q, acc and the cached scores in
# registers), and the bytes of the q, k and v slabs it stages per block.
SHORT_HEAD_DIMS = (8, 16, 32)
SHORT_MAX_THREADS = {8: 1024, 16: 512, 32: 256}
SHORT_SMEM_BUDGET = 112 * 1024
ROUTES = ("scalar", "tensor_core", "short")
_LIBRARIES = {"scalar": "flash_attention", "tensor_core": "flash_attention_tc",
              "short": "flash_attention_short"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # gridDim.y (heads); the kernels stride over B

# The tensor-core route against the float32 plain version. It rounds P to
# bf16 before the P.V product (the tensor cores take bf16 operands; the
# scores, max, row sum and accumulator stay fp32) and the output to bf16
# once. An emulation of those numerics at hymba's mask (1, 2048, 5/1, 64),
# causal, window 1024, stayed within 2^-7 |want| + 2^-8 everywhere (worst
# ratio 0.41); its max abs error was 9.2e-3, against 7.3e-3 from rounding
# the output alone. 2^-7 relative is two bf16 roundings of the output;
# 2^-8 absolute covers the P rounding near 0, which averages over the keys.
FLASH_BF16_RTOL = 2.0 ** -7
FLASH_BF16_ATOL = 2.0 ** -8

LAUNCHES = 0
ROUTE_LAUNCHES = {route: 0 for route in ROUTES}
_COUNT_LOCK = threading.Lock()
_CAPTURED = threading.local()
_FNS = {}


def _kernel_fn(route):
    fn = _FNS.get(route)
    if fn is None:
        lib = _LIBRARIES[route]
        fn = getattr(_build.load(lib), f"{lib}_fwd")
        # the scalar and short kernels take a dtype code after the pointers
        ints = 9 if route == "tensor_core" else 10
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[route] = fn
    return fn


def _in_short_envelope(dtype, hd, q_shape, kv_shape) -> bool:
    _, Sq, H, _ = q_shape
    _, Skv, KV, _ = kv_shape
    staged = (Sq * H + 2 * Skv * KV) * hd * (4 if dtype == torch.float32 else 2)
    return (hd in SHORT_HEAD_DIMS and Sq * H <= SHORT_MAX_THREADS[hd]
            and staged <= SHORT_SMEM_BUDGET)


def kernel_route(dtype, hd, q_shape=None, kv_shape=None) -> str:
    """Which kernel a CUDA call launches: ``"tensor_core"`` for bfloat16 at
    hd 64 or 128; ``"short"`` when ``q_shape`` (B, Sq, H, hd) and
    ``kv_shape`` (B, Skv, KV, hd) are given and fall inside the short
    kernel's envelope (hd in :data:`SHORT_HEAD_DIMS`, ``Sq * H`` at most
    :data:`SHORT_MAX_THREADS` ``[hd]``, the staged slabs ``(Sq * H + 2 *
    Skv * KV) * hd`` elements within :data:`SHORT_SMEM_BUDGET` bytes);
    ``"scalar"`` for every other case the kernels take. Without shapes it
    answers for a shape outside the short envelope. Raises ``TypeError``
    for another dtype and ``ValueError`` for a head dim outside
    :data:`HEAD_DIMS`."""
    if dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if (q_shape is None) != (kv_shape is None):
        raise ValueError("kernel_route takes both q_shape and kv_shape, or "
                         "neither")
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    if q_shape is not None and _in_short_envelope(dtype, hd, q_shape, kv_shape):
        return "short"
    return "scalar"


def captured_calls() -> int:
    """This thread's calls made while its current stream was capturing a
    CUDA graph (each also counted once in :data:`LAUNCHES`)."""
    return getattr(_CAPTURED, "calls", 0)


def reset_launch_counts():
    """Set :data:`LAUNCHES` and every :data:`ROUTE_LAUNCHES` count to 0."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0
        for route in ROUTES:
            ROUTE_LAUNCHES[route] = 0


def _check_shapes(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,Sq,H,hd), k/v (B,Skv,KV,hd);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {KV}")
    if kv_len is not None and not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")


def _launch(q, k, v, causal, window, kv_len, route=None):
    """Checks, then one kernel launch on the current stream. ``route``
    (default: :func:`kernel_route`'s choice) may also be ``"scalar"``, which
    takes every call, so the scalar kernel can be timed against the others
    on their inputs."""
    global LAUNCHES
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "meta":
        # the dry run (launch.dryrun): the kernel's output alone, its cost
        # by formula (kernels._meta), under the kernel's autograd (its
        # saved tensors and plain backward); nothing launches
        return _meta.flash_attention(q, k, v, bool(causal),
                                     None if window is None else int(window),
                                     None if kv_len is None else int(kv_len))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16, the "
                        f"same for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    chosen = kernel_route(q.dtype, hd, tuple(q.shape), tuple(k.shape))
    if route not in (None, "scalar", chosen):
        raise ValueError(f"the {route} flash-attention kernel does not take "
                         f"{q.dtype} q {tuple(q.shape)}, k {tuple(k.shape)}")
    route = route or chosen
    if H > _GRID_LIMIT:
        raise ValueError(f"heads {H} above the grid limit {_GRID_LIMIT}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # TMA and the 16-byte loads and copies of every route take 16-byte
    # aligned bases; a view at an odd offset is copied to a fresh allocation
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _kernel_fn(route)
    mask = (Skv if kv_len is None else int(kv_len), int(bool(causal)),
            int(window is not None), 0 if window is None else int(window),
            1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if route == "tensor_core":
            err = fn(*ptrs, B, Sq, Skv, H, KV, hd, *mask, stream)
        else:
            err = fn(*ptrs, _DTYPE_CODES[q.dtype], B, Sq, Skv, H, KV, hd, *mask,
                     stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        ROUTE_LAUNCHES[route] += 1
    if capturing:
        _CAPTURED.calls = captured_calls() + 1
    return o


class _FlashAttention(torch.autograd.Function):
    """The kernel under autograd and ``torch.func``: forward launches the
    kernel; backward is :func:`flash_attention_ref_backward` on the saved
    ``(q, k, v)`` (torch ops, so ``grad`` and ``vmap`` run through it);
    ``vmap`` folds the mapped dimension into the batch and launches once."""

    @staticmethod
    def forward(q, k, v, causal, window, kv_len):
        return _launch(q, k, v, causal, window, kv_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, kv_len = inputs
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, kv_len)

    @staticmethod
    def backward(ctx, do):
        causal, window, kv_len = ctx.mask
        dq, dk, dv = flash_attention_ref_backward(
            *ctx.saved_tensors, do, causal=causal, window=window, kv_len=kv_len)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, kv_len):
        n = info.batch_size

        def fold(x, dim):
            x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        o = _FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                  fold(v, in_dims[2]), causal, window, kv_len)
        return o.reshape(n, -1, *o.shape[1:]), 0


def flash_attention(q, k, v, *, causal=True, window=None, kv_len=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0
    -> (B, Sq, H, hd) in q.dtype.

    ``kv_len`` (default ``Skv``) masks keys at or past it; ``window`` keeps
    keys with ``k > q - window``; ``causal`` keeps ``k <= q``."""
    _check_shapes(q, k, v, kv_len)
    if _sharded.any_dtensor(q, k, v):
        return _flash_attention_sharded(q, k, v, causal, window, kv_len)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta tensors, not {q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, kv_len)


def _flash_attention_sharded(q, k, v, causal, window, kv_len):
    """:func:`flash_attention` over DTensors, on each rank's shards
    (``_sharded.attention_layouts``: a batch split, or a head split with
    the kv heads split alike or one kv head for all, stays local; any
    other split is made whole first)."""
    def local(ql, kl, vl):
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               kv_len=kv_len)

    return _sharded.attention_local(local, q, k, v)
