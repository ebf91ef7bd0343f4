"""Public wrapper of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v)`` dispatches on where the tensors lie:

  * CUDA tensors launch the hand-written kernel
    (``repro_torch/csrc/flash_attention.cu``, built at first use) after the
    checks below; anything the kernel does not take RAISES — there is no
    fallback;
  * CPU tensors run the plain PyTorch version (:mod:`.ref`), the same
    function computed densely.

Differentiation is the reference's design (``ops.py:47-65`` there): a
``torch.autograd.Function`` whose forward is the kernel and whose backward is
autograd of the plain version on the saved ``(q, k, v)``. At the
forecaster's token counts (15-63) the dense backward recompute is cheap, and
the reference has no backward kernel either.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # gridDim.y (heads) and gridDim.z (batch)

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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


def _launch(q, k, v, causal, window, kv_len):
    """Checks, then one kernel launch on the current stream."""
    global LAUNCHES
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16, the "
                        f"same for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if B > _GRID_LIMIT or H > _GRID_LIMIT:
        raise ValueError(f"batch {B} or heads {H} above the grid limit {_GRID_LIMIT}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPE_CODES[q.dtype], B, Sq, Skv, H, KV, hd,
                 Skv if kv_len is None else int(kv_len), int(bool(causal)),
                 int(window is not None), 0 if window is None else int(window),
                 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, kv_len)
        return _launch(q, k, v, causal, window, kv_len)

    @staticmethod
    def backward(ctx, do):
        causal, window, kv_len = ctx.mask
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = flash_attention_ref(*inputs, causal=causal, window=window,
                                    kv_len=kv_len)
        dq, dk, dv = torch.autograd.grad(o, inputs, do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, kv_len=None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0
    -> (B, Sq, H, hd) in q.dtype.

    ``kv_len`` (default ``Skv``) masks keys at or past it; ``window`` keeps
    keys with ``k > q - window``; ``causal`` keeps ``k <= q``."""
    _check_shapes(q, k, v, kv_len)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    return _FlashAttention.apply(q, k, v, causal, window, kv_len)
