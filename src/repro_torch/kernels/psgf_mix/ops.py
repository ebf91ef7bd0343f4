"""Public wrappers of the psgf_mix kernel (counterpart of
``repro.kernels.psgf_mix.ops``): the FL downlink's fused masked mix and comm
count.

    mixed, count = psgf_mix_batch(w_global, w_clients, mask)  # (D,), (K, D), (K, D)
    mixed, count = psgf_mix(w_global, w_local, mask)          # all (D,)

  * CUDA tensors launch the hand-written kernel
    (``repro_torch/csrc/psgf_mix.cu``, built at first use): float32,
    contiguous, one device. Anything else RAISES — there is no fallback;
  * CPU tensors run the plain PyTorch version (:mod:`.ref`); ``meta``
    tensors (the dry run's, ``launch.dryrun``) get the kernel's outputs
    alone (``kernels._meta``), or under autograd the plain version;
  * DTensors run one of the above on each rank's shards when the rows or
    D are split (the count then a pending sum over those mesh dimensions);
    any other split is made whole first (``kernels._sharded``).

Replaces ``src/repro/kernels/psgf_mix/kernel.py::psgf_mix_batch_kernel``
(``pallas_call`` at kernel.py:76) and ``::psgf_mix_kernel`` (kernel.py:39);
``psgf_mix`` is the K = 1 case of the same launch. Bound: bytes, ``(3*K*D +
D) * 4`` per call (w and m read, the output written, g read once). Design:
one streaming pass over slices of the client rows, with a slice size chosen
from K so that the card fills (1,024 elements at K = 1, 4,096 at the
engine's K) and at most as many blocks as the card holds at once, 16-byte
accesses where the rows are aligned, the lerp rounded step by step
(bitwise equal to the plain version), and per-block float32 partial counts
that the last block to finish sums in index order into the count: one
launch per call, no float atomics (see the source's header).

The last block finds itself by a ticket counter: one zeroed 32-bit word per
stream, reset by every launch when it ends. The words of a device are one
block of :data:`TICKET_WORDS` allocated by the first call on that device,
and each stream takes the next free word at its first call, so calls on two
streams of one device may run at once (the shards of a local mesh do). A
CUDA graph holds the word of the stream it was captured on: it must not
replay at the same time as calls on that stream or another graph captured
there. Make the first call on a device outside any CUDA graph capture (the
block cannot be allocated during one); a stream's first call may be
captured.

``LAUNCHES`` counts the kernel launches of ``psgf_mix_batch`` and
``LAUNCHES_SINGLE`` those of ``psgf_mix`` (and nothing else), so a run can
show which wrapper its main path went through. A call made while the calling
thread's current stream is capturing a CUDA graph records a launch that
runs at each replay of the graph; it counts once there and also in this
thread's :func:`captured_calls`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, _meta, _sharded
from repro_torch.kernels.psgf_mix.ref import psgf_mix_batch_ref, psgf_mix_ref

LAUNCHES = 0
LAUNCHES_SINGLE = 0
_COUNT_LOCK = threading.Lock()
_CAPTURED = threading.local()
_FNS = None
TICKET_WORDS = 1024          # ticket counters (streams) a device may have
_TICKETS = {}                # device index -> zeroed int32 ticket words
_TICKET_SLOTS = {}           # (device index, stream handle) -> its word


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("psgf_mix")
        blocks, fwd = lib.psgf_mix_blocks, lib.psgf_mix_fwd
        blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
        blocks.restype = ctypes.c_int
        fwd.argtypes = ([ctypes.c_void_p] * 7
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        _FNS = (blocks, fwd)
    return _FNS


def _ticket_counter(device, stream: int) -> int:
    """The address of the ticket counter of ``stream`` (a CUDA stream
    handle) on ``device`` (see the module's docstring)."""
    key = (device.index, stream)
    with _COUNT_LOCK:
        words = _TICKETS.get(device.index)
        if words is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "psgf_mix: the first call on a device allocates its "
                    "ticket counters and cannot be captured in a CUDA "
                    "graph; call it once before capturing")
            words = torch.zeros(TICKET_WORDS, dtype=torch.int32,
                                device=device)
            _TICKETS[device.index] = words
        slot = _TICKET_SLOTS.get(key)
        if slot is None:
            slot = sum(1 for d, _ in _TICKET_SLOTS if d == device.index)
            if slot >= TICKET_WORDS:
                raise RuntimeError(f"psgf_mix: more than {TICKET_WORDS} "
                                   f"streams on {device}")
            _TICKET_SLOTS[key] = slot
    return words.data_ptr() + 4 * slot


def captured_calls() -> int:
    """This thread's calls of either wrapper made while its current stream
    was capturing a CUDA graph (each also counted once in :data:`LAUNCHES`
    or :data:`LAUNCHES_SINGLE`)."""
    return getattr(_CAPTURED, "calls", 0)


def _launch(w_global, w_clients, mask, single=False):
    """Checks, then one kernel launch on the current stream. ``w_clients``
    and ``mask`` are (K, D); returns (mixed (K, D), count 0-d float32).
    ``single`` counts the launch for ``psgf_mix`` rather than the batch."""
    global LAUNCHES, LAUNCHES_SINGLE
    tensors = (w_global, w_clients, mask)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("psgf_mix kernel takes float32 global, client and mask "
                        f"tensors; got {[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("psgf_mix kernel takes contiguous tensors")
    K, D = w_clients.shape
    out = torch.empty_like(w_clients)
    if K == 0 or D == 0:
        return out, torch.zeros((), dtype=torch.float32, device=out.device)
    blocks, fwd = _kernel_fns()
    count = torch.empty((), dtype=torch.float32, device=out.device)
    vector = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (*tensors, out)))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        counter = _ticket_counter(out.device, stream)
        partials = torch.empty(blocks(D, K), dtype=torch.float32,
                               device=out.device)
        err = fwd(w_global.data_ptr(), w_clients.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), partials.data_ptr(), count.data_ptr(),
                  counter, D, K, vector, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"psgf_mix kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        if single:
            LAUNCHES_SINGLE += 1
        else:
            LAUNCHES += 1
    if capturing:
        _CAPTURED.calls = captured_calls() + 1
    return out, count


def _dispatch(w_global, w_clients, mask, ref):
    """The plain version's result for CPU (or meta) tensors; None for CUDA
    tensors (the caller launches); raises for mixed or other devices."""
    devices = {w_global.device, w_clients.device, mask.device}
    if len(devices) != 1:
        raise ValueError(f"psgf_mix: tensors on different devices: {devices}")
    device = devices.pop()
    if device.type == "meta" and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (w_global, w_clients, mask))):
        # the dry run (launch.dryrun): the kernel's outputs alone
        # (kernels._meta); under autograd the plain version, which has one
        mixed, count = _meta.psgf_mix(w_global, w_clients.reshape(-1, w_global.shape[0]),
                                      mask.reshape(-1, w_global.shape[0]))
        return mixed.reshape(w_clients.shape), count
    if device.type in ("cpu", "meta"):
        return ref(w_global, w_clients, mask)
    if device.type != "cuda":
        raise ValueError(f"psgf_mix runs on CUDA, CPU or meta tensors, not {device}")
    return None


def psgf_mix_batch(w_global, w_clients, mask):
    """Client-batched fused mix + comm count (the FL engine's downlink).

    w_global: (D,); w_clients/mask: (K, D). Returns (mixed (K, D), count
    0-d float32 = sum over ALL clients' gates)."""
    if (w_global.dim() != 1 or w_clients.dim() != 2
            or tuple(mask.shape) != tuple(w_clients.shape)
            or w_clients.shape[1] != w_global.shape[0]):
        raise ValueError(f"psgf_mix_batch wants w_global (D,), w_clients and "
                         f"mask (K, D); got {tuple(w_global.shape)}, "
                         f"{tuple(w_clients.shape)}, {tuple(mask.shape)}")
    if _sharded.any_dtensor(w_global, w_clients, mask):
        return _mix_sharded(psgf_mix_batch, w_global, w_clients, mask)
    out = _dispatch(w_global, w_clients, mask, psgf_mix_batch_ref)
    return out if out is not None else _launch(w_global, w_clients, mask)


def psgf_mix(w_global, w_local, mask):
    """w_global/w_local/mask: (D,). Returns (mixed (D,), count 0-d float32)."""
    if not (w_global.dim() == 1 and tuple(w_local.shape) == tuple(w_global.shape)
            and tuple(mask.shape) == tuple(w_global.shape)):
        raise ValueError(f"psgf_mix wants three (D,) tensors; got "
                         f"{tuple(w_global.shape)}, {tuple(w_local.shape)}, "
                         f"{tuple(mask.shape)}")
    if _sharded.any_dtensor(w_global, w_local, mask):
        return _mix_sharded(psgf_mix, w_global, w_local, mask)
    out = _dispatch(w_global, w_local, mask, psgf_mix_ref)
    if out is not None:
        return out
    mixed, count = _launch(w_global, w_local[None, :], mask[None, :],
                           single=True)
    return mixed[0], count


def _mix_sharded(wrapper, w_global, w_rows, mask):
    """``wrapper`` (:func:`psgf_mix_batch` or :func:`psgf_mix`) over
    DTensors, on each rank's shards: per mesh dimension of ``w_rows``'s
    placements, a split of the rows (``psgf_mix_batch``'s K) or of D stays
    local (``w_global`` split alike along D, whole for rows, its gradient
    then a sum over the ranks), and the count becomes a pending sum there;
    anything else is made whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = _sharded.mesh_of(w_global, w_rows, mask)
    d_dim = w_rows.dim() - 1
    wpl = (w_rows.placements if isinstance(w_rows, DTensor)
           else (Replicate(),) * mesh.ndim)
    g, g_grad, w, c = [], [], [], []
    for i, p in enumerate(wpl):
        n = mesh.size(i)
        if d_dim == 1 and p.is_shard(0) and w_rows.shape[0] % n == 0:
            row = (Replicate(), Partial(), Shard(0), Partial())
        elif p.is_shard(d_dim) and w_rows.shape[d_dim] % n == 0:
            row = (Shard(0), Shard(0), Shard(d_dim), Partial())
        else:
            row = (Replicate(),) * 4
        for lst, pl in zip((g, g_grad, w, c), row):
            lst.append(pl)
    g, g_grad, w, c = map(tuple, (g, g_grad, w, c))
    return _sharded.run_local(wrapper, mesh, (w_global, w_rows, mask),
                              (g, w, w), (w, c), (g_grad, w, w))
