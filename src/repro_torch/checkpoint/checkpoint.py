"""Flat-file checkpointing of tensor trees (npz payload + json manifest).

Counterpart of ``repro.checkpoint.checkpoint`` with the same on-disk format,
so either package restores the other's checkpoints:
``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json``, npz keys are the
joined tree paths (``params/blocks/b2/attn/wq``), manifest dtypes are numpy
names (``float32``, ``bfloat16``). bfloat16 leaves are stored as 2-byte void
records, which is how npz stores JAX's bfloat16 arrays too.

Writes are ATOMIC per file (same-directory tmp file + ``os.replace``) and
ordered payload-first, manifest-last: ``manifest.json`` marks a step
complete, so a reader that sees a manifest can load its payload, and a
crashed or concurrent writer leaves at worst a manifest-less directory that
:func:`latest_step` skips.
"""
from __future__ import annotations

import io
import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt

_BF16_RECORD = np.dtype("V2")


def atomic_write_bytes(path: str, data: bytes):
    """Write ``data`` to ``path`` through a same-directory tmp file +
    ``os.replace``: a concurrent reader sees either the old complete file or
    the new complete file, never a partial write."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, indent: int = 1):
    atomic_write_bytes(path, json.dumps(obj, indent=indent).encode())


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.float32`` -> ``"float32"``)."""
    return str(dtype).split(".")[-1]


def tensor_to_numpy(t) -> np.ndarray:
    """Host copy of a tensor; bfloat16 becomes 2-byte void records (the
    npz layout of JAX's bfloat16)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """Tensor copy of an array; 2-byte void records (npz's bfloat16, also
    ``ml_dtypes.bfloat16`` arrays) are read back as bfloat16 bits without
    needing ``ml_dtypes``."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"unsupported record dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Serialize a tree of tensors. Returns the step directory.

    Both files land via tmp + ``os.replace``, payload before manifest."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "keys": [], "extra": extra or {}}
    for key, leaf in pt.flatten_with_paths(tree):
        leaf = torch.as_tensor(leaf)
        arrays[key] = tensor_to_numpy(leaf)
        manifest["keys"].append({"key": key, "dtype": dtype_name(leaf.dtype),
                                 "shape": list(leaf.shape)})
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(os.path.join(step_dir, "arrays.npz"), buf.getvalue())
    atomic_write_json(os.path.join(step_dir, "manifest.json"), manifest)
    return step_dir


def int8_roundtrip(f: torch.Tensor, noise=None, batch_dims: int = 0):
    """int8 wire round-trip of float32 ``f`` with one symmetric absmax scale
    (``max|f| / 127``) per leading ``batch_dims`` index: round half to even
    (``noise=None``) or stochastic ``floor(f / scale + noise)`` with
    ``noise`` uniform on [0, 1); clip to [-127, 127]; dequantize as
    ``int8 * scale``. An all-zero slice keeps scale 1 and payload 0."""
    flat = f.reshape(f.shape[:batch_dims] + (-1,))
    scale = (flat.abs().amax(dim=-1) / 127.0).reshape(
        f.shape[:batch_dims] + (1,) * (f.dim() - batch_dims))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q_f = torch.round(f / safe) if noise is None else torch.floor(f / safe + noise)
    ints = torch.clamp(q_f, -127, 127).to(torch.int8)
    return ints.to(torch.float32) * safe


def quantize_tree(tree, bits: int = 32, *, where: str = "quantize_tree",
                  key=None):
    """Wire-format payload quantization (``FLConfig.comm_bits``):
    ``bits=16`` round-trips every float leaf through bfloat16, ``bits=8``
    through int8 with a per-leaf fp32 scale (:func:`int8_roundtrip`),
    ``bits=32`` is the identity. Integer and bool leaves pass through.

    ``key=None`` rounds half to even (restore paths: serving must rebuild
    the same params every time). A key (``repro_torch.random``) selects
    stochastic int8 rounding, the training wire's: leaf ``i`` in leaf order
    adds ``uniform(fold_in(key, i), leaf.shape)`` before the floor. Both are
    bitwise equal to the reference's ``quantize_tree``.
    """
    if bits == 32:
        return tree
    if bits not in (8, 16):
        raise ValueError(
            f"{where}: unsupported payload width: {bits} bits "
            f"(choose 8, 16 or 32)")
    def q(i, leaf):
        if not torch.is_floating_point(leaf):
            return leaf
        if bits == 16:
            return leaf.to(torch.bfloat16).to(leaf.dtype)
        noise = None
        if key is not None:
            noise = R.uniform(R.fold_in(key.to(leaf.device), i), leaf.shape)
        return int8_roundtrip(leaf.to(torch.float32), noise).to(leaf.dtype)

    return pt.tree_map_indexed(q, tree)


def load_checkpoint(ckpt_dir: str, template, step: int | None = None,
                    device="cpu"):
    """Restore into the structure (and dtypes) of ``template`` — tensors or
    ``meta`` tensors — on ``device``. Returns ``(tree, extra)``."""
    step, manifest = read_manifest(ckpt_dir, step)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    pairs = []
    with np.load(os.path.join(step_dir, "arrays.npz")) as payload:
        for key, leaf in pt.flatten_with_paths(template):
            t = tensor_from_numpy(payload[key])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}"
                                 f" != template {tuple(leaf.shape)}")
            pairs.append((key, t.to(device=device, dtype=leaf.dtype)))
    return pt.unflatten(pairs), manifest["extra"]


def read_manifest(ckpt_dir: str, step: int | None = None):
    """Read a step's manifest without touching the payload. Returns
    ``(step, manifest)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return step, json.load(f)


def latest_step(ckpt_dir: str):
    """Largest COMPLETE step in ``ckpt_dir`` (or None).

    Non-step entries (``step_final``, stray files), non-numeric suffixes and
    partially-written step directories (payload without manifest) are
    SKIPPED, not raised on."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        step_dir = os.path.join(ckpt_dir, name)
        if not os.path.isdir(step_dir):
            continue
        if not (os.path.exists(os.path.join(step_dir, "manifest.json"))
                and os.path.exists(os.path.join(step_dir, "arrays.npz"))):
            continue  # torn/in-progress write: manifest lands last
        steps.append(int(m.group(1)))
    return max(steps) if steps else None
