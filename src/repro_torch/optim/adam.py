"""Adam / SGD optimizers over dict trees of tensors (counterpart of
``repro.optim.adam``).

``Adam.init`` / ``Adam.update`` follow the reference's (m, v, t) formulation:
the global-norm gradient clip, bias correction, optional decoupled weight
decay, a schedule callable for the LR and a configurable moment dtype
(float32 by default; bfloat16 halves the optimizer's memory for the large
archs). ``update`` is functional, as the reference's. ``update_`` does the
same arithmetic in the same order into the given tensors, leaf by leaf and
in slices of at most :data:`SLICE` elements, so a full-width model never
holds an old and a new copy of its state at once: the trainers
(``launch.steps``, ``core.psgf_dp``) call it. Per element the two are
bitwise equal; only the slicing differs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.common import pytree_utils as pt
from repro_torch.kernels._sharded import is_dtensor

# elements per slice of an in-place update: a few float32 temporaries of
# 256 MB each, where qwen2-1.5b's largest leaf (28 x 1536 x 8960) is 1.5 GB
SLICE = 1 << 26


def _local(t):
    """A DTensor's local shard (a plain tensor as it is)."""
    return t.to_local() if is_dtensor(t) else t


def _flat_slices(*tensors):
    """Matching 1-D slices of equally shaped contiguous tensors (of their
    local shards for DTensors laid out alike)."""
    flats = [_local(t).view(-1) for t in tensors]
    n = flats[0].numel()
    for start in range(0, n, SLICE):
        yield [f[start:start + SLICE] for f in flats]


def _schedule_lr(lr_fn, t):
    lr = lr_fn(t)
    return lr.to(t.device) if isinstance(lr, torch.Tensor) else lr


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Callable = staticmethod(lambda step: 1e-3)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"
    grad_clip: Optional[float] = 1.0

    def init(self, params):
        md = getattr(torch, self.moment_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=md, device=p.device)  # noqa: E731
        device = pt.leaves(params)[0].device
        return {"m": pt.tree_map(zeros, params), "v": pt.tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def _clip_scale(self, grads):
        """``min(1, clip / max(|g|, 1e-9))`` over the global norm (leaf sums
        added in leaf order), or None without a clip."""
        if self.grad_clip is None:
            return None
        total = 0
        for g in pt.leaves(grads):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        gnorm = torch.sqrt(total)
        # the clip made on the device (no host copy, so a step captures in
        # a CUDA graph) and divided, as the reference divides: not the
        # reciprocal times the clip that ``float / tensor`` computes
        return torch.clamp(torch.full_like(gnorm, self.grad_clip)
                           / torch.clamp(gnorm, min=1e-9), max=1.0)

    def _bias_corrections(self, t):
        tf = t.to(torch.float32)
        return 1 - torch.pow(self.b1, tf), 1 - torch.pow(self.b2, tf)

    def _leaf(self, p, g, m, v, scale, bc, lr):
        """One leaf's (p, m, v) update in float32, as the reference's
        ``upd`` (``adam.py:51-60`` there); ``bc`` = ``(1 - b1**t, 1 -
        b2**t)``."""
        f32 = torch.float32
        gf = g.to(f32) if scale is None else g.to(f32) * scale
        m_new = self.b1 * m.to(f32) + (1 - self.b1) * gf
        v_new = self.b2 * v.to(f32) + (1 - self.b2) * torch.square(gf)
        mhat = m_new / bc[0]
        vhat = v_new / bc[1]
        step = mhat / (torch.sqrt(vhat) + self.eps)
        if self.weight_decay:
            step = step + self.weight_decay * p.to(f32)
        return p.to(f32) - lr * step, m_new, v_new

    def update(self, params, grads, state):
        """Functional step: ``(new_params, new_state)``."""
        t = state["t"] + 1
        scale = self._clip_scale(grads)
        lr = _schedule_lr(self.lr, t)
        bc = self._bias_corrections(t)
        md = getattr(torch, self.moment_dtype)
        out = pt.tree_map(lambda p, g, m, v: self._leaf(p, g, m, v, scale, bc, lr),
                          params, grads, state["m"], state["v"])
        is_out = lambda x: isinstance(x, tuple)  # noqa: E731
        return (pt.tree_map(lambda o, p: o[0].to(p.dtype), out, params,
                            is_leaf=is_out),
                {"m": pt.tree_map(lambda o: o[1].to(md), out, is_leaf=is_out),
                 "v": pt.tree_map(lambda o: o[2].to(md), out, is_leaf=is_out),
                 "t": t})

    @torch.no_grad()
    def update_(self, params, grads, state):
        """The same step written into ``params`` and ``state`` (``t`` too);
        returns them. DTensor params, moments and gradients laid out alike
        are updated shard by shard: only the clip's global norm needs their
        collectives; the scalars are replicated."""
        state["t"].add_(1)
        t = state["t"]
        scale = self._clip_scale(grads)
        lr = _schedule_lr(self.lr, t)
        bc = self._bias_corrections(t)
        scale, lr = (x if x is None or isinstance(x, float) else _local(x)
                     for x in (scale, lr))
        bc = tuple(_local(x) for x in bc)
        for p, g, m, v in zip(pt.leaves(params), pt.leaves(grads),
                              pt.leaves(state["m"]), pt.leaves(state["v"])):
            for ps, gs, ms, vs in _flat_slices(p, g.contiguous(), m, v):
                p_new, m_new, v_new = self._leaf(ps, gs, ms, vs, scale, bc, lr)
                ps.copy_(p_new)
                ms.copy_(m_new)
                vs.copy_(v_new)
        return params, state


@dataclasses.dataclass(frozen=True)
class Sgd:
    lr: Callable = staticmethod(lambda step: 1e-2)
    momentum: float = 0.0

    def init(self, params):
        device = pt.leaves(params)[0].device
        t = torch.zeros((), dtype=torch.int32, device=device)
        if self.momentum:
            return {"mu": pt.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                      params), "t": t}
        return {"t": t}

    def _leaf(self, p, g, mu, lr):
        f32 = torch.float32
        if not self.momentum:
            return (p.to(f32) - lr * g.to(f32)).to(p.dtype), None
        mu = self.momentum * mu + g.to(f32)
        return (p.to(f32) - lr * mu).to(p.dtype), mu

    def update(self, params, grads, state):
        t = state["t"] + 1
        lr = _schedule_lr(self.lr, t)
        mu = state["mu"] if self.momentum else pt.tree_map(lambda p: None, params)
        out = pt.tree_map(lambda p, g, b: self._leaf(p, g, b, lr), params, grads, mu)
        is_out = lambda x: isinstance(x, tuple)  # noqa: E731
        new_params = pt.tree_map(lambda o: o[0], out, is_leaf=is_out)
        if self.momentum:
            return new_params, {"mu": pt.tree_map(lambda o: o[1], out, is_leaf=is_out),
                                "t": t}
        return new_params, {"t": t}

    @torch.no_grad()
    def update_(self, params, grads, state):
        state["t"].add_(1)
        lr = _schedule_lr(self.lr, state["t"])
        mus = (pt.leaves(state["mu"]) if self.momentum
               else [None] * len(pt.leaves(params)))
        for p, g, mu in zip(pt.leaves(params), pt.leaves(grads), mus):
            p_new, mu_new = self._leaf(p, g, mu, lr)
            if mu is not None:
                mu.copy_(mu_new)
            p.copy_(p_new)
        return params, state
