"""Plain PyTorch version of the ssm_scan kernel: a time loop over the
``(B, D, N)`` state in the TPU kernel's arithmetic
(``repro/kernels/ssm_scan/kernel.py:38-51``): x, dt, B and C cast to
float32 first, then ``h = exp(dt*A) * h + (dt*x) * B`` and ``y = sum_n h*C``,
the output in x's type.

The reference's own oracle (``repro/kernels/ssm_scan/ref.py:15``) and its
``ssm_apply`` scan (``models/layers.py:723``) form ``dt*x`` in the input type
before the cast, which differs in bfloat16; the port follows the kernel
(ROADMAP Queue C). With ``return_state=True`` it also returns the final
state, which the decoder's prefill hands to decode (the reference derives
it by a second scan, ``decoder._ssm_final_state``).

The wrapper (``ops.ssm_scan``) runs this for CPU tensors, the tests hold it
against the JAX package, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card. :func:`ssm_scan_ref_backward` is the kernel's
backward: this function's gradients, written out as a reverse scan.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(x, dt, Bm, Cm, A, *, return_state=False):
    """x, dt: (B, S, D); Bm, Cm: (B, S, N); A: (D, N). Returns y (B, S, D)
    in x.dtype, and with ``return_state`` also the final h (B, D, N)
    float32."""
    f32 = torch.float32
    xf, dtf, Bf, Cf, Af = (t.to(f32) for t in (x, dt, Bm, Cm, A))
    batch, S, D = x.shape
    h = torch.zeros(batch, D, A.shape[1], dtype=f32, device=x.device)
    ys = torch.empty(batch, S, D, dtype=f32, device=x.device)
    dbx = dtf * xf
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + dbx[:, t, :, None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    y = ys.to(x.dtype)
    return (y, h) if return_state else y


def ssm_scan_ref_backward(x, dt, Bm, Cm, A, dy, dh=None):
    """Gradients ``(dx, ddt, dBm, dCm, dA)`` of :func:`ssm_scan_ref` for the
    cotangents ``dy`` (B, S, D) of ``y`` and, where the final state is an
    output, ``dh`` (B, D, N) of ``h``; each in its input's type.

    The forward's states ``h_t`` are recomputed from the saved inputs; then a
    reverse scan carries ``g_t = dL/dh_t = dh + sum_{u >= t} (prod_{t < s <= u}
    a_s) dy_u C_u``, ``a_t = exp(dt_t A)``, and the rest follows elementwise:
    ``dC_t = sum_d dy_t h_t``, ``d(dt x)_t = sum_n g_t B_t``, ``dB_t = sum_d
    g_t (dt x)_t``, ``e_t = g_t h_{t-1} a_t`` (the gradient of ``dt_t A``),
    ``ddt_t = sum_n e_t A + d(dt x)_t x_t``, ``dx_t = d(dt x)_t dt_t``,
    ``dA = sum_{b,t} e_t dt_t``. Written in torch ops, so autograd and
    ``torch.func`` run through it; it holds ``(B, S, D, N)`` float32 states
    and gradients."""
    f32 = torch.float32
    xf, dtf, Bf, Cf, Af = (t.to(f32) for t in (x, dt, Bm, Cm, A))
    dyf = dy.to(f32)
    batch, S, D = x.shape
    N = A.shape[1]
    dbx = dtf * xf
    a = torch.exp(dtf[..., None] * Af)                        # (B, S, D, N)
    hs = torch.empty(batch, S, D, N, dtype=f32, device=x.device)
    h = torch.zeros(batch, D, N, dtype=f32, device=x.device)
    for t in range(S):
        h = a[:, t] * h + dbx[:, t, :, None] * Bf[:, t, None, :]
        hs[:, t] = h
    gs = torch.empty_like(hs)
    g = (torch.zeros(batch, D, N, dtype=f32, device=x.device) if dh is None
         else dh.to(f32))
    for t in range(S - 1, -1, -1):
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]
        gs[:, t] = g
        g = g * a[:, t]
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    e = gs * h_prev * a
    d_dbx = torch.einsum("bsdn,bsn->bsd", gs, Bf)
    dB = torch.einsum("bsdn,bsd->bsn", gs, dbx)
    dC = torch.einsum("bsd,bsdn->bsn", dyf, hs)
    ddt = torch.einsum("bsdn,dn->bsd", e, Af) + d_dbx * xf
    dA = torch.einsum("bsdn,bsd->dn", e, dtf)
    return ((d_dbx * dtf).to(x.dtype), ddt.to(dt.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dA.to(A.dtype))
