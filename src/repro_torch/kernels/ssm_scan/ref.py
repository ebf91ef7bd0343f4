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
against it on the card.
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
