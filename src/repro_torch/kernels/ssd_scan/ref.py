"""Plain PyTorch version of the SSD scan kernel (port of
`repro.kernels.ssd_scan.ref`): the sequential step-by-step recurrence,
independent of any chunking.

`ops.ssd_scan` runs it for CPU tensors; the tests and `chip_smoke.py`
hold the CUDA kernel to it.  Nothing on the card's path calls it."""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bm, Cm):
    """x: [B, S, H, P]; dt: [B, S, H]; A: [H]; Bm/Cm: [B, S, N].

    s_t = exp(-A dt_t) s_{t-1} + dt_t * (x_t outer B_t);  y_t = C_t . s_t

    Returns y [B, S, H, P] in x's dtype and the final state [B, H, P, N]
    in fp32, all arithmetic in fp32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    xf, dt, A, Bm, Cm = (t.to(f32) for t in (x, dt, A, Bm, Cm))
    s = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    y = torch.empty((B, S, H, P), dtype=f32, device=x.device)
    for t in range(S):
        a = torch.exp(-A[None, :] * dt[:, t])                    # [B, H]
        upd = dt[:, t, :, None, None] * (xf[:, t, :, :, None]
                                         * Bm[:, t, None, None, :])
        s = s * a[:, :, None, None] + upd
        y[:, t] = torch.einsum("bn,bhpn->bhp", Cm[:, t], s)
    return y.to(x.dtype), s
