"""Plain PyTorch versions of the SSD scan kernels (port of
`repro.kernels.ssd_scan.ref`): `ssd_ref`, the sequential step-by-step
recurrence, independent of any chunking, and `ssd_chunk_ref`, the
tensor-core kernel's chunked decomposition with its operand roundings.

`ops.ssd_scan` runs `ssd_ref` for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernels to it.  Nothing on the card's path
calls either."""
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


def _bf16(t):
    """`t` rounded to bf16 (round to nearest even), held in fp32."""
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    """`t` as a bf16 high part and a bf16 low part, t ~ hi + lo."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=64, rounding=False):
    """The decomposition of the tensor-core kernel (csrc/ssd_scan_wgmma.cu),
    in plain PyTorch: chunks of `chunk` steps in order, a [P, N] fp32
    state carried between them, and in each chunk, with
    cum_i = sum_{k<=i} -A dt_k and L its last step,

      W_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j       for j <= i, else 0
      y_i   = exp(cum_i) C_i . S_in + sum_j W_ij x_j
      S_out = exp(cum_L) S_in + sum_j v_j B_j^T,  v_j = exp(cum_L - cum_j) dt_j x_j.

    Steps past S count as dt = 0 (they change nothing) and give no y.
    With `rounding`, the operands enter the products as the kernel's bf16
    tensor-core products take them: W rounded to bf16, and S_in and v each
    as a bf16 high part plus a bf16 low part (two products); x, B and C
    are bf16 inputs already.  All sums in fp32.  Used by the tests and
    `chip_smoke.py` only; `ssd_ref` stays the oracle the kernel is held
    to.  Returns y [B, S, H, P] in x's dtype and the final state
    [B, H, P, N] fp32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = int(chunk)
    f32 = torch.float32
    pad = (-S) % L
    xf = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.to(f32), (0, 0, 0, pad))
    Bf, Cf = (torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad))
              for t in (Bm, Cm))
    A = A.to(f32)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    s = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t0 in range(0, S + pad, L):
        xc, dc = xf[:, t0:t0 + L], dtf[:, t0:t0 + L]       # [B,L,H,P], [B,L,H]
        bc, cc = Bf[:, t0:t0 + L], Cf[:, t0:t0 + L]         # [B,L,N]
        cum = torch.cumsum(-A * dc, dim=1)                  # [B,L,H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # [B,i,j,H]
        # mask before exp: above the diagonal seg is large and positive
        att = torch.exp(torch.where(causal[None, :, :, None], seg, -1e30))
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        w = cb[..., None] * att * dc[:, None, :, :]
        if rounding:
            w = _bf16(w)
            parts = _hi_lo(s)
        else:
            parts = (s,)
        inter = sum(torch.einsum("bin,bhpn->bihp", cc, part)
                    for part in parts)
        y = torch.exp(cum)[..., None] * inter \
            + torch.einsum("bijh,bjhp->bihp", w, xc)
        v = (torch.exp(cum[:, -1:] - cum) * dc)[..., None] * xc  # [B,L,H,P]
        parts = _hi_lo(v) if rounding else (v,)
        s = torch.exp(cum[:, -1])[..., None, None] * s + sum(
            torch.einsum("bjhp,bjn->bhpn", part, bc) for part in parts)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), s
