"""Plain PyTorch version of the RG-LRU scan kernel (port of
`repro.kernels.rglru.ref`): the sequential recurrence.

`ops.rglru_scan` runs it for CPU tensors; the tests and `chip_smoke.py`
hold the CUDA kernel to it.  Nothing on the card's path calls it."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t, h_{-1} = 0.  a, b: [B, S, R] fp32 -> h
    [B, S, R] fp32.

    Each step rounds a_t h + b_t once, a fused multiply-add, as the
    reference's compiled scan does (rounding the product and the sum apart
    drifts past the 1e-5 bar over 2,048 steps of a constant a = 0.999): the
    product and the sum are formed in float64, where the product is exact,
    and rounded to float32."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t].double() * h.double() + b[:, t].double()).to(a.dtype)
        out[:, t] = h
    return out
