"""Plain PyTorch version of the flash-attention kernel (port of
`repro.kernels.flash_attention.ref`): materialized fp32 scores, fp32
softmax, GQA by explicit repeat.  Deliberately independent of the chunked
online-softmax implementation in `models/layers.py`.

`ops.flash_attention` runs it for CPU tensors; the tests and
`chip_smoke.py` hold the CUDA kernel to it.  Nothing on the card's path
calls it."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, causal=True, window=None, scale=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] -> [B, Sq, H, hd] in q's
    dtype.  The window applies only to causal attention, as in the
    kernel.  `scale` multiplies q.k, 1/sqrt(hd) by default (another value
    holds the kernels' zero-padded head dims)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    groups = H // KV
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)
