"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
port of `repro.models.rglru`).

r_t = sigmoid(W_a x_t); i_t = sigmoid(W_x x_t)
a_t = a^(c * r_t)  with  a = sigmoid(Lambda)  (per-channel)
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Sequence mode runs a log-depth scan in plain torch (`_lru_scan`), or with
``use_kernel`` the RG-LRU scan kernel (`kernels.rglru.ops.rglru_scan`),
which computes the same recurrence: the CUDA kernel on the card, its plain
version on the CPU.  The block wraps the LRU with the Griffin
recurrent-block structure: linear -> (branch x | branch gate), causal
conv1d on x, RG-LRU, gated output projection.

A cache, when given, is updated in place: the block copies the new conv
window and last hidden state into the cache's own tensors and returns
that same dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..configs.base import RGLRUConfig
from ..kernels.rglru import ops as rglru_ops
from .layers import Dense, dense, truncated_normal
from .ssm import _causal_conv, _silu, _softplus


class RGLRU(nn.Module):
    """`rglru_init`: the x and gate projections, the depthwise conv, the
    recurrence gates `w_a`, `w_x`, the fp32 `lam` and the output
    projection."""

    def __init__(self, d_model: int, rcfg: RGLRUConfig, dtype, device=None):
        super().__init__()
        r = rcfg.d_rnn or d_model
        self.in_x = Dense(d_model, r, dtype, device=device)
        self.in_gate = Dense(d_model, r, dtype, device=device)
        self.conv_w = nn.Parameter(torch.empty(rcfg.d_conv, r, dtype=dtype,
                                               device=device))
        self.conv_b = nn.Parameter(torch.zeros(r, dtype=dtype,
                                               device=device))
        self.w_a = Dense(r, r, dtype, device=device)
        self.w_x = Dense(r, r, dtype, device=device)
        self.lam = nn.Parameter(torch.empty(r, dtype=torch.float32,
                                            device=device))
        self.out = Dense(r, d_model, dtype, device=device)

    def reset(self, generator):
        """The reference's draws for the weights that are not `Dense`: a
        truncated-normal conv of std 1/sqrt(d_conv), zero conv bias, and
        Lambda such that sigmoid(Lambda) spans [0.9, 0.999]."""
        K = self.conv_w.shape[0]
        self.conv_w.copy_(truncated_normal(generator, self.conv_w.shape,
                                           self.conv_w.dtype,
                                           1.0 / math.sqrt(K)))
        self.conv_b.zero_()
        a = np.linspace(0.9, 0.999, self.lam.shape[0])
        self.lam.copy_(torch.from_numpy(np.log(a / (1 - a))
                                        .astype(np.float32)))


def _gelu_tanh(x):
    """The tanh approximation of GELU as `jax.nn.gelu` computes it (its
    default), every step and constant in x's dtype (in bf16 this equals
    the reference bit for bit)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def _fold(a, b, h0):
    """b with the initial state folded into its first step."""
    if h0 is None:
        return b
    return torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)


def _lru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t by log-depth doubling (Hillis-Steele).
    a, b: [B, S, R]; h0: [B, R] or None (zero)."""
    b = _fold(a, b, h0)
    S = a.shape[1]
    d = 1
    while d < S:
        # step t composes (a, b)_{t-d} then (a, b)_t
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_core(p: RGLRU, x, rcfg: RGLRUConfig, h0=None,
               use_kernel: bool = False):
    """x: [B, S, R] (post-conv).  Returns h: [B, S, R] in fp32."""
    r = torch.sigmoid(dense(p.w_a, x).float())
    i = torch.sigmoid(dense(p.w_x, x).float())
    log_a = -rcfg.c * _softplus(-p.lam) * r     # log(a^(c r)), a = sig(lam)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * x.float())
    if use_kernel:
        return rglru_ops.rglru_scan(a, _fold(a, gated, h0))
    return _lru_scan(a, gated, h0)


def rglru_apply(p: RGLRU, x, rcfg: RGLRUConfig, cache=None,
                use_kernel: bool = False):
    """Full Griffin recurrent block.  cache: dict(conv, h), updated in
    place and returned.  `use_kernel` runs the scan through
    `rglru_ops.rglru_scan`."""
    xb = dense(p.in_x, x)
    gate = dense(p.in_gate, x)
    xc, new_conv = _causal_conv(xb, p.conv_w, p.conv_b,
                                None if cache is None else cache["conv"])
    xc = _silu(xc)
    h = rglru_core(p, xc, rcfg, None if cache is None else cache["h"],
                   use_kernel)
    y = h.to(x.dtype) * _gelu_tanh(gate)
    out = dense(p.out, y)
    if cache is None:
        return out, None
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(h[:, -1])
    return out, cache


def rglru_cache_init(batch, d_model, rcfg: RGLRUConfig, dtype, device=None,
                     lead=()):
    """A zeroed cache (conv window in the model dtype, fp32 h), with `lead`
    axes in front (the stacked groups)."""
    r = rcfg.d_rnn or d_model
    return {
        "conv": torch.zeros((*lead, batch, rcfg.d_conv - 1, r), dtype=dtype,
                            device=device),
        "h": torch.zeros((*lead, batch, r), dtype=torch.float32,
                         device=device),
    }
