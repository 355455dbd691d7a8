"""Mixture-of-Experts FFN with sort-free capacity dispatch (port of
`repro.models.moe`).

Tokens are routed to per-expert capacity buffers by a cumulative-position
scatter; the experts run as batched products over the stacked expert
weights (`torch.bmm`, as the reference leaves its einsums to XLA);
results are gathered back and combined with the top-k gates.  Pairs
over an expert's capacity are dropped: they go to an extra row ``E`` of
the buffer, which is thrown away, so every shape stays static.

Where the port could diverge from the reference, it does what the
reference does:

- capacity ``C = max(ceil(T*K*cf/E), min(T*K, 16))`` in host integer math;
- positions are a cumsum over the (token, slot) pairs in token-major
  order, so the same pairs are dropped;
- the top-k breaks ties as `jax.lax.top_k` does, the lower expert index
  first (a stable descending sort; `torch.topk` promises no order);
- int8 dispatch writes each kept slot once (a scatter-set: a kept slot
  has exactly one writer, so it equals the reference's scatter-add), and
  its rounding and integer cast pass no gradient, as in the reference;
  the per-token scales do, in both.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MoEConfig
from . import layers as L


class MoE(nn.Module):
    """The router ``[D, E]`` (fp32), the stacked experts ``wi``, ``wg``
    ``[E, D, F]`` and ``wo`` ``[E, F, D]`` (model dtype), and an optional
    shared SwiGLU of width ``num_shared * F`` (`moe_init`)."""

    def __init__(self, d_model: int, mcfg: MoEConfig, dtype, device=None):
        super().__init__()
        E, Fe = mcfg.num_experts, mcfg.d_expert

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))
        self.router = empty(d_model, E, dt=torch.float32)
        self.wi = empty(E, d_model, Fe)
        self.wg = empty(E, d_model, Fe)
        self.wo = empty(E, Fe, d_model)
        self.shared = (L.SwiGLU(d_model, mcfg.num_shared * Fe, dtype,
                                device=device) if mcfg.num_shared else None)

    def reset(self, generator):
        """Truncated normal weights: the router and ``wi``, ``wg`` of std
        1/sqrt(D), ``wo`` of std 1/sqrt(F); the shared SwiGLU's `Dense`
        layers reset themselves."""
        d, Fe = self.wi.shape[1], self.wi.shape[2]
        for p, scale in ((self.router, d ** -0.5), (self.wi, d ** -0.5),
                         (self.wg, d ** -0.5), (self.wo, Fe ** -0.5)):
            p.copy_(L.truncated_normal(generator, p.shape, p.dtype, scale))


def capacity(tokens: int, mcfg: MoEConfig) -> int:
    """Slots per expert; the floor keeps tiny (decode) batches drop-free."""
    pairs = tokens * mcfg.top_k
    return max(int(math.ceil(pairs * mcfg.capacity_factor
                             / mcfg.num_experts)), min(pairs, 16))


def top_k(probs, k):
    """(values, indices) of the k largest entries of the last dim, ties
    to the lower index, as `jax.lax.top_k`."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, xt, mcfg: MoEConfig):
    """Router of `moe_apply` for tokens xt [T, D]: (gates [T, K] fp32,
    expert ids [T, K], each pair's slot in its expert [T*K], kept [T*K],
    aux loss)."""
    T = xt.shape[0]
    E, K = mcfg.num_experts, mcfg.top_k
    probs = torch.softmax(xt.float() @ p.router, dim=-1)          # [T, E]
    gates, eidx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(-1)                                     # [T*K]
    # expert-major, so that the count runs along the last dim (on CUDA an
    # outer-dim cumsum walks its T*K rows one after another)
    onehot = F.one_hot(flat_e, E).t().contiguous()                # [E, T*K]

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    pe = probs.mean(dim=0)
    fe = onehot.sum(dim=1).float() / (T * K)
    aux = E * torch.sum(fe * pe) * mcfg.router_aux_weight

    pos = torch.cumsum(onehot, dim=1) - 1
    pos = pos.gather(0, flat_e[None, :])[0]
    return gates, eidx, pos, pos < capacity(T, mcfg), aux


def _quantize(x, dim=-1):
    """Symmetric int8 with one scale a row: (q, scale) with
    ``x ~ q * scale``; `torch.round` rounds half to even, as `jnp.round`."""
    xf = x.float()
    scl = torch.clamp(xf.abs().amax(dim), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scl.unsqueeze(dim)), -127, 127)
    return q.to(torch.int8), scl


def moe_apply(p: MoE, x, mcfg: MoEConfig):
    """x: [B, S, D] -> (y [B, S, D], aux loss)."""
    B, S, D = x.shape
    T = B * S
    E, K = mcfg.num_experts, mcfg.top_k
    xt = x.reshape(T, D)
    gates, eidx, pos, keep, aux = route(p, xt, mcfg)
    C = capacity(T, mcfg)

    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    e_safe = torch.where(keep, eidx.reshape(-1), E)               # E: dropped
    slot = torch.clamp(pos, max=C - 1)
    index = (e_safe, slot)
    if mcfg.dispatch == "int8":
        # quantized all-to-all payload with per-token scales
        xq, scl = _quantize(xt)
        buf = xq.new_zeros((E + 1, C, D)).index_put(index, xq[tok])
        sbuf = scl.new_zeros((E + 1, C)).index_put(index, scl[tok])
        xe = (buf[:E].float() * sbuf[:E][..., None]).to(x.dtype)
    else:
        xe = xt.new_zeros((E + 1, C, D)).index_put(index, xt[tok])[:E]

    h = F.silu(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wi)         # [E, C, F]
    ye = torch.bmm(h, p.wo)                                       # [E, C, D]

    e_read = torch.clamp(e_safe, max=E - 1)
    if mcfg.dispatch == "int8":
        yq, yscl = _quantize(ye)
        yk = (yq[e_read, slot].float()
              * yscl[e_read, slot][:, None]).to(x.dtype)
    else:
        yk = ye[e_read, slot]
    yk = torch.where(keep[:, None], yk, torch.zeros((), dtype=yk.dtype,
                                                    device=yk.device))
    y = (yk.reshape(T, K, D) * gates[..., None].to(x.dtype)).sum(dim=1)
    if p.shared is not None:
        y = y + L.swiglu(p.shared, xt)
    return y.reshape(B, S, D), aux
