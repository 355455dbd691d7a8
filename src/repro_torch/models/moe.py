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

On a mesh (DTensor input), the dispatch runs on each rank's shard
(`placement.local`): the tokens of its data shard, the experts of its
model shard (expert parallelism, when the model axis divides E; the
FSDP shard of the experts is gathered).  Each data shard routes its own
tokens with the capacity of its token count (GShard's groups), where
the reference's GSPMD keeps one global cumsum; a pair routed to another
model shard's expert is left to that shard, and the output is their
partial sum.  The load-balance loss is the reference's global one: each
shard's expert fractions and mean probabilities are summed over the
shards before their product.  On one device the shard is everything,
and the result is the plain path's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MoEConfig
from . import layers as L
from .placement import (batch_placements, gather_inner, gather_inner_grad,
                        is_dt, local)


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
    (f, P)): f [E] the fraction of the pairs routed to each expert, P [E]
    each expert's mean probability, the two factors of the load-balance
    loss (`load_balance`)."""
    T = xt.shape[0]
    E, K = mcfg.num_experts, mcfg.top_k
    probs = torch.softmax(xt.float() @ p.router, dim=-1)          # [T, E]
    gates, eidx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(-1)                                     # [T*K]
    # expert-major, so that the count runs along the last dim (on CUDA an
    # outer-dim cumsum walks its T*K rows one after another)
    onehot = F.one_hot(flat_e, E).t().contiguous()                # [E, T*K]

    pe = probs.mean(dim=0)
    fe = onehot.sum(dim=1).float() / (T * K)

    pos = torch.cumsum(onehot, dim=1) - 1
    pos = pos.gather(0, flat_e[None, :])[0]
    return gates, eidx, pos, pos < capacity(T, mcfg), (fe, pe)


def load_balance(fe, pe, mcfg: MoEConfig):
    """The load-balance aux loss (Switch): E * sum_e f_e * P_e."""
    return mcfg.num_experts * torch.sum(fe * pe) * mcfg.router_aux_weight


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
    if is_dt(x):
        return _moe_sharded(p, x, mcfg)
    xt = x.reshape(B * S, D)
    y, fe, pe = _dispatch(xt, p.router, p.wg, p.wi, p.wo, mcfg)
    if p.shared is not None:
        y = y + L.swiglu(p.shared, xt)
    return y.reshape(B, S, D), load_balance(fe, pe, mcfg)


def _dispatch(xt, router, wg, wi, wo, mcfg: MoEConfig, e_lo: int = 0):
    """Route the tokens xt [T, D] and run the experts ``e_lo ...
    e_lo + wg.shape[0] - 1`` of the E: (y [T, D] from those experts, and
    the load-balance factors f [E] and P [E] of these tokens).  With
    every expert (e_lo 0), the whole routed FFN."""
    T, D = xt.shape
    E, K = mcfg.num_experts, mcfg.top_k
    El = wg.shape[0]
    gates, eidx, pos, keep, (fe, pe) = route(_Router(router), xt, mcfg)
    C = capacity(T, mcfg)

    tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    flat_e = eidx.reshape(-1)
    if El < E:
        # a pair for another shard's expert is that shard's to add
        keep = keep & (flat_e >= e_lo) & (flat_e < e_lo + El)
        flat_e = flat_e - e_lo
    e_safe = torch.where(keep, flat_e, El)                        # El: dropped
    slot = torch.clamp(pos, max=C - 1)
    index = (e_safe, slot)
    if mcfg.dispatch == "int8":
        # quantized all-to-all payload with per-token scales
        xq, scl = _quantize(xt)
        buf = xq.new_zeros((El + 1, C, D)).index_put(index, xq[tok])
        sbuf = scl.new_zeros((El + 1, C)).index_put(index, scl[tok])
        xe = (buf[:El].float() * sbuf[:El][..., None]).to(xt.dtype)
    else:
        xe = xt.new_zeros((El + 1, C, D)).index_put(index, xt[tok])[:El]

    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)             # [El, C, F]
    ye = torch.bmm(h, wo)                                         # [El, C, D]

    e_read = torch.clamp(e_safe, max=El - 1)
    if mcfg.dispatch == "int8":
        yq, yscl = _quantize(ye)
        yk = (yq[e_read, slot].float()
              * yscl[e_read, slot][:, None]).to(xt.dtype)
    else:
        yk = ye[e_read, slot]
    yk = torch.where(keep[:, None], yk, torch.zeros((), dtype=yk.dtype,
                                                    device=yk.device))
    y = (yk.reshape(T, K, D) * gates[..., None].to(xt.dtype)).sum(dim=1)
    return y, fe, pe


class _Router:
    """`route` reads ``p.router``."""

    def __init__(self, router):
        self.router = router


def _moe_sharded(p: MoE, x, mcfg: MoEConfig):
    """`moe_apply` on a DTensor x: the dispatch on each rank's shard (see
    the module's docstring); the shared expert as DTensor ops."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, S, D = x.shape
    E = mcfg.num_experts
    x = gather_inner(x)
    xt = x.reshape(B * S, D)
    mesh = xt.device_mesh
    names = mesh.mesh_dim_names or ()
    ep = [i for i, name in enumerate(names) if name == "model"
          and mesh.size(i) > 1 and E % mesh.size(i) == 0]
    tok_pl, exp_pl, exp_grad, out_pl, router_grad = [], [], [], [], []
    split = 1          # ranks that each add a part of the output
    e_lo, El = 0, E
    for i, pl in enumerate(batch_placements(xt, B * S, claimed=ep)):
        n = mesh.size(i)
        if pl is None:
            # a model shard: its own experts, a partial output
            El = El // n
            e_lo = e_lo + mesh.get_local_rank(i) * El
            tok_pl.append(Replicate())
            exp_pl.append(Shard(0))
            exp_grad.append(Shard(0))
            out_pl.append(Partial())
            router_grad.append(Partial())
            split *= n
        elif isinstance(pl, Shard):
            # a data shard: its own tokens
            tok_pl.append(Shard(0))
            exp_pl.append(Replicate())
            exp_grad.append(Partial())
            out_pl.append(Shard(0))
            router_grad.append(Partial())
            split *= n
        else:
            tok_pl.append(Replicate())
            exp_pl.append(Replicate())
            exp_grad.append(Replicate())
            out_pl.append(Replicate())
            router_grad.append(Replicate())
    # f and P of each shard's tokens, divided by the count of shards (a
    # power of two on the production meshes, so exactly): their partial
    # sums are the global f and P, which the reference multiplies
    bal_pl = tuple(Partial() if isinstance(o, (Shard, Partial))
                   else Replicate() for o in out_pl)
    scale = 1.0 / split

    def run(xt, router, wg, wi, wo):
        y, fe, pe = _dispatch(xt, router, wg, wi, wo, mcfg, e_lo)
        return y, fe * scale, pe * scale

    rep = tuple(Replicate() for _ in out_pl)
    x_grad = tuple(Partial() if isinstance(o, Partial) else t
                   for o, t in zip(out_pl, tok_pl))
    y, fe, pe = local(
        run, (tuple(out_pl), bal_pl, bal_pl),
        (tuple(tok_pl), rep, tuple(exp_pl), tuple(exp_pl), tuple(exp_pl)),
        xt, p.router, p.wg, p.wi, p.wo,
        in_grad_placements=(x_grad, tuple(router_grad), tuple(exp_grad),
                            tuple(exp_grad), tuple(exp_grad)))
    if p.shared is not None:
        y = y + L.swiglu(p.shared, xt)
    return gather_inner_grad(y.reshape(B, S, D)), load_balance(fe, pe, mcfg)
