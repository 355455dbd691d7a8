"""Layer library of the LM (port of `repro.models.layers`).

Weights live in `nn.Module`s (`Dense`, `RMSNorm`, `Attention`, `SwiGLU`)
whose parameter names and layouts mirror the reference's param dicts: a
dense weight `w` is ``[d_in, d_out]`` and applied as ``x @ w``; norm
scales are fp32 in every model dtype.  The functions (`dense`, `rmsnorm`,
`apply_rope`, `attention_apply`, `swiglu`) take those modules in place of
the dicts and compute what the reference computes, dtype step for dtype
step.

Attention supports three implementations selected by `attn_impl`:
  naive   - materialized scores (reference / tiny smoke shapes)
  chunked - online softmax over KV blocks in plain torch
  kernel  - the flash-attention kernel (`kernels.flash_attention.ops`):
            the CUDA kernel on the card, its plain version on the CPU

KV caches are updated in place: `attention_apply` stores the new keys,
values, `idx` and `base` into the cache's own tensors (the reference
returns new arrays) and returns that same dict.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard

from ..kernels.flash_attention import ops as fa_ops
from .placement import (batch_placements, gather_inner, gather_inner_grad,
                        is_dt, like, local, merge_dims, replicated,
                        split_dim)

MASKED = -1e30      # the reference's masked score


def truncated_normal(generator, shape, dtype, scale):
    """Normal draws truncated to [-2, 2] (not renormalised), times `scale`,
    in `dtype`, on the generator's device."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


class Dense(nn.Module):
    """``x @ w (+ b)``, `w` of shape [d_in, d_out] as in the reference."""

    def __init__(self, d_in, d_out, dtype, use_bias=False, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if use_bias else None)

    def reset(self, generator):
        """The reference's `dense_init` (every caller's scale is
        1/sqrt(d_in)): truncated normal weights, zero bias."""
        self.w.copy_(truncated_normal(generator, self.w.shape, self.w.dtype,
                                      1.0 / math.sqrt(self.w.shape[0])))
        if self.b is not None:
            self.b.zero_()


def dense(p, x):
    """On a DTensor, a sequence (inner) dim sharded over the mesh is
    gathered first, as Megatron sequence parallelism does before a
    projection (DTensor's matrix product takes no shard of a flattened
    batch x sequence dim)."""
    x = gather_inner(x)
    y = gather_inner_grad(x @ p.w)
    if p.b is not None:
        y = y + p.b
    return y


class RMSNorm(nn.Module):
    """An fp32 `scale` of ones, in every model dtype (`rmsnorm_init`)."""

    def __init__(self, d, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale).to(x.dtype)


# --- rotary embeddings -------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, rot_dim: int | None = None,
               device=None):
    rot = rot_dim or head_dim
    inv = 1.0 / (theta ** (np.arange(0, rot, 2) / rot))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def apply_rope(x, positions, inv_freq, rot_dim: int | None = None):
    """x: [..., seq, heads, head_dim]; positions: [..., seq].

    The interleaved-pair form: dims (0, 1), (2, 3), ... rotate together.
    rot_dim < head_dim rotates only the first rot_dim dims (ChatGLM-style
    2D/partial RoPE)."""
    hd = x.shape[-1]
    rot = rot_dim or hd
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None].float() * inv_freq    # [..., S, rot/2]
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1) if rot < hd \
        else out.to(x.dtype)


# --- attention ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    use_bias: bool = False
    rope_theta: float = 1e4
    rope_frac: float = 1.0        # fraction of head_dim rotated
    causal: bool = True
    window: int | None = None     # local attention window
    attn_impl: str = "chunked"
    chunk_q: int = 512
    chunk_k: int = 1024


class Attention(nn.Module):
    """The q, k, v, o projections (`attention_init`)."""

    def __init__(self, cfg: AttnConfig, dtype, device=None):
        super().__init__()
        H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
            cfg.d_model
        self.q = Dense(d, H * hd, dtype, cfg.use_bias, device)
        self.k = Dense(d, KV * hd, dtype, cfg.use_bias, device)
        self.v = Dense(d, KV * hd, dtype, cfg.use_bias, device)
        self.o = Dense(H * hd, d, dtype, cfg.use_bias, device)


def _repeat_kv(k, groups):
    # k: [B, S, KV, hd] -> [B, S, KV*groups, hd]
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def naive_attention(q, k, v, causal=True, window=None, q_offset=0):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, H, hd] (already GQA-expanded)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask[None, None], logits, MASKED)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def chunked_attention(q, k, v, causal=True, window=None, q_offset=0,
                      chunk_q=512, chunk_k=1024):
    """Online-softmax flash attention in plain torch: O(Sq*hd) memory."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    cq = min(chunk_q, Sq)
    ck = min(chunk_k, Sk)
    pad_q = (-Sq) % cq
    pad_k = (-Sk) % ck
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    qs = q.reshape(B, nq, cq, H, hd).permute(1, 0, 3, 2, 4)  # [nq,B,H,cq,hd]
    ks = k.reshape(B, nk, ck, H, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(B, nk, ck, H, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qs[qi]
        qpos = qi * cq + torch.arange(cq, device=dev) + q_offset
        m = torch.full((B, H, cq), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb, vb = ks[ki], vs[ki]
            kpos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb).float() * scale
            msk = kpos[None, :] < Sk
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(msk[None, None], s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype), vb).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])  # [B,H,cq,hd]
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, nq * cq, H, hd)
    return out[:, :Sq].to(v.dtype)


def attention_apply(p, cfg: AttnConfig, x, positions, inv_freq, cache=None,
                    kv_memory=None):
    """x: [B, S, D].  cache: dict(k, v, idx, base) for prefill / decode,
    updated in place (all four entries) and returned.  kv_memory: [B, Sm, D] for
    cross-attention (encoder memory); RoPE is skipped for cross-attn.

    On DTensors the projections are DTensor ops, and RoPE, the cache update
    and the attention itself run on each rank's shard (`placement.local`)
    with the batch sharded and the heads split over the "model" mesh dim:
    where it divides both head counts, q, k, v and the cache come in
    sharded by head; otherwise they come in whole and each rank attends
    with its own ceil(H / m) query heads (and their KV heads), the last
    ranks' heads past H padding that is cut off afterwards, as GSPMD pads
    an uneven dim.  A cache laid out otherwise gets the updated shards
    copied back into its own layout."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_dim(dense(p.q, x), 2, (H, hd))
    src = kv_memory if kv_memory is not None else x
    k = split_dim(dense(p.k, src), 2, (KV, hd))
    v = split_dim(dense(p.v, src), 2, (KV, hd))
    cross = kv_memory is not None
    decode = cache is not None and not cross and S == 1
    prefill_cache = cache is not None and not cross and S > 1
    bufs = tuple(cache[n] for n in ("k", "v", "idx", "base")) \
        if decode or prefill_cache else ()

    heads = None

    def attend(q, k, v, positions, inv_freq, *bufs):
        o = _attend(cfg, q, k, v, positions, inv_freq, bufs, cross, decode,
                    prefill_cache, heads)
        return (o,) + bufs[:2]

    if not is_dt(q):
        o = attend(q, k, v, positions, inv_freq, *bufs)[0]
    else:
        mesh = q.device_mesh
        pl, split = _core_placements(q, B, H, KV)
        batch_pl = tuple(r if isinstance(r, Shard) and r.dim == 0
                         else Replicate() for r in pl)
        rep = replicated(mesh)
        o_pl, grad_pl = pl, None
        if split is not None:
            # q, k, v whole on this rank; it attends with its heads only
            dim, n = split
            heads = (mesh.get_local_rank(dim) * n, n)
            o_pl = tuple(Shard(2) if i == dim else r
                         for i, r in enumerate(pl))
            part = tuple(Partial() if i == dim else r
                         for i, r in enumerate(pl))
            grad_pl = (part, part, part, batch_pl, rep) \
                + (pl, pl, rep, rep)[:len(bufs)]
        ins = (pl, pl, pl, batch_pl, rep) + (pl, pl, rep, rep)[:len(bufs)]
        outs = local(attend, (o_pl,) + (pl,) * min(len(bufs), 2), ins,
                     q, k, v, like(q, positions), like(q, inv_freq), *bufs,
                     in_grad_placements=grad_pl)
        o = outs[0]
        if o.shape[2] > H:
            o = o[:, :, :H]     # the padding heads
        for buf, new in zip(bufs[:2], outs[1:]):
            if tuple(buf.placements) != pl:
                # the shard was a copy: write it back in the cache's layout
                buf.copy_(new.redistribute(buf.device_mesh, buf.placements))
    out = dense(p.o, merge_dims(o, 2))
    return out, cache if decode or prefill_cache else None


def _core_placements(q, B, H, KV):
    """The local attention's input layout on q's mesh, and how the heads
    split: the batch (dim 0) is sharded as `placement.batch_placements`
    says; the "model" mesh dim shards the heads (dim 2) when it divides
    both H and KV (split None); where it does not, and it does not shard
    the batch either, it is replicated, with split (that mesh dim,
    ceil(H / its size)) for the core to take its own heads; every other
    mesh dim is replicated."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    model = [i for i, name in enumerate(names) if name == "model"
             and mesh.size(i) > 1]
    even = [i for i in model if H % mesh.size(i) == 0
            and KV % mesh.size(i) == 0]
    pl = tuple(Shard(2) if p is None else p
               for p in batch_placements(q, B, claimed=even))
    if even or not model or not isinstance(pl[model[0]], Replicate):
        # heads sharded, no model dim, or one that shards the batch
        return pl, None
    return pl, (model[0], -(-H // mesh.size(model[0])))


def _attend(cfg: AttnConfig, q, k, v, positions, inv_freq, bufs, cross,
            decode, prefill_cache, heads=None):
    """RoPE, the cache update and the attention of `attention_apply` on
    plain tensors: q [B, S, H, hd], k / v [B, Sk, KV, hd]; `bufs` the
    cache's (k, v, idx, base), updated in place.  `heads` (lo, n): the
    attention runs on the query heads lo ... lo + n - 1 only (those past
    H repeat the last), each with its KV head: [B, S, n, hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    Sk = k.shape[1]
    if not cross:
        rot = int(hd * cfg.rope_frac)
        if rot > 0:
            q = apply_rope(q, positions, inv_freq, rot)
            k = apply_rope(k, positions, inv_freq, rot)

    q_offset = 0
    if decode:
        # append one token to the (possibly rolling) cache
        ck, cv, idx, base = bufs    # idx: absolute position of the new token
        W = ck.shape[1]
        pos = torch.remainder(idx - base, W) if cfg.window is not None \
            else idx
        # dynamic_update_slice clamps its start so the update fits
        pos = pos.clamp(0, W - 1).reshape(1).long()
        ck.index_copy_(1, pos, k.to(ck.dtype))
        cv.index_copy_(1, pos, v.to(cv.dtype))
        k, v = ck, cv
        q_offset = idx.clone()
        idx.add_(1)
    elif prefill_cache:
        # populate the cache with the (last W) computed k/v; attention
        # below runs on the local k/v, not the buffer
        W = bufs[0].shape[1]
        kw = k[:, -W:] if W < Sk else k
        vw = v[:, -W:] if W < Sk else v
        n = kw.shape[1]
        for buf, new in ((bufs[0], kw), (bufs[1], vw)):
            buf[:, :n] = new
            buf[:, n:] = 0
        bufs[2].fill_(Sk)
        bufs[3].fill_(max(0, Sk - W))

    if heads is not None:
        lo, n = heads
        pick = torch.clamp(torch.arange(lo, lo + n, device=q.device),
                           max=H - 1)
        q, k, v = q[:, :, pick], k[:, :, pick // (H // KV)], \
            v[:, :, pick // (H // KV)]
        H = KV = n
    groups = H // KV
    if decode:
        # decode attention: mask out unwritten cache slots
        k = _repeat_kv(k, groups)
        v = _repeat_kv(v, groups)
        W = k.shape[1]
        kpos = torch.arange(W, device=q.device)
        valid = kpos < torch.clamp(q_offset + 1, max=W)
        scale = 1.0 / math.sqrt(hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        logits = torch.where(valid[None, None, None], logits, MASKED)
        pr = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)
    if cfg.attn_impl == "naive" or cross:
        return naive_attention(q, _repeat_kv(k, groups),
                               _repeat_kv(v, groups),
                               causal=cfg.causal and not cross,
                               window=cfg.window)
    if cfg.attn_impl == "chunked":
        return chunked_attention(q, _repeat_kv(k, groups),
                                 _repeat_kv(v, groups), causal=cfg.causal,
                                 window=cfg.window, chunk_q=cfg.chunk_q,
                                 chunk_k=cfg.chunk_k)
    if cfg.attn_impl == "kernel":
        # the kernel reads KV head h // groups itself: no expansion
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.window)
    raise ValueError(cfg.attn_impl)


# --- FFN ---------------------------------------------------------------------

class SwiGLU(nn.Module):
    """The wi, wg, wo projections (`swiglu_init`)."""

    def __init__(self, d_model, d_ff, dtype, use_bias=False, device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype, use_bias, device)
        self.wg = Dense(d_model, d_ff, dtype, use_bias, device)
        self.wo = Dense(d_ff, d_model, dtype, use_bias, device)


def swiglu(p, x):
    return dense(p.wo, F.silu(dense(p.wg, x)) * dense(p.wi, x))
