"""Mamba-2 SSD (state-space duality) sequence-mixing block (port of
`repro.models.ssm`).

Chunked algorithm of Dao & Gu (arXiv:2405.21060): intra-chunk quadratic
attention-like term + inter-chunk state recurrence.  `ssd_chunked` is the
plain torch form the reference runs; with ``use_kernel`` the block runs
the SSD scan kernel (`kernels.ssd_scan.ops.ssd_scan`) instead, which
computes the same function: the CUDA kernel on the card, its plain
version on the CPU.

The weights live in the `nn.Module` `SSM`, under the reference's names.
A cache, when given, is updated in place: the block copies the new conv
window and state into the cache's own tensors (the reference returns new
arrays) and returns that same dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard

from ..configs.base import SSMConfig
from ..kernels.ssd_scan import ops as ssd_ops
from .layers import Dense, RMSNorm, dense, rmsnorm, truncated_normal
from .placement import batch_placements, is_dt, local, replicated


class SSM(nn.Module):
    """`ssm_init`: the in/out projections, the depthwise conv, the fp32
    decay log-rates `A_log`, skip `D`, `dt_bias` and the inner norm."""

    def __init__(self, d_model: int, scfg: SSMConfig, dtype, device=None):
        super().__init__()
        di = scfg.d_inner(d_model)
        H = scfg.num_heads(d_model)
        N = scfg.d_state
        conv_dim = di + 2 * N
        f32 = torch.float32
        # projections: z (gate), x, B, C, dt
        self.in_proj = Dense(d_model, 2 * di + 2 * N + H, dtype,
                             device=device)
        self.conv_w = nn.Parameter(torch.empty(scfg.d_conv, conv_dim,
                                               dtype=dtype, device=device))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype,
                                               device=device))
        self.A_log = nn.Parameter(torch.empty(H, dtype=f32, device=device))
        self.D = nn.Parameter(torch.empty(H, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.empty(H, dtype=f32, device=device))
        self.norm = RMSNorm(di, device)
        self.out_proj = Dense(di, d_model, dtype, device=device)

    def reset(self, generator):
        """The reference's draws for the weights that are not `Dense`
        (those reset themselves): a truncated-normal conv of std
        1/sqrt(d_conv), zero conv bias, A = linspace(1, 16), D = 1,
        dt_bias = 0."""
        K = self.conv_w.shape[0]
        H = self.A_log.shape[0]
        self.conv_w.copy_(truncated_normal(generator, self.conv_w.shape,
                                           self.conv_w.dtype,
                                           1.0 / math.sqrt(K)))
        self.conv_b.zero_()
        self.A_log.copy_(torch.from_numpy(
            np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv1d.  x: [B, S, C]; w: [K, C].  Sums the K
    products in x's dtype, in the reference's order.  Returns the output
    and the last K - 1 inputs (the next call's cache)."""
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
        new_cache = xp[:, -(K - 1):] if K > 1 else None
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xp[:, -(K - 1):]
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, new_cache


def _split_proj(proj, di, N, H):
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + N]
    Cm = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, x, Bm, Cm, dt


def _silu(x):
    """x * sigmoid(x) as `jax.nn.silu` computes it: the sigmoid as
    1 / (1 + exp(-x)), every step rounded to x's dtype (in bf16 this
    equals the reference bit for bit; `F.silu` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x):
    """log(1 + exp(x)) without a threshold (`jax.nn.softplus`)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, head_group: int = 8):
    """SSD over chunks, scanning chunk-by-chunk (the state pass) and
    processing heads in groups so the [B, L, L, Hg] decay tensor stays
    small.

    xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (positive decay
    rate); Bm, Cm: [B, S, N].  Returns y: [B, S, H, P] in xh's dtype and the
    final state [B, H, P, N] in fp32.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // L
    Hg = min(head_group, H)
    while H % Hg:
        Hg -= 1
    ng = H // Hg
    f32 = torch.float32
    # [nc, B, ...] chunk-major for the state pass
    xc = xh.reshape(Bsz, nc, L, ng, Hg, P).permute(1, 0, 3, 2, 4, 5).float()
    dtc = dt.reshape(Bsz, nc, L, ng, Hg).permute(1, 0, 3, 2, 4).float()
    Bc = Bm.reshape(Bsz, nc, L, N).permute(1, 0, 2, 3).float()
    Cc = Cm.reshape(Bsz, nc, L, N).permute(1, 0, 2, 3).float()
    Ag = A.reshape(ng, Hg).float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))

    s = torch.zeros((Bsz, ng, Hg, P, N), dtype=f32, device=xh.device)
    ys = []
    for c in range(nc):
        # s: [B, ng, Hg, P, N]
        xck, dck, bck, cck = xc[c], dtc[c], Bc[c], Cc[c]
        la = -Ag[None, :, None, :] * dck                      # [B,ng,L,Hg]
        cum = torch.cumsum(la, dim=2)
        cb = torch.einsum("bin,bjn->bij", cck, bck)           # [B,L,L]
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,ng,i,j,Hg]
        # mask BEFORE exp: the upper triangle's seg is large-positive
        seg = torch.where(mask[None, None, :, :, None], seg, -1e30)
        att = torch.exp(seg)
        w = cb[:, None, :, :, None] * att * dck[:, :, None, :, :]
        y = torch.einsum("bgijh,bgjhp->bgihp", w, xck)
        # inter-chunk: y_i += exp(cum_i) * C_i . S_prev
        y = y + torch.einsum("bin,bghpn,bgih->bgihp", cck, s,
                             torch.exp(cum))
        # state update
        decay_tail = torch.exp(cum[:, :, -1:, :] - cum) * dck  # [B,ng,L,Hg]
        s = s * torch.exp(cum[:, :, -1])[..., None, None] \
            + torch.einsum("bgjh,bjn,bgjhp->bghpn", decay_tail, bck, xck)
        ys.append(y)
    # ys: [nc, B, ng, L, Hg, P] -> [B, S, H, P]
    y = torch.stack(ys).permute(1, 0, 3, 2, 4, 5).reshape(Bsz, nc * L, H, P)
    return y[:, :S].to(xh.dtype), s.reshape(Bsz, H, P, N)


def ssm_apply(p: SSM, x, scfg: SSMConfig, d_model: int, cache=None,
              use_kernel: bool = False):
    """Full mamba2 block.  cache: dict(conv, state) for prefill / decode,
    updated in place and returned.  `use_kernel` runs the sequence scan
    (no cache or S > 1) through `ssd_ops.ssd_scan`; the decode step is the
    exact single-step recurrence either way.

    On DTensors the projections are DTensor ops and the rest runs on each
    rank's batch shard (`placement.local`), the cache's shards copied back
    into its own layout where that differs.  Without a cache, a "model"
    mesh dim that does not shard the batch splits the heads: each rank
    takes its ceil(H / m) heads' columns of the packed projection (which
    do not split by head as they lie) and of the conv, scans them, and
    the inner norm runs over the gathered heads (the last ranks' heads
    past H are padding, cut off before it)."""
    proj = dense(p.in_proj, x)
    bufs = (cache["conv"], cache["state"]) if cache is not None else ()
    heads = None

    def mix(proj, conv_w, conv_b, dt_bias, A_log, Dskip, norm_scale, *bufs):
        return _ssm_mix(proj, conv_w, conv_b, dt_bias, A_log, Dskip,
                        norm_scale, scfg, d_model, bufs, use_kernel, heads)

    args = (proj, p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D, p.norm.scale)
    if not is_dt(proj):
        y = mix(*args, *bufs)[0]
    else:
        mesh = proj.device_mesh
        batch = batch_placements(proj, proj.shape[0])
        rep = replicated(mesh)
        # a weight's gradient is the sum of each batch shard's
        summed = tuple(Partial() if isinstance(b, Shard) else Replicate()
                       for b in batch)
        y_pl, proj_grad = batch, batch
        names = mesh.mesh_dim_names or ()
        model = [i for i, name in enumerate(names) if name == "model"
                 and mesh.size(i) > 1 and isinstance(batch[i], Replicate)]
        if model and not bufs:
            dim = model[0]
            n = -(-scfg.num_heads(d_model) // mesh.size(dim))
            heads = (mesh.get_local_rank(dim) * n, n)
            y_pl = tuple(Shard(2) if i == dim else b
                         for i, b in enumerate(batch))
            proj_grad = tuple(Partial() if i == dim else b
                              for i, b in enumerate(batch))
            summed = tuple(Partial() if i == dim else b
                           for i, b in enumerate(summed))
        outs = local(mix, (y_pl,) + (batch,) * len(bufs),
                     (batch,) + (rep,) * 6 + (batch,) * len(bufs),
                     *args, *bufs,
                     in_grad_placements=(proj_grad,) + (summed,) * 6
                     + (batch,) * len(bufs))
        y = outs[0]
        if heads is not None:
            di = scfg.d_inner(d_model)
            if y.shape[2] > di:
                y = y[:, :, :di]    # the padding heads
            y = rmsnorm(p.norm, y)
        for buf, new in zip(bufs, outs[1:]):
            if tuple(buf.placements) != batch:
                buf.copy_(new.redistribute(mesh, buf.placements))
    out = dense(p.out_proj, y)
    return out, (cache if cache is not None else None)


class _Scale:
    """`rmsnorm` reads ``p.scale``."""

    def __init__(self, scale):
        self.scale = scale


def _ssm_mix(proj, conv_w, conv_b, dt_bias, A_log, Dskip, norm_scale,
             scfg: SSMConfig, d_model: int, bufs, use_kernel, heads=None):
    """`ssm_apply` between its two projections, on plain tensors: proj
    [B, S, 2 di + 2 N + H] -> (y [B, S, di],) + the updated cache
    tensors `bufs` (conv, state), written in place.  `heads` (lo, n), no
    cache: only the heads lo ... lo + n - 1 (those past H repeat the
    last), and y [B, S, n P] before the inner norm."""
    B, S, _ = proj.shape
    di = scfg.d_inner(d_model)
    H = scfg.num_heads(d_model)
    N = scfg.d_state
    P = scfg.head_dim
    dtype = proj.dtype
    z, xs, Bm, Cm, dt = _split_proj(proj, di, N, H)
    if heads is not None:
        lo, n = heads
        pick = torch.clamp(torch.arange(lo, lo + n, device=proj.device),
                           max=H - 1)
        cols = (pick[:, None] * P
                + torch.arange(P, device=proj.device)).reshape(-1)
        chans = torch.cat([cols, di + torch.arange(2 * N,
                                                   device=proj.device)])
        z, xs, dt = z[..., cols], xs[..., cols], dt[..., pick]
        conv_w, conv_b = conv_w[:, chans], conv_b[chans]
        dt_bias, A_log, Dskip = dt_bias[pick], A_log[pick], Dskip[pick]
        di, H = n * P, n
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, conv_w, conv_b, bufs[0] if bufs else None)
    conv_out = _silu(conv_out)
    xs = conv_out[..., :di]
    Bm = conv_out[..., di:di + N]
    Cm = conv_out[..., di + N:]
    dt = _softplus(dt.float() + dt_bias)
    A = torch.exp(A_log)
    xh = xs.reshape(B, S, H, P)

    if not bufs or S > 1:
        # the sequence (with a cache: the prompt, keeping the final state)
        if use_kernel:
            y, state = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=scfg.chunk,
                                        return_state=True)
        else:
            y, state = ssd_chunked(xh, dt, A, Bm, Cm, scfg.chunk)
    else:
        # decode: exact single-step recurrence (S == 1)
        s_prev = bufs[1]                                      # [B,H,P,N]
        a = torch.exp(-A[None, :] * dt[:, 0])                 # [B,H]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xh[:, 0].float())
        state = s_prev * a[:, :, None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                         state)[:, None].reshape(B, 1, H, P)
        y = y.to(dtype)

    y = y + xh * Dskip[None, None, :, None].to(dtype)
    y = y.reshape(B, S, di) * _silu(z)
    if heads is not None:
        return (y,)
    y = rmsnorm(_Scale(norm_scale), y)
    if bufs:
        bufs[0].copy_(new_conv)
        bufs[1].copy_(state)
    return (y,) + tuple(bufs)


def ssm_cache_init(batch, d_model, scfg: SSMConfig, dtype, device=None,
                   lead=()):
    """A zeroed cache (conv window in the model dtype, fp32 state), with
    `lead` axes in front (the stacked groups)."""
    di = scfg.d_inner(d_model)
    H = scfg.num_heads(d_model)
    conv_dim = di + 2 * scfg.d_state
    return {
        "conv": torch.zeros((*lead, batch, scfg.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((*lead, batch, H, scfg.head_dim, scfg.d_state),
                             dtype=torch.float32, device=device),
    }
