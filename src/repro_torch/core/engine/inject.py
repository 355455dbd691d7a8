"""Injection phase: Bernoulli packet generation, the misroute decision
(VAL / restricted-VAL / UGAL-G with congestion sensors; the span
`route.misroute`, in every route mode), and the source-queue push.  Also
accounts generated/dropped packets.

Port of `repro.core.engine.inject`, lane-batched: keys are ``[B, 2]``,
rates ``[B]``, and every per-terminal tensor is ``[B, T]``.  The draws
split each lane's cycle key three ways (gen, dest, mis) in the
reference's order, so a lane injects exactly what the reference lane
injects.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import random as jr
from ...spans import span
from ...tensors import as_tensor, flat_index, lane_take, take, take_flat
from ..topology import MESH, FaultSet, Network


def build_ugal_watch(net: Network, cfg, faults: FaultSet | None = None, *,
                     device):
    """UGAL-G congestion sensors: an int32 tensor [g, g, 5] of channel ids
    whose buffered load proxies the (w-group -> peer) global path quality
    (-1 = unused slot), or None when UGAL is off.  Same construction as
    the reference `build_ugal_watch`."""
    if cfg.route_mode != "ugal":
        return None
    t = net.tables
    g = net.meta["g"]
    faults = faults or FaultSet()
    ch_alive = faults.ch_alive(net)
    gw = np.full((g, g, 5), -1, dtype=np.int64)
    if net.meta["kind"] == "switchless":
        ab = net.meta["ab"]
        npar = t["glob_route_cg"].shape[-1]
        for w in range(g):
            for u in range(g):
                if u == w:
                    continue
                ch = -1
                for r in range(npar):
                    cg = t["glob_route_cg"][w, u, r]
                    if cg < 0:
                        continue
                    cand = t["ext_out"][w * ab + cg, t["glob_route_port"][w, u, r]]
                    if cand >= 0 and ch_alive[cand]:
                        ch = cand
                        break
                if ch < 0:
                    continue
                src = net.ch_src[ch]
                feeders = [c for c in np.where(net.ch_dst == src)[0]
                           if net.ch_type[c] == MESH and ch_alive[c]][:4]
                sens = [ch] + list(feeders)
                gw[w, u, :len(sens)] = sens
        return as_tensor(gw, device)
    out_ch = t["glob_out_ch"]
    npar = out_ch.shape[-1]
    for w in range(g):
        for u in range(g):
            if u == w:
                continue
            for r in range(npar):
                cand = out_ch[w, u, r]
                if cand >= 0 and ch_alive[cand]:
                    gw[w, u, 0] = cand
                    break
    return as_tensor(gw, device)


def ugal_queue_len(occ, watch_entry):
    """Masked sensor sum per lane: total buffered packets over the (>= 0)
    sensor channels of each watch entry ``[B, T, 5]`` given the per-lane
    channel occupancy ``occ [B, E]``; -1 slots contribute zero."""
    vals = lane_take(occ, torch.clamp(watch_entry, min=0))
    return torch.where(watch_entry >= 0, vals, 0).sum(-1)


def make_misroute_fn(net: Network, cfg, consts):
    """Returns gen_mis(key[B, 2], dest[B, T], b_count[B, E, NV], fl)
    -> mis_wg[B, T] (int32; -1 = route minimally)."""
    T = consts["T"]
    num_wg = consts["num_wg"]
    term_wg = consts["term_wg"]

    def gen_mis(key, dest, b_count, fl):
        B = dest.shape[0]
        if cfg.route_mode == "min" or num_wg <= 2:
            return torch.full((B, T), -1, dtype=torch.int32,
                              device=dest.device)
        wg_s = term_wg
        wg_d = take(term_wg, dest)
        differ = wg_s != wg_d
        cand = jr.randint(key, (T,), 0, num_wg)
        cand = torch.where((cand == wg_s) | (cand == wg_d),
                           (cand + 1) % num_wg, cand)
        cand = torch.where((cand == wg_s) | (cand == wg_d),
                           (cand + 1) % num_wg, cand)
        # fault-aware candidate mask: both misroute hops must keep an
        # alive global link on the current epoch's surviving network
        cand0 = torch.clamp(cand, min=0)
        ok_path = lane_take(fl["glob_ok"], wg_s, cand0) \
            & lane_take(fl["glob_ok"], cand0, wg_d)
        cand = torch.where(ok_path, cand, -1)
        if cfg.route_mode == "val_restricted":
            # only misroute to W-groups strictly below the destination
            ok = (cand < wg_d) & (cand != wg_s) & (cand >= 0)
            cand = torch.where(ok, cand, -1)
        if cfg.route_mode == "ugal":
            watch = fl["ugal_watch"]
            occ = b_count.sum(dim=2, dtype=torch.int32)  # [B, E] buffered
            cand0 = torch.clamp(cand, min=0)
            q_min = ugal_queue_len(
                occ, lane_take(watch, wg_s, torch.clamp(wg_d, min=0)))
            q_non = ugal_queue_len(occ, lane_take(watch, wg_s, cand0))
            q_non = q_non + lane_take(fl["wg_penalty"], cand0)
            take_nonmin = (q_min > 2 * q_non + cfg.ugal_threshold) \
                & (cand >= 0)
            cand = torch.where(take_nonmin, cand, -1)
        return torch.where(differ, cand, -1).to(torch.int32)

    return gen_mis


def make_inject_fn(net: Network, cfg, consts, pattern, inject_mask=None):
    """Returns inject(state, t, key[B, 2], rate_pkt[B], fl) -> state;
    `t` is a host int or a 0-d int32 tensor.

    Dead terminals neither inject nor are injected TO.  The source-queue
    records are written in place into `state.s_pkt` (one row per
    terminal and lane, so the writes never collide)."""
    T = consts["T"]
    Q = cfg.srcq_pkts
    device = consts["term_wg"].device
    inj_mask = (torch.ones(T, dtype=torch.bool, device=device)
                if inject_mask is None
                else as_tensor(np.asarray(inject_mask).astype(bool), device))
    gen_mis = make_misroute_fn(net, cfg, consts)
    terms = torch.arange(T, device=device)

    def inject(state, t, key, rate_pkt, fl):
        B = key.shape[0]
        ks = jr.split(key, 3)
        k_gen, k_dest, k_mis = ks[:, 0], ks[:, 1], ks[:, 2]
        alive = fl["term_alive"]
        gen = (jr.uniform(k_gen, (T,)) < rate_pkt[:, None]) & inj_mask
        dest = pattern(k_dest, t).to(torch.int32)
        gen = gen & (dest != terms)         # fixed points are silent
        gen = gen & alive & lane_take(alive, dest)  # dead endpoints too
        with span("route.misroute"):
            mis = gen_mis(k_mis, dest, state.b_count, fl)
        space = state.s_count < Q
        push = gen & space
        slot = (state.s_head + state.s_count) % Q
        lane = torch.arange(B, device=device)[:, None]
        itime = (t.to(dest.dtype).expand_as(dest)
                 if isinstance(t, torch.Tensor) else torch.full_like(dest, t))
        new_rec = torch.stack([dest, itime, mis], dim=-1)
        # one row per (lane, terminal): the in-place writes never collide
        flat = flat_index(state.s_pkt.shape, (lane, terms, slot),
                          clamp=False)
        rec = torch.where(push[..., None], new_rec,
                          take_flat(state.s_pkt, 3, flat))
        state.s_pkt.view(-1, rec.shape[-1]).index_copy_(
            0, flat.reshape(-1), rec.reshape(-1, rec.shape[-1]))
        st = state.stats
        st = st.replace(
            generated=st.generated + gen.sum(-1, dtype=torch.int32),
            dropped=st.dropped + (gen & ~space).sum(-1, dtype=torch.int32))
        return state.replace(s_count=state.s_count + push, stats=st)

    return inject
