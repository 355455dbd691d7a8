"""The plain age-based grant: one winner per output channel, the two-pass
minimum (`scatter_reduce_(..., "amin")` from an INF32 fill, twice) of the
generation cycle and then the row index.  Integer keys and exact
min/tie-break semantics make "bit-identical" well defined.
"""
from __future__ import annotations

import torch

from .tensors import lane_take

INF32 = 2**31 - 1


def grant_ref(out, itime, valid, ovc_count, is_eject, ch_busy, ch_alive,
              *, buf_pkts: int):
    """One winner per output channel, oldest `itime` first, row ids break
    ties.

    out        [B?, N] int32  requested output channel (-1 = stranded,
                              never granted)
    itime      [B?, N] int32  generation cycle (age key)
    valid      [B?, N] bool   the row holds a forwardable packet
    ovc_count  [B?, N] int32  occupancy of the requested downstream buffer
    is_eject   [B?, N] bool   the requested channel is an ejection channel
                              (always has credit)
    ch_busy    [B?, E] int32  per-channel serialization countdown
    ch_alive   [B?, E] bool   per-channel fault mask

    Returns (win [B?, N] bool, won_ch [B?, E] bool).
    """
    if out.dim() == 1:
        win, won = grant_ref(out[None], itime[None], valid[None],
                             ovc_count[None], is_eject[None], ch_busy[None],
                             ch_alive[None], buf_pkts=buf_pkts)
        return win[0], won[0]
    B, N = out.shape
    E = ch_busy.shape[-1]
    credit = ovc_count < buf_pkts
    ok = valid & (out >= 0) & (lane_take(ch_busy, out) == 0) \
        & (credit | is_eject)
    ok = ok & lane_take(ch_alive, out)

    seg = torch.where(ok, out, E).long()
    fill = torch.full((B, E + 1), INF32, dtype=torch.int32, device=out.device)
    key1 = torch.where(ok, itime, INF32)
    m1 = fill.clone().scatter_reduce_(1, seg, key1, "amin")
    tie = ok & (itime == lane_take(m1, out))
    ridx = torch.arange(N, dtype=torch.int32, device=out.device).expand(B, N)
    key2 = torch.where(tie, ridx, INF32)
    m2 = fill.scatter_reduce_(1, seg, key2, "amin")
    win = tie & (ridx == lane_take(m2, out))
    won_ch = m1[:, :E] != INF32
    return win, won_ch
