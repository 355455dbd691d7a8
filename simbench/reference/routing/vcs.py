"""VC schemes and the packet routing-meta bitfield (paper Sec. IV-A/B).

Packet routing state ("meta" int32
bitfield):
  bits 0..2  cg_count  number of inter-C-group channels traversed so far
  bits 3..4  g_count   number of global channels traversed so far
  bit  5     via_ext   entered the current C-group through an external port
  bit  6     phase     up*/down* phase (set once a down hop was taken)
"""
from __future__ import annotations

import torch

from ..topology import GLOBAL, LOCAL, MESH

# up*/down* phase bit (set by the updown kernel once a down hop was taken)
PHASE_BIT = 1 << 6


def meta_cg_count(meta):
    return meta & 0x7


def meta_g_count(meta):
    return (meta >> 3) & 0x3


def meta_via_ext(meta):
    return (meta >> 5) & 0x1


def meta_update(meta, ch_type):
    """Packet meta after traversing a channel of the given type."""
    is_ext = (ch_type == LOCAL) | (ch_type == GLOBAL)
    cg = torch.clamp(meta_cg_count(meta) + is_ext, max=7)
    g = torch.clamp(meta_g_count(meta) + (ch_type == GLOBAL), max=3)
    via = torch.where(ch_type == MESH, meta_via_ext(meta),
                      is_ext.to(meta.dtype))
    # INJECT resets everything (fresh packet): handled by sim (meta=0).
    return (cg | (g << 3) | (via << 5)).to(meta.dtype)


def num_vcs(kind: str, vc_mode: str, nonminimal: bool) -> int:
    if kind == "switchless":
        if vc_mode == "baseline":
            return 6 if nonminimal else 4
        if vc_mode == "updown":
            # W-group-wide up*/down* (Autonet-style): one VC per W-group
            # visited.  2 VCs minimal, 3 non-minimal.
            return 3 if nonminimal else 2
        if vc_mode == "updown_merged":
            # misroutes restricted to W-groups below the destination merge
            # the intermediate and destination W-group VCs: 2 VCs total.
            return 2
        raise ValueError(vc_mode)
    if kind == "dragonfly":
        return 6 if nonminimal else 4  # per-hop increment scheme
    raise ValueError(kind)
