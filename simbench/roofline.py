"""The yardstick's byte counts and the card's peak.

The arbitration kernels' bytes are counted from a cell's shapes alone:
each input read once (a channel mask shared by every lane once), each
output written once, whatever a kernel reads again.  The request rows of
a cycle are the buffer heads of every non-eject channel and VC, then one
source queue a terminal: ``N = E_req * NV + T`` a lane.
"""
from __future__ import annotations

from . import reference
from .reference.routing import num_vcs

# NVIDIA H100 SXM: 3.35 TB/s of HBM3 at its 700 W power limit (data sheet)
H100_BYTES_PER_S = 3.35e12


def cycle_core_bytes(B: int, N: int, E: int, *, prio: bool = False,
                     shared_ch_ok: bool = False) -> int:
    """Bytes `cycle_core` must move for B lanes of N request rows and E
    channels: out and itime (int32), ok (1 byte) and the optional int32
    priority a row, the channel mask (1 byte a channel); won (1 byte) and
    the winner's priority (int32) a channel, win (1 byte) a row."""
    rows = B * N * (4 + 4 + 1 + (4 if prio else 0))
    ch_ok = (1 if shared_ch_ok else B) * E
    return rows + ch_ok + B * E * 5 + B * N


def grant_bytes(B: int, N: int, E: int, *, shared_alive: bool = True) -> int:
    """Bytes the oracle step's `grant` must move: out, itime, ovc_count
    (int32), valid and is_eject (1 byte) a row; ch_busy (int32) and the
    alive mask (1 byte, shared by every lane once) a channel; win (1
    byte) a row and won (1 byte) a channel."""
    rows = B * N * (4 + 4 + 1 + 4 + 1)
    chans = B * E * 4 + (1 if shared_alive else B) * E
    return rows + chans + B * N + B * E


def cycle_shapes(config: dict, traffic: dict, lanes: int) -> dict:
    """The cell's shapes: lanes B, request rows N a lane, channels E,
    terminals T, physical VCs NV and requesting channels E_req."""
    net = reference.build_network(config)
    NV = num_vcs(net.meta["kind"], config["vc_mode"],
                 traffic["route_mode"] != "min") * config["vcs_per_class"]
    E_req, T = net.first_eject, net.num_terminals
    return dict(B=lanes, N=E_req * NV + T, E=net.num_channels, T=T, NV=NV,
                E_req=E_req)
