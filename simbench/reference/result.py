"""The simulation settings a run is made with and the per-lane result it
gives."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SimConfig:
    pkt_len: int = 4          # flits per packet
    buf_pkts: int = 8         # input buffer depth (packets)
    srcq_pkts: int = 64       # source queue depth (packets)
    vcs_per_class: int = 2    # physical VCs per deadlock class
    warmup: int = 2000
    measure: int = 8000
    vc_mode: str = "baseline"          # "baseline" | "updown" | "updown_merged"
    route_mode: str = "min"            # "min" | "val" | "val_restricted" | "ugal"
    ugal_threshold: int = 3
    reap_age: int = 0         # router-death reaper park age; 0: off

    @property
    def nonminimal(self) -> bool:
        return self.route_mode != "min"


@dataclass
class SimResult:
    offered_per_chip: float
    throughput_per_chip: float     # accepted flits per cycle per chip
    avg_latency: float             # cycles, generation -> ejection
    delivered_pkts: int
    generated_pkts: int
    dropped_pkts: int              # source-queue overflow (backlog)
    hops_by_type: dict
    avg_hops_by_type: dict = field(default_factory=dict)
    stranded_pkts: int = 0         # parked on the -1 non-channel at exit
    stranded_mean: float = 0.0
    reaped_pkts: int = 0           # dropped by the router-death reaper
    occupancy_peak: int = 0        # high-water mark of live request rows
