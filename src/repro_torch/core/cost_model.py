"""Fabric cost model: prices collective traffic per mesh axis under

  (i)  the flat grading-spec ICI model (50 GB/s/link, 2D torus-ish), and
  (ii) the switch-less Dragonfly wafer fabric of the paper (on-wafer UCIe
       mesh per C-group, LR SerDes local links per W-group, global links
       across W-groups).

Axis->tier mapping (DESIGN.md Sec. 2): "model" -> on-wafer (C-group),
"data" -> intra-W-group local links, "pod" -> global links.

Port of `repro.core.cost_model`: pure Python, equal to the reference
value for value.  The hardware constants below are the reference's model
inputs (a TPU-v5e-like grading spec and the paper's fabric), kept as they
are so the port's roofline terms equal the reference's; they are not
measurements of the port's card.
"""
from __future__ import annotations

from dataclasses import dataclass

# grading-spec hardware constants (TPU-v5e-like)
PEAK_FLOPS_BF16 = 197e12          # per chip
HBM_BW = 819e9                    # bytes/s per chip
ICI_BW_PER_LINK = 50e9            # bytes/s per link (flat model)
ICI_LINKS_PER_CHIP = 4            # 2D torus: 4 links usable per chip

# paper Sec. V-A1 fabric numbers (bytes/s)
ONWAFER_PORT_BW = 4096e9 / 8      # 512 GB/s per on-wafer channel (128x UCIe)
LR_PORT_BW = 896e9 / 8            # 112 GB/s per off-wafer SerDes port


@dataclass(frozen=True)
class FabricTier:
    name: str
    link_bw: float           # bytes/s per link
    links_per_chip: float    # links usable by one chip on this tier


@dataclass(frozen=True)
class Fabric:
    """Per-mesh-axis tier table."""
    name: str
    tiers: dict  # axis name -> FabricTier

    def tier(self, axis: str) -> FabricTier:
        return self.tiers.get(axis, self.tiers["_default"])

    def collective_seconds(self, axis: str, bytes_per_chip: float) -> float:
        """Time to move `bytes_per_chip` over the given axis's tier."""
        t = self.tier(axis)
        return bytes_per_chip / (t.link_bw * t.links_per_chip)


def flat_ici_fabric() -> Fabric:
    t = FabricTier("ici", ICI_BW_PER_LINK, 1.0)
    return Fabric("flat-ici", {"_default": t})


def switchless_wafer_fabric(cg_bw_mult: float = 1.0) -> Fabric:
    """The paper's fabric: per-chip on-wafer bandwidth is n/4-ports-per-edge
    x 512 GB/s (we count 2 usable mesh links per chip per direction of
    travel, conservative); local/global links are 112 GB/s SerDes with
    multiple ports per chip available through the C-group (injection not
    capped at one link — the switch-less advantage)."""
    return Fabric("switchless-wafer", {
        "model": FabricTier("on-wafer", ONWAFER_PORT_BW * cg_bw_mult, 2.0),
        "data": FabricTier("wgroup-local", LR_PORT_BW, 2.0),
        "pod": FabricTier("global", LR_PORT_BW, 1.0),
        "_default": FabricTier("global", LR_PORT_BW, 1.0),
    })


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes_per_chip: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def step_time_overlap_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline achieved assuming perfect
        overlap: compute_s / max(all terms)."""
        m = self.step_time_overlap_s
        return self.compute_s / m if m > 0 else 0.0


def roofline(flops: float, hbm_bytes: float, collective_bytes_by_axis: dict,
             chips: int, fabric: Fabric | None = None,
             model_flops: float = 0.0) -> RooflineTerms:
    """Three-term roofline from dry-run artifacts.

    flops/hbm_bytes are whole-program (all chips) numbers from
    cost_analysis(); collective_bytes_by_axis maps mesh axis -> total bytes
    crossing that axis (whole program).
    """
    fabric = fabric or flat_ici_fabric()
    compute_s = flops / (chips * PEAK_FLOPS_BF16)
    memory_s = hbm_bytes / (chips * HBM_BW)
    coll_s = 0.0
    coll_bytes = 0.0
    for axis, byts in collective_bytes_by_axis.items():
        per_chip = byts / chips
        coll_bytes += per_chip
        coll_s += fabric.collective_seconds(axis, per_chip)
    return RooflineTerms(compute_s=compute_s, memory_s=memory_s,
                         collective_s=coll_s, flops=flops,
                         hbm_bytes=hbm_bytes,
                         collective_bytes_per_chip=coll_bytes,
                         model_flops=model_flops)
