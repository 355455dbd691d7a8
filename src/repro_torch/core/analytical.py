"""Analytical models from the paper: Eqs. (1)-(7), Table II hop costs,
Table III case-study cost comparison, and the Fig. 15 energy model.

All quantities are closed-form; they double as property-test oracles for the
topology builder and as roofline inputs for the training-fabric cost model.

Port of `repro.core.analytical`: pure Python over the port's own
`topology` parameter classes, equal to the reference value for value.
"""
from __future__ import annotations

from dataclasses import dataclass

from .topology import SwitchlessParams, SwitchDragonflyParams

# --- Table II: rough per-hop costs -----------------------------------------
HOP_LATENCY_NS = {
    "global": 150.0,     # H_g  optical cable (+ToF, excluded as in paper)
    "local": 150.0,      # H_l  copper cable
    "sr": 5.0,           # H_sr RDL on-wafer / SR-LR conversion
    "on_chip": 1.0,      # metal layer
}
HOP_ENERGY_PJ_PER_BIT = {
    "global": 20.0,
    "local": 20.0,
    "sr": 2.0,
    "on_chip": 0.1,
    # Sec. V-C: "assume an intra-C-group hop takes 1pj/bit on average"
    "cg_avg": 1.0,
}


# --- Eqs. (1)-(7) -----------------------------------------------------------

def total_chiplets(p: SwitchlessParams) -> int:
    """Eq. (1): N = a b m^2 [ab(mn - ab + 1) + 1] (at maximum g)."""
    ab, m, n = p.ab, p.m, p.n
    return ab * m * m * (ab * (m * n - ab + 1) + 1)


def global_throughput_bound(p: SwitchlessParams) -> float:
    """Eq. (2): T_global < (mn - ab + 1) / m^2  [flits/cycle/chip]."""
    return (p.m * p.n - p.ab + 1) / (p.m * p.m)


def is_balanced_config(p: SwitchlessParams) -> bool:
    """Eq. (3): n = 3m and ab = 2 m^2."""
    return p.n == 3 * p.m and p.ab == 2 * p.m * p.m


def local_throughput_bound(p: SwitchlessParams) -> float:
    """Eq. (4): T_local < ab / m^2  [flits/cycle/chip]."""
    return p.ab / (p.m * p.m)


def cgroup_throughput_bound(p: SwitchlessParams) -> float:
    """Eq. (5): T_cg < n / m  [flits/cycle/chip]."""
    return p.n / p.m


def cgroup_bisection(p: SwitchlessParams) -> float:
    """Eq. (6): B_cg = n m / 2 = k / 2  [flits/cycle] (full-duplex)."""
    return p.n * p.m / 2


@dataclass(frozen=True)
class Diameter:
    """Hop-count diameter decomposition."""
    global_hops: int
    local_hops: int
    sr_hops: int
    term_hops: int = 0  # switch-based terminal<->switch hops (H_l*)

    def latency_ns(self) -> float:
        return (self.global_hops * HOP_LATENCY_NS["global"]
                + (self.local_hops + self.term_hops) * HOP_LATENCY_NS["local"]
                + self.sr_hops * HOP_LATENCY_NS["sr"])


def switchless_diameter(p: SwitchlessParams) -> Diameter:
    """Eq. (7): D = H_g + 2 H_l + (8m - 2) H_sr."""
    return Diameter(global_hops=1, local_hops=2, sr_hops=8 * p.m - 2)


def switchless_single_wgroup_diameter(p: SwitchlessParams) -> Diameter:
    """Sec. III-D1: single fully-connected W-group, D = H_l + (4m-2) H_sr."""
    return Diameter(global_hops=0, local_hops=1, sr_hops=4 * p.m - 2)


def dragonfly_diameter() -> Diameter:
    """Traditional Dragonfly: H_g + 2 H_l + 2 H_l* (terminal hops)."""
    return Diameter(global_hops=1, local_hops=2, sr_hops=0, term_hops=2)


# --- Sec. III-C / Table III case-study cost model ---------------------------

@dataclass(frozen=True)
class CaseStudy:
    name: str
    num_switches: int
    num_cabinets: int
    num_processors: int
    cable_count: int          # inter-cabinet cables (N in the table)
    cable_length_E: float     # total length in units of E (datacenter edge)
    t_local: float
    t_global: float


def dragonfly_slingshot_case() -> CaseStudy:
    """Table III 'Dragonfly (Slingshot)' row.

    64-port switches 16:31:17 split -> groups of 32 switches, 545 groups,
    512 terminals/group -> 279040 processors; 17440 switches; 64 blades x 2
    nodes + 8 ToR switches -> 2180 cabinets.
    """
    switches = 545 * 32
    processors = 545 * 32 * 16
    # links: terminal links N = 279040 excluded (intra-cabinet); local links
    # 32*31/2*545 = 270,320; global links 545*544/2 = 148,240.  Table counts
    # N=698K total endpoints' cables and 154K*E inter-cabinet length.
    local_links = 545 * 32 * 31 // 2
    global_links = 545 * 544 // 2
    cable_count = processors + local_links + global_links
    return CaseStudy(
        name="dragonfly-slingshot", num_switches=switches, num_cabinets=2180,
        num_processors=processors, cable_count=cable_count,
        cable_length_E=154e3, t_local=1.0, t_global=1.0)


def switchless_case(p: SwitchlessParams | None = None) -> CaseStudy:
    """Table III 'Switch-less Dragonfly' row: n=12, m=4, a=4, b=8.

    0 switches; 8 wafers/cabinet -> ceil(545*8/8)=545 cabinets; inter-cabinet
    cables are the global links only (W-group = 1 cabinet), local intra-
    W-group links are intra-cabinet.
    """
    from .topology import paper_table3_switchless
    p = p or paper_table3_switchless()
    g = p.g_max
    n_wafers = g * p.b
    cabinets = n_wafers // p.b  # one W-group (8 wafers) per cabinet
    global_links = g * (g - 1) // 2
    local_links = g * (p.ab * (p.ab - 1) // 2)
    return CaseStudy(
        name="switchless-dragonfly", num_switches=0, num_cabinets=cabinets,
        num_processors=total_chiplets(p),
        cable_count=global_links + local_links,
        cable_length_E=72e3,
        t_local=local_throughput_bound(p), t_global=1.0)


# --- Fig. 15 energy model ----------------------------------------------------

def energy_per_packet_pj_per_bit(hops_by_type: dict[str, float]) -> float:
    """Average transmission energy from per-type average hop counts.

    hops_by_type keys: 'mesh' (intra-C-group, priced at cg_avg=1 pj/bit per
    Sec. V-C), 'local'/'global' (20 pj/bit), 'inject'/'eject'.
    Switch-based terminal links (inject/eject over cables) cost 20 pj/bit;
    switch-less inject/eject are on-chip (0.1 pj/bit).
    """
    e = HOP_ENERGY_PJ_PER_BIT
    total = 0.0
    total += hops_by_type.get("mesh", 0.0) * e["cg_avg"]
    total += hops_by_type.get("local", 0.0) * e["local"]
    total += hops_by_type.get("global", 0.0) * e["global"]
    total += hops_by_type.get("term_cable", 0.0) * e["local"]
    total += hops_by_type.get("term_onchip", 0.0) * e["on_chip"]
    return total


# --- sanity helpers ----------------------------------------------------------

def summarize(p: SwitchlessParams) -> dict:
    return dict(
        a=p.a, b=p.b, m=p.m, n=p.n, k=p.k, ab=p.ab, h=p.h,
        g_max=p.g_max, N=total_chiplets(p),
        T_global=global_throughput_bound(p),
        T_local=local_throughput_bound(p),
        T_cg=cgroup_throughput_bound(p),
        B_cg=cgroup_bisection(p),
        balanced=is_balanced_config(p),
        diameter=switchless_diameter(p),
    )


def dragonfly_scale(p: SwitchDragonflyParams) -> dict:
    return dict(groups=p.num_groups, chips=p.num_chips, radix=p.radix)
