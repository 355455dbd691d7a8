"""Declarative spec for the dry-run roofline analysis: port of the
`RooflineSpec` value object of `repro.exp.roofline` (the benchmark that
lowers from it is not ported).

A frozen, validated, JSON-round-trippable value object naming the
roofline table's inputs: which dry-run cells, priced on which fabric.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FABRICS = ("switchless", "flat")
MESHES = ("single", "multi")


@dataclass(frozen=True)
class RooflineSpec:
    """One roofline table: which dry-run cells, priced on which fabric.

    mesh           artifact mesh tag ("single" | "multi")
    fabric         collective pricing model: the paper's switch-less wafer
                   fabric or the flat grading-spec ICI model
    cg_bw_mult     on-wafer bandwidth multiplier of the wafer fabric
                   (the paper's 1B/2B axis)
    artifacts_dir  override for the dry-run artifact directory ("" = the
                   repo default artifacts/dryrun)
    """

    mesh: str = "single"
    fabric: str = "switchless"
    cg_bw_mult: float = 1.0
    artifacts_dir: str = ""

    def __post_init__(self):
        if self.mesh not in MESHES:
            raise ValueError(f"unknown mesh {self.mesh!r}; valid: {MESHES}")
        if self.fabric not in FABRICS:
            raise ValueError(
                f"unknown fabric {self.fabric!r}; valid: {FABRICS}")
        if self.cg_bw_mult <= 0:
            raise ValueError(f"cg_bw_mult must be > 0, got {self.cg_bw_mult}")
        object.__setattr__(self, "cg_bw_mult", float(self.cg_bw_mult))

    def build_fabric(self):
        """The concrete `cost_model.Fabric` this spec prices with."""
        from ..core.cost_model import flat_ici_fabric, switchless_wafer_fabric
        if self.fabric == "flat":
            return flat_ici_fabric()
        return switchless_wafer_fabric(cg_bw_mult=self.cg_bw_mult)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RooflineSpec":
        return cls(**d)
