"""The findings model every analysis pass reports through (port of
`repro.analysis.findings`).

A `Finding` is one verified fact about the port or a spec: an `error`
(an invariant is broken), a `warning` (legal but almost certainly not
what the author meant — e.g. a registered fused scenario whose packed
grant key would overflow int32 in the reference), or an `info` note
(what the pass proved, so a clean run still documents its coverage).
`Report` collects them across passes, applies the allowlist (suppressed
findings stay in the report as `info` with their suppression reason —
nothing silently disappears), renders the human table, and serializes
the JSON report.

Exit-code contract (`Report.failed`): any unsuppressed error OR warning
fails the gate, as in the reference.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    """One fact one pass established.

    pass_name  "spec" | "compile" | "capacity" | "step" | "serve" | "lint"
               | "check"
    rule       stable rule id (REPRO001.., SPEC_*, COMPILE_*, CAP_*,
               STEP_*, SERVE_*)
    severity   "error" | "warning" | "info"
    location   "path/to/file.py:123" or "scenario:fig11" — whatever the
               pass can anchor the finding to
    message    one human sentence
    suppressed / suppress_reason: set by the allowlist, never by passes
    """

    pass_name: str
    rule: str
    severity: str
    location: str
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")

    @property
    def gates(self) -> bool:
        """True when this finding fails the gate."""
        return (self.severity in ("error", "warning")
                and not self.suppressed)

    def render(self) -> str:
        tag = f"{self.severity.upper()}"
        if self.suppressed:
            tag = f"allowed({self.suppress_reason})"
        return f"[{self.pass_name}:{self.rule}] {tag} {self.location}: " \
               f"{self.message}"


@dataclass
class Report:
    """All findings of one `repro_torch.analysis.check` invocation."""

    findings: list = field(default_factory=list)
    passes_run: list = field(default_factory=list)

    def add(self, pass_name: str, rule: str, severity: str, location: str,
            message: str) -> Finding:
        f = Finding(pass_name, rule, severity, location, message)
        self.findings.append(f)
        return f

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def mark_pass(self, name: str) -> None:
        if name not in self.passes_run:
            self.passes_run.append(name)

    def apply_allowlist(self, allowlist) -> None:
        """Suppress matching error/warning findings (they remain in the
        report, tagged with the entry's reason)."""
        for f in self.findings:
            if f.severity == "info" or f.suppressed:
                continue
            entry = allowlist.match(f)
            if entry is not None:
                f.suppressed = True
                f.suppress_reason = entry.reason

    @property
    def gating(self) -> list:
        return [f for f in self.findings if f.gates]

    @property
    def failed(self) -> bool:
        return bool(self.gating)

    def to_dict(self) -> dict:
        sev = {s: sum(1 for f in self.findings
                      if f.severity == s and not f.suppressed)
               for s in SEVERITIES}
        return dict(
            passes_run=list(self.passes_run),
            counts=dict(total=len(self.findings), gating=len(self.gating),
                        suppressed=sum(1 for f in self.findings
                                       if f.suppressed), **sev),
            failed=self.failed,
            findings=[asdict(f) for f in self.findings])

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "Report":
        """The report a `to_dict` (or the JSON it wrote) describes."""
        return cls(findings=[Finding(**f) for f in d["findings"]],
                   passes_run=list(d["passes_run"]))

    def render(self, verbose: bool = False) -> str:
        """Human summary: gating findings always, the full proof log
        with `verbose`."""
        lines = []
        shown = self.findings if verbose else [
            f for f in self.findings if f.gates or f.suppressed]
        lines += [f.render() for f in shown]
        n = self.to_dict()["counts"]
        lines.append(
            f"passes: {', '.join(self.passes_run) or '(none)'} — "
            f"{n['total']} findings ({n['error']} errors, "
            f"{n['warning']} warnings, {n['suppressed']} allowlisted)")
        lines.append("FAILED" if self.failed else "OK")
        return "\n".join(lines)
