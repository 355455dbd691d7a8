"""The analysis allowlist (port of `repro.analysis.allowlist`): every
suppression is an explicit, reasoned entry here or in a user-supplied
allowlist file — there is no inline `# noqa`-style escape, so the full
set of waived findings is auditable in one place.

An entry matches a finding when the rule id is equal and the finding's
location path ends with the entry's path (locations are
`path/to/file.py:LINE`; the entry path never carries a line number, a
waiver covers the file).  Matching findings stay in the report tagged
with the entry's reason; they stop gating.

File format (`--allowlist FILE`), one entry per line, the reference's:

    RULE  path/suffix.py  reason text until end of line
    # comments and blank lines are ignored

`DEFAULT_ENTRIES` is empty.  The reference's one standing waiver covers
its frozen seed baseline, `benchmarks/seed_reference.py`, a file outside
`src/repro_torch` that the port's lint does not scan.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AllowEntry:
    rule: str
    path: str       # suffix match against the finding's file path
    reason: str

    def matches(self, rule: str, path: str) -> bool:
        return rule == self.rule and path.endswith(self.path)


# The port's standing waivers: none.  An entry here is a documented debt,
# not a convenience.
DEFAULT_ENTRIES: tuple = ()


class Allowlist:
    def __init__(self, entries=DEFAULT_ENTRIES):
        self.entries = tuple(entries)

    def match(self, finding) -> AllowEntry | None:
        path = finding.location.rsplit(":", 1)[0]
        for e in self.entries:
            if e.matches(finding.rule, path):
                return e
        return None

    @classmethod
    def load(cls, path: str | None = None) -> "Allowlist":
        """Default entries, plus `path`'s if given."""
        entries = list(DEFAULT_ENTRIES)
        if path:
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split(None, 2)
                    if len(parts) < 3:
                        raise ValueError(
                            f"{path}:{i}: allowlist entries are "
                            f"'RULE path reason...', got {line!r}")
                    entries.append(AllowEntry(*parts))
        return cls(entries)
