"""Reporters: render an analysis run for humans (text) or tools (JSON)."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from repro_torch.analysis.violations import Violation


@dataclasses.dataclass
class Report:
    violations: List[Violation]          # active (not baselined)
    baselined: List[Violation]           # matched a baseline entry
    expired: List[dict]                  # baseline entries with no match
    rules_run: List[str]

    @property
    def strict_ok(self) -> bool:
        """--strict contract: no new violations AND no stale baseline
        entries (paid-down debt must be pruned from the ledger)."""
        return not self.violations and not self.expired

    def to_dict(self) -> Dict:
        return {
            "strict_ok": self.strict_ok,
            "rules_run": self.rules_run,
            "violations": [v.to_dict() for v in self.violations],
            "baselined": [v.to_dict() for v in self.baselined],
            "expired_baseline_entries": self.expired,
        }


def render_json(report: Report) -> str:
    return json.dumps(report.to_dict(), indent=2)


def render_text(report: Report) -> str:
    lines: List[str] = []
    if report.violations:
        lines.append(f"{len(report.violations)} violation(s):")
        for v in sorted(report.violations,
                        key=lambda v: (v.path, v.line, v.rule)):
            lines.append(f"  {v.path}:{v.line}: [{v.rule}] {v.message}")
    else:
        lines.append("no violations")
    if report.baselined:
        lines.append(f"{len(report.baselined)} baselined (deliberate, "
                     "see src/repro_torch/analysis/balint_baseline.json):")
        for v in sorted(report.baselined,
                        key=lambda v: (v.path, v.line, v.rule)):
            lines.append(f"  {v.path}:{v.line}: [{v.rule}] {v.message}")
    if report.expired:
        lines.append(f"{len(report.expired)} EXPIRED baseline entr"
                     f"{'y' if len(report.expired) == 1 else 'ies'} "
                     "(violation gone — prune the ledger):")
        for e in report.expired:
            lines.append(f"  [{e['rule']}] {e['path']}: {e['message']}")
    lines.append(f"strict: {'ok' if report.strict_ok else 'FAIL'}")
    return "\n".join(lines)
