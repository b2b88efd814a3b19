"""balint — the BALBOA data-plane invariant checker, turned on the port.

Three pass families:

* trace purity (``torch._dynamo``): graph breaks, float64 tensors and
  host syncs in every registered data-plane entry point (the engines of
  ``core/pipeline.py``, the TX path, the kernels' plain versions);
* determinism (AST): wall clock, unseeded RNG (numpy's and torch's),
  set iteration, unsorted dict iteration on wire paths, mutable default
  args;
* protocol exhaustiveness: opcode coverage, event-kind registration,
  engine-counter reconciliation.

Beside them, ``census`` counts the port's host<->device call sites while
the fig6/fig10/fig11 workloads run (``--census``).

Run it::

    PYTHONPATH=src python -m repro_torch.analysis --strict

or from code::

    from repro_torch.analysis import run_analysis
    report = run_analysis()
    assert report.strict_ok
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional

from repro_torch.analysis.report import Report, render_json, render_text
from repro_torch.analysis.violations import (DEFAULT_BASELINE, REPO_ROOT,
                                             RULES, RULE_FAMILIES, Baseline,
                                             Violation, apply_suppressions)

PASS_FAMILIES = ("determinism", "purity", "protocol")
DEFAULT_PATHS = ("src/repro_torch",)


def run_analysis(paths: Optional[Iterable] = None,
                 passes: Optional[Iterable[str]] = None,
                 baseline_path: Optional[Path] = DEFAULT_BASELINE,
                 ) -> Report:
    """Run the selected pass families and reconcile with the baseline.

    ``paths`` scopes the AST determinism pass only — the purity and
    protocol passes address the port's registered entry points and
    cannot be pointed at fixtures."""
    passes = list(passes) if passes is not None else list(PASS_FAMILIES)
    violations: List[Violation] = []
    if "determinism" in passes:
        from repro_torch.analysis import determinism
        violations += determinism.run(paths or DEFAULT_PATHS)
    if "purity" in passes:
        from repro_torch.analysis import purity
        violations += purity.run()
    if "protocol" in passes:
        from repro_torch.analysis import protocol
        violations += protocol.run()
    violations = apply_suppressions(violations)
    if baseline_path is not None:
        baseline = Baseline.load(baseline_path)
    else:
        baseline = Baseline([])
    # a partial run must not expire entries its passes could never
    # re-produce (e.g. --passes determinism leaving purity debt alone)
    covered = set().union(*(RULE_FAMILIES.get(p, set()) for p in passes))
    baseline = Baseline([e for e in baseline.entries
                         if e.get("rule") in covered])
    active, baselined, expired = baseline.partition(violations)
    return Report(violations=active, baselined=baselined, expired=expired,
                  rules_run=passes)


__all__ = ["run_analysis", "Report", "Baseline", "Violation", "RULES",
           "REPO_ROOT", "render_text", "render_json"]
