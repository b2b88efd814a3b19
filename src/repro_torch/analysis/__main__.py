"""CLI: ``python -m repro_torch.analysis`` (balint over the port).

Exit status: 0 unless ``--strict`` and the run is not clean (new
violations, or expired baseline entries that must be pruned).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import (DEFAULT_BASELINE, PASS_FAMILIES, Baseline,
                                  render_json, render_text, run_analysis)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="balint: dynamo/AST invariant checker for the BALBOA "
                    "data plane of the PyTorch port")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined violation or any "
                         "expired baseline entry")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs for the AST determinism pass "
                         "(default: src/repro_torch)")
    ap.add_argument("--passes", nargs="*", choices=PASS_FAMILIES,
                    default=None,
                    help="run only these pass families")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="baseline ledger (default: "
                         "src/repro_torch/analysis/balint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline ledger entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to absorb every current "
                         "violation (then hand-edit the reasons)")
    ap.add_argument("--census", metavar="OUT.json", default=None,
                    help="run the host-sync census (one epoch per fig "
                         "workload, tick and fused arms) and write "
                         "BENCH_sync_census.json-shaped output; skips "
                         "the lint passes")
    ap.add_argument("--device", default=None,
                    help="device of the census run (default the card; "
                         "'cpu' to count on the host)")
    args = ap.parse_args(argv)

    if args.census:
        from repro_torch.analysis.census import run_census
        doc = run_census(device=args.device)
        with open(args.census, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        for fig, c in doc["census"].items():
            print(f"{fig}: {c['ticks']} ticks, "
                  f"{c['d2h_per_tick']} d2h/tick, "
                  f"{c['h2d_per_tick']} h2d/tick")
        return 0

    baseline_path = None if args.no_baseline else args.baseline
    report = run_analysis(paths=args.paths, passes=args.passes,
                          baseline_path=baseline_path)

    if args.write_baseline:
        merged = Baseline.load(args.baseline) if not args.no_baseline \
            else Baseline([])
        keep = {(e["rule"], e["path"], e["message"]): e
                for e in merged.entries}
        # drop expired, absorb new
        for e in report.expired:
            keep.pop((e["rule"], e["path"], e["message"]), None)
        for v in report.violations:
            keep.setdefault(v.fingerprint(),
                            {"rule": v.rule, "path": v.path,
                             "message": v.message,
                             "reason": "TODO: justify or fix"})
        Baseline(list(keep.values())).write(args.baseline)
        print(f"wrote {args.baseline} ({len(keep)} entries)")
        return 0

    print(render_json(report) if args.json else render_text(report))
    if args.strict and not report.strict_ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
