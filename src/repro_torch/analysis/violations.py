"""Shared violation model for balint (the BALBOA invariant checker), as
the port runs it over ``src/repro_torch``.

Three concepts every pass speaks:

* ``Violation`` — one finding, fingerprinted by ``(rule, path, message)``
  so baselines survive unrelated line churn;
* suppressions — ``# balint: disable=<rule>[,<rule>...]`` comments, at
  line granularity when trailing code and at file granularity when the
  comment stands alone;
* ``Baseline`` — the committed ledger of *deliberate* violations
  (``src/repro_torch/analysis/balint_baseline.json``).  A baselined
  violation is reported but does not fail ``--strict``; a baseline
  entry that no longer matches anything is *expired* and DOES fail
  ``--strict``, so the ledger can only shrink as debt is paid down.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]

# rule id -> one-line contract
RULES: Dict[str, str] = {
    # determinism (AST) pass
    "wall-clock": "no wall-clock reads (time.time/perf_counter/"
                  "monotonic, argless datetime.now) in the data plane",
    "unseeded-rng": "no global numpy RNG (np.random.*), no unseeded "
                    "default_rng() and no torch.rand*/randn/randint "
                    "without a generator= — every stream is seeded",
    "set-iteration": "no iteration over sets — Python set order is "
                     "hash-randomized across runs",
    "dict-order": "no unsorted dict iteration on paths that put packets "
                  "on the wire or emit telemetry events",
    "mutable-default": "no mutable default arguments (list/dict/set)",
    # trace-purity (torch._dynamo) pass
    "graph-break": "data-plane entry points trace as one graph under "
                   "torch._dynamo (fullgraph): every break is listed "
                   "with its reason (the inventory for a CUDA-graph "
                   "capture of the engines)",
    "host-sync": "data-plane entry points read nothing back from the "
                 "device (.item/.tolist/.cpu/.numpy, int()/bool() of a "
                 "tensor) while they run",
    "f64-promotion": "no float64 tensors inside a traced entry point",
    "host-callback": "the reference's rule (no host callbacks embedded "
                     "in a jitted graph); an eager PyTorch entry embeds "
                     "none — its host round trips are graph-break and "
                     "host-sync findings — so this rule emits nothing",
    "missing-donation": "the reference's rule (state-carrying jitted "
                        "entries donate their table buffers); PyTorch's "
                        "eager calls have no donation, so this rule "
                        "emits nothing",
    "concretization": "entry points trace without raising (an error "
                      "while tracing that is not a graph break)",
    # protocol-exhaustiveness pass
    "opcode-coverage": "every opcode in core/packet.py has a handler in "
                       "the RX engines or the host rdma.py dispatch",
    "event-kinds": "every FlightRecorder emit site uses a kind in "
                   "EVENT_KINDS, and every registered kind is emitted",
    "counter-reconcile": "pipeline.COUNTER_FIELDS, rdma.ENGINE_COUNTERS "
                         "and NodeStats reconcile by name",
}


# which pass family owns each rule — a baseline entry only expires when
# the family that could re-produce it actually ran
RULE_FAMILIES: Dict[str, Set[str]] = {
    "determinism": {"wall-clock", "unseeded-rng", "set-iteration",
                    "dict-order", "mutable-default", "determinism-parse"},
    "purity": {"graph-break", "host-sync", "f64-promotion",
               "host-callback", "missing-donation", "concretization"},
    "protocol": {"opcode-coverage", "event-kinds", "counter-reconcile"},
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str              # repo-relative, '/'-separated
    line: int              # 1-based; 0 when the finding is file-global
    message: str

    def fingerprint(self) -> Tuple[str, str, str]:
        """Line numbers churn; (rule, path, message) identifies the
        finding across edits elsewhere in the file."""
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def relpath(p: Path) -> str:
    p = Path(p).resolve()
    try:
        return p.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return p.as_posix()


# --------------------------------------------------------------------------
# suppressions
# --------------------------------------------------------------------------

_DISABLE = re.compile(r"#\s*balint:\s*disable=([\w,\- ]+)")


class Suppressions:
    """Per-file suppression map parsed from ``# balint: disable=`` comments.

    A standalone comment line suppresses the named rules for the whole
    file; a trailing comment suppresses them for that line only."""

    def __init__(self, source: str):
        self.file_rules: Set[str] = set()
        self.line_rules: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(source.splitlines(), 1):
            m = _DISABLE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if text.strip().startswith("#"):
                self.file_rules |= rules
            else:
                self.line_rules.setdefault(lineno, set()).update(rules)

    def hides(self, v: Violation) -> bool:
        if v.rule in self.file_rules or "all" in self.file_rules:
            return True
        at = self.line_rules.get(v.line, ())
        return v.rule in at or "all" in at


_SUPPRESSION_CACHE: Dict[str, Suppressions] = {}


def suppressions_for(path: str) -> Suppressions:
    """Load (and cache) the suppression map for a repo-relative path."""
    if path not in _SUPPRESSION_CACHE:
        f = REPO_ROOT / path
        try:
            src = f.read_text()
        except OSError:
            src = ""
        _SUPPRESSION_CACHE[path] = Suppressions(src)
    return _SUPPRESSION_CACHE[path]


def apply_suppressions(violations: Iterable[Violation]) -> List[Violation]:
    return [v for v in violations if not suppressions_for(v.path).hides(v)]


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------

DEFAULT_BASELINE = Path(__file__).resolve().with_name("balint_baseline.json")


class Baseline:
    """Committed ledger of deliberate violations.

    Each entry is ``{"rule", "path", "message", "reason"}``; ``reason``
    is for humans (why this debt is deliberate, what retires it)."""

    def __init__(self, entries: Optional[List[dict]] = None):
        self.entries: List[dict] = entries or []

    @classmethod
    def load(cls, path: Path = DEFAULT_BASELINE) -> "Baseline":
        if not Path(path).exists():
            return cls([])
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("entries", []))

    def write(self, path: Path = DEFAULT_BASELINE) -> None:
        doc = {"comment": "deliberate balint debt of src/repro_torch; "
                          "entries expire (and fail --strict) once the "
                          "underlying violation is gone",
               "entries": self.entries}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")

    def _key(self, e: dict) -> Tuple[str, str, str]:
        return (e["rule"], e["path"], e["message"])

    def partition(self, violations: List[Violation]
                  ) -> Tuple[List[Violation], List[Violation], List[dict]]:
        """Split into (active, baselined, expired-baseline-entries)."""
        keys = {self._key(e): e for e in self.entries}
        active, baselined, matched = [], [], set()
        for v in violations:
            if v.fingerprint() in keys:
                baselined.append(v)
                matched.add(v.fingerprint())
            else:
                active.append(v)
        expired = [e for e in self.entries if self._key(e) not in matched]
        return active, baselined, expired

    @classmethod
    def from_violations(cls, violations: List[Violation],
                        reason: str = "TODO: justify or fix") -> "Baseline":
        entries = [{"rule": v.rule, "path": v.path, "message": v.message,
                    "reason": reason} for v in violations]
        return cls(entries)
