"""Protocol-exhaustiveness pass: the edges where FSMs rot.

Over the port's ``src/repro_torch/core``.  Three reconciliations, all
cheap to check and all historically the
first thing to silently drift as a protocol grows:

* ``opcode-coverage`` — every opcode declared in ``core/packet.py``
  (``OPCODE_NAMES``) is handled somewhere: payload opcodes flow to the
  RX engines (``PAYLOAD_OPS`` membership), control opcodes are
  dispatched by name in ``RdmaNode.on_packets``'s ``p.opcode ==
  pk.<OP>`` chain (read straight from the AST so a deleted branch is
  caught even though the ``else`` swallows it at run time).  The
  reverse direction too: a dispatch arm naming an undeclared opcode.
* ``event-kinds`` — every ``FlightRecorder`` emit site
  (``.record(tick, "<kind>", ...)`` / ``._rec("<kind>", ...)``) uses a
  kind registered in ``telemetry.EVENT_KINDS``, and every registered
  kind is emitted somewhere (a dead kind is a renamed emit site).
* ``counter-reconcile`` — ``pipeline.COUNTER_FIELDS`` (the columns the
  engines carry), ``rdma.ENGINE_COUNTERS`` (the harvest map)
  and ``NodeStats`` (the host mirror) agree by name.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import List, Set, Tuple

from repro_torch.analysis.violations import REPO_ROOT, Violation, relpath

CORE = REPO_ROOT / "src" / "repro_torch" / "core"


def _parse(path: Path) -> ast.AST:
    return ast.parse(path.read_text(), filename=str(path))


# --------------------------------------------------------------------------
# opcode coverage
# --------------------------------------------------------------------------

def _dispatched_constant_names(rdma_tree: ast.AST) -> Tuple[Set[str], int]:
    """Packet-module constant names the ``RdmaNode.on_packets`` dispatch
    tests ``p.opcode`` against — both equality arms (``p.opcode ==
    pk.ACK``) and membership arms (``p.opcode in pk.PAYLOAD_OPS``)."""
    names: Set[str] = set()
    line = 0
    for node in ast.walk(rdma_tree):
        if isinstance(node, ast.FunctionDef) and node.name == "on_packets":
            line = node.lineno
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Compare):
                    continue
                sides = [sub.left] + list(sub.comparators)
                opcode_side = any(
                    isinstance(s, ast.Attribute) and s.attr == "opcode"
                    for s in sides)
                if not opcode_side:
                    continue
                for s in sides:
                    if isinstance(s, ast.Attribute) and s.attr != "opcode" \
                            and s.attr.isupper():
                        names.add(s.attr)
    return names, line


def check_opcodes() -> List[Violation]:
    from repro_torch.core import packet as pk
    out: List[Violation] = []
    rdma_path = CORE / "rdma.py"
    dispatched, line = _dispatched_constant_names(_parse(rdma_path))
    if not dispatched:
        return [Violation("opcode-coverage", relpath(rdma_path), 0,
                          "could not locate the on_packets opcode "
                          "dispatch chain")]
    declared = dict(pk.OPCODE_NAMES)

    # resolve each dispatched constant: an int covers one opcode, a
    # tuple (e.g. PAYLOAD_OPS) covers all its members
    host_covered: Set[int] = set()
    for name in sorted(dispatched):
        val = getattr(pk, name, None)
        if isinstance(val, int):
            host_covered.add(val)
            if val not in declared:
                out.append(Violation(
                    "opcode-coverage", relpath(rdma_path), line,
                    f"on_packets dispatches `pk.{name}` (0x{val:02X}) "
                    "which core/packet.py does not declare in "
                    "OPCODE_NAMES"))
        elif isinstance(val, (tuple, list, set, frozenset)):
            host_covered.update(v for v in val if isinstance(v, int))
        else:
            out.append(Violation(
                "opcode-coverage", relpath(rdma_path), line,
                f"on_packets dispatches `pk.{name}` which "
                "core/packet.py does not define"))

    # engines consume the payload stream on_packets forwards to them
    engine_covered = set(pk.PAYLOAD_OPS)
    for opcode, name in sorted(declared.items()):
        if opcode not in engine_covered and opcode not in host_covered:
            out.append(Violation(
                "opcode-coverage", relpath(CORE / "packet.py"), 0,
                f"opcode {name} (0x{opcode:02X}) has no handler: not in "
                "PAYLOAD_OPS (RX engines) and not dispatched in "
                "rdma.on_packets"))
    return out


# --------------------------------------------------------------------------
# event kinds
# --------------------------------------------------------------------------

def _emit_sites(tree: ast.AST, path: Path) -> List[Tuple[str, int]]:
    """(kind, line) for every recorder emit in one module:
    ``<recorder>.record(tick, "<kind>", ...)``, ``<self>._rec("<kind>",
    ...)`` and the netsim queue hooks ``on_event("<kind>", ...)`` (which
    forward into ``record``)."""
    sites: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
        elif isinstance(node.func, ast.Name):
            attr = node.func.id
        else:
            continue
        pos = (1 if attr == "record"
               else 0 if attr in ("_rec", "on_event") else None)
        if pos is None or len(node.args) <= pos:
            continue
        arg = node.args[pos]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            sites.append((arg.value, node.lineno))
    return sites


def check_event_kinds() -> List[Violation]:
    from repro_torch.core import telemetry as tm
    out: List[Violation] = []
    registered = set(tm.EVENT_KINDS)
    emitted: Set[str] = set()
    src_root = REPO_ROOT / "src" / "repro_torch"
    for path in sorted(src_root.rglob("*.py")):
        if "__pycache__" in path.parts or path.name == "telemetry.py":
            continue
        for kind, line in _emit_sites(_parse(path), path):
            emitted.add(kind)
            if kind not in registered:
                out.append(Violation(
                    "event-kinds", relpath(path), line,
                    f"emit site uses kind `{kind}` not registered in "
                    "telemetry.EVENT_KINDS"))
    for kind in sorted(registered - emitted):
        out.append(Violation(
            "event-kinds", relpath(CORE / "telemetry.py"), 0,
            f"EVENT_KINDS registers `{kind}` but no emit site in "
            "src/repro_torch uses it"))
    return out


# --------------------------------------------------------------------------
# counter reconciliation
# --------------------------------------------------------------------------

def check_counters() -> List[Violation]:
    from repro_torch.core import pipeline as pipe
    from repro_torch.core import rdma
    out: List[Violation] = []
    cols = set(pipe.COUNTER_FIELDS)
    harvest = set(rdma.ENGINE_COUNTERS)
    stats = {f.name for f in dataclasses.fields(rdma.NodeStats)}
    pipe_path = relpath(CORE / "pipeline.py")
    rdma_path = relpath(CORE / "rdma.py")

    for col in sorted(cols - harvest):
        out.append(Violation(
            "counter-reconcile", pipe_path, 0,
            f"engine counter column `{col}` rides the carried state but "
            "rdma.ENGINE_COUNTERS never harvests it"))
    for col in sorted(harvest - cols):
        out.append(Violation(
            "counter-reconcile", rdma_path, 0,
            f"ENGINE_COUNTERS harvests `{col}` but "
            "pipeline.COUNTER_FIELDS does not carry that column"))
    for col, host in sorted(rdma.ENGINE_COUNTERS.items()):
        if host not in stats:
            out.append(Violation(
                "counter-reconcile", rdma_path, 0,
                f"ENGINE_COUNTERS maps `{col}` -> NodeStats.{host}, "
                "which is not a NodeStats field"))
    missing = set(pipe.COUNTER_FIELDS) - set(pipe._STATE_FIELDS)
    for col in sorted(missing):
        out.append(Violation(
            "counter-reconcile", pipe_path, 0,
            f"COUNTER_FIELDS lists `{col}` but _STATE_FIELDS does not "
            "carry it through the FSM"))
    return out


def run() -> List[Violation]:
    return check_opcodes() + check_event_kinds() + check_counters()
