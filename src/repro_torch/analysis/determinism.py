"""Determinism lint: the AST pass family.

The simulator's contract is *tick determinism* — same seed, same packet
schedule, byte-identical Perfetto traces (``tests/test_telemetry.py``
pins it).  Everything that can silently break that contract is lint:

* ``wall-clock``      — reading the wall clock inside the data plane;
* ``unseeded-rng``    — the global numpy RNG or an unseeded
                        ``default_rng()``;
* ``set-iteration``   — iterating a set (hash-randomized order);
* ``dict-order``      — unsorted dict iteration whose loop body reaches
                        the wire or the event recorder, in the modules
                        where emission order is semantics;
* ``mutable-default`` — mutable default arguments (state leaks across
                        calls and across tests).

The RNG rule also takes the port's own unseeded streams:
``torch.rand*`` (``rand``, ``randn``, ``randint``, ``randperm`` and their
``_like`` forms) called without a ``generator=``.

Scoping: inside ``src/repro_torch`` each rule applies only where the
hazard is real (the wall clock is fine in ``examples/`` and
``analysis/``; dict order is fine in a pure lookup table).  Paths
*outside* ``src/repro_torch`` — e.g. the lint's own test fixtures — get
every rule, so fixtures can exercise all of them without carve-outs.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

from repro_torch.analysis.violations import REPO_ROOT, Violation, relpath

# data-plane subtrees where wall-clock reads are forbidden (examples/
# and analysis/ legitimately measure wall time)
WALL_CLOCK_SCOPE = ("core", "kernels", "data")

# modules where iteration order IS wire/trace order
ORDER_SENSITIVE = {"netsim.py", "rdma.py", "collectives.py",
                   "retransmit.py", "flow_control.py", "ingest.py",
                   "qp.py"}

# calls that put bytes on the wire, mutate retransmit state, or emit
# telemetry events — reaching one from inside an unordered iteration
# makes the iteration order observable
WIRE_FNS = {"send", "_send", "_send_ctrl", "_send_retx", "_dispatch",
            "inject", "rdma_write", "rdma_read", "on_packets", "hold",
            "_bump", "_resend", "_emit_message", "record", "_rec",
            "_enqueue", "enqueue"}

WALL_CLOCK_CALLS = {("time", "time"), ("time", "monotonic"),
                    ("time", "perf_counter"), ("time", "process_time"),
                    ("time", "monotonic_ns"), ("time", "perf_counter_ns"),
                    ("time", "time_ns")}


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('np.random.shuffle')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _in_repro(path: Path) -> bool:
    return "repro_torch" in path.parts and "src" in path.parts


def _rule_applies(rule: str, path: Path) -> bool:
    if not _in_repro(path):
        return True                       # fixtures etc.: everything on
    parts = path.parts
    if rule == "wall-clock":
        return any(s in parts for s in WALL_CLOCK_SCOPE)
    if rule == "dict-order":
        return path.name in ORDER_SENSITIVE
    return True


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: Path):
        self.path = path
        self.rel = relpath(path)
        self.out: List[Violation] = []

    def _emit(self, rule: str, node: ast.AST, message: str):
        if _rule_applies(rule, self.path):
            self.out.append(Violation(rule, self.rel,
                                      getattr(node, "lineno", 0), message))

    # ---- wall-clock ----------------------------------------------------
    def _check_wall_clock(self, node: ast.Call):
        name = _dotted(node.func)
        parts = tuple(name.split("."))
        if len(parts) >= 2 and parts[-2:] in WALL_CLOCK_CALLS:
            self._emit("wall-clock", node,
                       f"wall-clock read `{name}()`")
        # argless datetime.now()/utcnow() (a tz-aware now(tz) is still
        # wall clock — flag both)
        if parts and parts[-1] in ("now", "utcnow", "today") \
                and "datetime" in parts:
            self._emit("wall-clock", node,
                       f"wall-clock read `{name}()`")

    # ---- unseeded-rng --------------------------------------------------
    def _check_rng(self, node: ast.Call):
        name = _dotted(node.func)
        parts = name.split(".")
        if len(parts) >= 3 and parts[-2] == "random" \
                and parts[-3] in ("np", "numpy"):
            leaf = parts[-1]
            if leaf == "default_rng":
                if not node.args and not node.keywords:
                    self._emit("unseeded-rng", node,
                               "unseeded `default_rng()` (OS-entropy "
                               "seed differs every run)")
            elif leaf not in ("Generator", "SeedSequence", "PCG64",
                              "Philox", "RandomState"):
                self._emit("unseeded-rng", node,
                           f"global numpy RNG `{name}()` — use a "
                           "`default_rng(seed)` stream")
        elif parts[-1] == "default_rng" and not node.args \
                and not node.keywords:
            self._emit("unseeded-rng", node,
                       "unseeded `default_rng()` (OS-entropy seed "
                       "differs every run)")
        elif len(parts) == 2 and parts[0] == "torch" \
                and parts[1].startswith("rand") \
                and not any(k.arg == "generator" for k in node.keywords):
            self._emit("unseeded-rng", node,
                       f"torch RNG `{name}()` without a `generator=` "
                       "draws from the global stream — pass a seeded "
                       "`torch.Generator`")

    def visit_Call(self, node: ast.Call):
        self._check_wall_clock(node)
        self._check_rng(node)
        self.generic_visit(node)

    # ---- set-iteration / dict-order ------------------------------------
    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub)) \
                and (self._is_set_expr(node.left)
                     or self._is_set_expr(node.right)):
            return True                   # set algebra stays a set
        return False

    def _is_dict_view(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("items", "keys", "values")
                and not node.args)

    def _body_reaches_wire(self, body: Iterable[ast.AST]) -> str:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    name = _dotted(sub.func)
                    leaf = name.split(".")[-1] if name else ""
                    if leaf in WIRE_FNS:
                        return leaf
        return ""

    def _check_iter(self, iter_node: ast.AST, loop: ast.AST,
                    body: Iterable[ast.AST]):
        if self._is_set_expr(iter_node):
            self._emit("set-iteration", loop,
                       "iteration over a set — order is "
                       "hash-randomized; sort it first")
        if self._is_dict_view(iter_node):
            wire = self._body_reaches_wire(body)
            if wire:
                view = iter_node.func.attr        # type: ignore[union-attr]
                owner = _dotted(iter_node.func.value)  # type: ignore
                self._emit(
                    "dict-order", loop,
                    f"unsorted `{owner or '<dict>'}.{view}()` iteration "
                    f"reaches the wire via `{wire}()` — iterate "
                    "`sorted(...)` so emission order is insertion-"
                    "history-free")

    def visit_For(self, node: ast.For):
        self._check_iter(node.iter, node, node.body)
        self.generic_visit(node)

    def visit_comprehension_set(self, node):
        for comp in node.generators:
            if self._is_set_expr(comp.iter):
                self._emit("set-iteration", node,
                           "comprehension over a set — order is "
                           "hash-randomized; sort it first")

    def visit_ListComp(self, node):
        self.visit_comprehension_set(node)
        self.generic_visit(node)

    def visit_GeneratorExp(self, node):
        self.visit_comprehension_set(node)
        self.generic_visit(node)

    # ---- mutable-default ----------------------------------------------
    def _check_defaults(self, node):
        a = node.args
        for arg, default in list(zip(a.args[::-1], a.defaults[::-1])) + [
                (kw, d) for kw, d in zip(a.kwonlyargs, a.kw_defaults) if d]:
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set", "bytearray"))
            if bad:
                self._emit("mutable-default", default,
                           f"mutable default for `{arg.arg}` in "
                           f"`{node.name}()` — use None and allocate "
                           "inside")

    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)


def lint_file(path: Path) -> List[Violation]:
    path = Path(path).resolve()
    try:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
    except (OSError, SyntaxError) as e:
        return [Violation("determinism-parse", relpath(path), 0,
                          f"cannot parse: {e}")]
    v = _Visitor(path)
    v.visit(tree)
    return v.out


def run(paths: Iterable[Path]) -> List[Violation]:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    out: List[Violation] = []
    for p in paths:
        p = Path(p)
        if not p.is_absolute():
            p = REPO_ROOT / p
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if "__pycache__" in f.parts:
                continue
            out.extend(lint_file(f))
    return out
