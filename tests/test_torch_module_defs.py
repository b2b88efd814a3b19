"""No module of the port defines a function or a class twice at module
level: the second definition would shadow the first for every caller
that imports the name (``parallel/sharding.py`` once held two
``laid_out_as``, and ``models/moe.py`` reached the wrong one).  Read
with ``ast``; nothing is imported."""
import ast
from collections import Counter
from pathlib import Path

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MODULES = sorted(PORT.rglob("*.py"))


def _defined_twice(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = Counter(node.name for node in tree.body if isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)))
    return sorted(name for name, n in names.items() if n > 1)


def test_the_port_has_modules():
    assert len(MODULES) > 50
    assert PORT / "parallel" / "sharding.py" in MODULES


def test_no_module_level_name_is_defined_twice():
    twice = {str(p.relative_to(PORT)): _defined_twice(p) for p in MODULES}
    assert {p: names for p, names in twice.items() if names} == {}


def test_a_second_definition_is_found(tmp_path):
    """The check itself: a module defining ``f`` twice and ``C`` twice
    is caught; a method of the same name in a class is not a
    module-level definition."""
    mod = tmp_path / "m.py"
    mod.write_text("def f(x):\n    return x\n\n\nclass C:\n"
                   "    def f(self):\n        pass\n\n\n"
                   "def f(x, y):\n    return y\n\n\nclass C:\n    pass\n")
    assert _defined_twice(mod) == ["C", "f"]
