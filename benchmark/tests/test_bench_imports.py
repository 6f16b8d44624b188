"""What the benchmark imports, by whole top-level module name: nothing of JAX
or of the JAX package anywhere (the port's name begins with the JAX
package's, so a prefix test would be wrong), and nothing of the package
under test in the reference."""

import ast
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        assert not _top_level_imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_package():
    for path in (BENCH / "reference").rglob("*.py"):
        imports = _top_level_imports(path)
        assert "mktfhe_tpu_torch" not in imports and not imports & set(harness.FORBIDDEN), path
        assert imports <= {"__future__", "dataclasses", "hashlib", "math", "torch"}, (path, imports)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "mktfhe_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mktfhe_tpu.schemes", sys)
    assert harness.forbidden_modules() == ["mktfhe_tpu"]
