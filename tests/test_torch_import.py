"""The port stands alone: importing it never imports jax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "mktfhe_tpu_torch"
# every module of the package, found on disk, so that a new one is covered
MODULES = sorted(
    ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for path in PACKAGE.rglob("*.py")
)
SOURCES = [*sorted(PACKAGE.rglob("*.py")), ROOT / "chip_smoke.py"]


def test_module_list_covers_the_slices():
    for name in ("kernels.ntt", "kernels.fused_mx3", "kernels.fused_step", "kernels.batchminor",
                 "kernels.mx_ntt", "kernels.fused_mx2", "schemes.kms", "schemes.cggi", "bridge",
                 "schemes.lmss", "schemes.ccs", "native.chacha", "cli", "ciphertext.lev",
                 "kernels.natural", "utils", "utils.serialization", "utils.noise", "utils.profiling",
                 "parallel", "parallel.mesh", "parallel.shardmap", "parallel.launch"):
        assert f"mktfhe_tpu_torch.{name}" in MODULES


def test_port_imports_without_jax():
    code = "import importlib, sys\n"
    code += "".join(f"importlib.import_module({m!r})\n" for m in MODULES)
    code += "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
    code += "assert 'mktfhe_tpu' not in sys.modules\n"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_sources_never_name_jax():
    banned = ("import jax", "from jax", "import mktfhe_tpu.", "from mktfhe_tpu.", "from mktfhe_tpu ")
    for path in SOURCES:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(banned), f"{path}: {line}"
            assert stripped != "import mktfhe_tpu", f"{path}: {line}"


def _imported_roots(path: Path) -> set[str]:
    """Top-level packages named by any import statement of the file, at
    module level or inside a function (relative imports stay in the package)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_read_from_the_source(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "flax", "mktfhe_tpu"}, f"{path}: {sorted(roots)}"
    if path.name == "chip_smoke.py":  # the script drives the port, not a copy of it
        assert "mktfhe_tpu_torch" in roots and "torch" in roots
