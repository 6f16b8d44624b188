"""The port stands alone: importing it never imports jax or the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "mktfhe_tpu_torch",
    "mktfhe_tpu_torch.bridge",
    "mktfhe_tpu_torch.kernels._build",
    "mktfhe_tpu_torch.kernels.ntt",
    "mktfhe_tpu_torch.kernels.fused_mx3",
    "mktfhe_tpu_torch.kernels.batchminor",
    "mktfhe_tpu_torch.kernels.fused_step",
    "mktfhe_tpu_torch.schemes.cggi",
    "mktfhe_tpu_torch.schemes.kms",
    "mktfhe_tpu_torch.schemes.presets",
]


def test_port_imports_without_jax():
    code = "import importlib, sys\n"
    code += "".join(f"importlib.import_module({m!r})\n" for m in MODULES)
    code += "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
    code += "assert 'mktfhe_tpu' not in sys.modules\n"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_sources_never_name_jax():
    banned = ("import jax", "from jax", "import mktfhe_tpu.", "from mktfhe_tpu.", "from mktfhe_tpu ")
    for path in [*(ROOT / "mktfhe_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(banned), f"{path}: {line}"
            assert stripped != "import mktfhe_tpu", f"{path}: {line}"
