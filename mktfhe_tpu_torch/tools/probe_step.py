"""Probe: what share of the CGGI step kernel's time its key rows and its
monomial images take.

Writes copies of this checkout's package under DIR in which
csrc/cggi_step.cu reads every step's key rows from step 0's ("keys": one
96 KB window that the SMs' L1 caches hold, where the kernel reads each
step's 96 KB once per gate, 15.5 GB from L2 for 256 gates and 630 steps) or
every gate's monomial image from a = 0's ("mono"), and times them beside
this tree with `time_sweeps --cggi`.
The copies compute other bits (time_sweeps reports them as not exact and
exits non-zero): they are probes, never a path, and the shipped source has
no switch for them.

Usage (one CUDA card):
  python -m mktfhe_tpu_torch.tools.probe_step _probe/step
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

# probe -> (line of csrc/cggi_step.cu, what the copy reads instead)
PROBES = {
    "keys": ("const uint32_t* key = brk + (static_cast<size_t>(step) * npr + q) * row_stride;",
             "const uint32_t* key = brk + static_cast<size_t>(q) * row_stride;"),
    "mono": ("const uint32_t* mon = mono + (static_cast<size_t>(a) * npr + q) * n;",
             "const uint32_t* mon = mono + static_cast<size_t>(q) * n;"),
}


def write_probes(root: Path) -> list[Path]:
    """One copy of the package per probe under `root`; returns the trees."""
    package = Path(__file__).resolve().parents[1]
    trees = []
    for name, (line, probe) in PROBES.items():
        tree = root / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(package, tree / package.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        source = tree / package.name / "csrc" / "cggi_step.cu"
        text = source.read_text()
        if text.count(line) != 1:
            raise SystemExit(f"probe {name}: the line to replace is not in {source.name} once")
        source.write_text(text.replace(line, probe))
        trees.append(tree)
    return trees


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = write_probes(Path(sys.argv[1]).resolve())
    command = [sys.executable, "-m", "mktfhe_tpu_torch.tools.time_sweeps", "--cggi"]
    for tree in trees:
        command += ["--tree", str(tree)]
    return subprocess.run(command, cwd=Path(__file__).resolve().parents[2]).returncode


if __name__ == "__main__":
    sys.exit(main())
