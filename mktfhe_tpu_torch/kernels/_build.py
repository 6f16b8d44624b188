"""Build and load the package's CUDA sources (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, in mktfhe_tpu_torch/_build/, and loaded with ctypes.  The
library is named by a hash of the source and of the headers beside it, so an
edited source is rebuilt.  There is no other way to a kernel: a missing nvcc
or a failed compilation raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills, kept beside the library
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build(source: Path) -> Path:
    """Compile `source` (a file of csrc/) for sm_90a unless the library for
    this source and its headers exists; returns the library path."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    lib = BUILD_DIR / f"libmktfhe_{source.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        lib.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _kernel_name(mangled: str) -> str:
    """`phase1_sweep_kernel<1,11,4,4,3>` out of a mangled entry name (a
    length-prefixed identifier that ends in `_kernel`, then its integral
    template arguments)."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end(): m.end() + int(m.group()[-2:])]
        if name.endswith("_kernel"):
            targs = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[m.end() + len(name):])
            args = re.findall(r"L[a-z](\d+)E", targs.group(1)) if targs else []
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def resource_usage(lib: Path) -> list[str]:
    """What ptxas reported when `lib` was built, one entry per kernel: its
    name with its template arguments, registers, spill bytes (stores + loads),
    stack frame (local memory, spills included) and static shared memory."""
    out, spill, stack, name = [], 0, 0, "?"
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if entry:
            name = _kernel_name(entry.group(1))
        if spills:  # comes on the line before the kernel's "Used ... registers"
            stack, spill = int(spills.group(1)), int(spills.group(2)) + int(spills.group(3))
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {used.group(1)} registers, {spill} spill bytes, {stack} bytes stack frame, "
                       f"{smem.group(1) if smem else 0} bytes static smem")
    return out


def build_all(sources) -> list[Path]:
    """Compile several sources at once, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build, sources))


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of `source`.  Every library
    exports `mktfhe_cuda_error_string`; the caller declares the rest."""
    lib = ctypes.CDLL(str(build(source)))
    lib.mktfhe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mktfhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.mktfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")
