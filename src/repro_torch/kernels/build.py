"""Build CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at the
root of the checkout (``.gitignore`` lists it).  The library's name carries a
hash of the source, of the headers it includes (``common/csrc/hopper.cuh``)
and of the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["Built", "BUILD_DIR", "NVCC_FLAGS", "build", "nvcc_path", "sources"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    name: str
    lib: ctypes.CDLL
    seconds: float  # compile time; 0.0 when an earlier build was loaded
    log: str  # nvcc's output (ptxas register and shared-memory report)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(source: Path) -> list[Path]:
    """``source`` and every header it includes by a quoted path, resolved
    relative to the including file, recursively."""
    found, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [(path.parent / inc.decode()).resolve()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def _library_path(name: str, source: Path) -> Path:
    text = b"".join(path.read_bytes() for path in sources(source))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, source: Path) -> Built:
    """Compile ``source`` (unless this exact source was built before) and
    load it.  Raises with nvcc's output when the compiler refuses it."""
    source = Path(source)
    out = _library_path(name, source)
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} ({source}):\n{log}")
        os.replace(tmp, out)
    return Built(name, ctypes.CDLL(str(out)), seconds, log)

