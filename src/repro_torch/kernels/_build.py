"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface (no PyTorch headers), so
one ``nvcc`` call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The libraries go into ``build/repro_torch/`` at the repository root (ignored
by git), named by a hash of the source and of the port's headers it
includes (``#include "..."``, followed from file to file, such as
``kernels/_mma.cuh``), so an edited kernel or header is rebuilt and a stale
library is never loaded.  Nothing is built at import time: the first launch
builds, and `build_all` builds several sources at once, one ``nvcc`` process
each, all started together.  `LOGS` keeps what the compiler printed for
each source built in this process (``-Xptxas -v``: registers, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the compiler's output for each source built in this process
LOGS: dict[Path, str] = {}

_LOADED: dict[Path, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built on this machine")
    return found


def included_files(source: Path) -> list[Path]:
    """``source`` and every file it includes by a quoted path, resolved
    against the including file's folder and followed from file to file,
    each once, in the order first met."""
    seen: list[Path] = []

    def visit(path: Path):
        path = path.resolve()
        if path in seen:
            return
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            visit(path.parent / name)

    visit(Path(source))
    return seen


def library_path(source: Path) -> Path:
    digest = hashlib.sha1()
    for path in included_files(source):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources) -> list[Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes at once; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in map(Path, sources):
        out = library_path(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            LOGS[src] = log
        else:
            os.unlink(tmp)
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [library_path(s) for s in map(Path, sources)]


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is None:
        (path,) = build_all([source])
        lib = _LOADED[source] = ctypes.CDLL(str(path))
    return lib
