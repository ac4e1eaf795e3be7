"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface (no PyTorch headers), so
one ``nvcc`` call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <lib>.so <source>.cu

The libraries go into ``build/repro_torch/`` at the repository root (ignored
by git), named by a hash of the source so an edited kernel is rebuilt and a
stale library is never loaded.  Nothing is built at import time: the first
launch builds, and `build_all` builds several sources at once, one ``nvcc``
process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[Path, ctypes.CDLL] = {}


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


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(Path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


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
