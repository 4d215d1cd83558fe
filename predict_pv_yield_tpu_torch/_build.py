"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library goes to
``build/torch_kernels/`` at the repository root, named by a hash of its
source, the ``csrc/*.cuh`` headers and the flags: a changed source or
header rebuilds, an unchanged one is reused.
Nothing is built at import time; the first call that needs a kernel builds
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: per kernel: {"seconds": build time (0.0 when reused), "log": nvcc output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    # the source and every header beside it, so that a changed header rebuilds
    files = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    source = b"".join(f.read_bytes() for f in files)
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        target = library_path(name)
        if target.exists():
            build_info[name] = {"seconds": 0.0, "log": ""}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build to a temporary name, then rename: a concurrent process
            # never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            start = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - start
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)
            build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
        _loaded[name] = ctypes.CDLL(str(target))
        return _loaded[name]
