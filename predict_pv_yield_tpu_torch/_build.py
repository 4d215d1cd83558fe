"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Each ``csrc/<name>.cpp`` is host code
(the LZ4 codec) and is compiled the same way by the host compiler (``$CXX``,
else ``c++``). The library goes to ``build/torch_kernels/`` at the
repository root, named by a hash of its source, the ``csrc/*.cuh`` headers
(CUDA sources only) and the flags: a changed source or header rebuilds, an
unchanged one is reused. A failed build raises with the compiler's output.
Nothing is built at import time; the first call that needs a library builds
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
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: per library: {"seconds": build time (0.0 when reused), "log": compiler output}
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


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "c++"))
    if found:
        return found
    raise RuntimeError("no host C++ compiler ($CXX or c++) on PATH")


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` where it exists, else ``csrc/<name>.cpp``."""
    cuda = CSRC / f"{name}.cu"
    return cuda if cuda.exists() else CSRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    source = _source(name)
    if source.suffix == ".cu":
        # the source and every header beside it, so that a changed header rebuilds
        files, flags = [source, *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS
    else:
        files, flags = [source], HOST_FLAGS
    data = b"".join(f.read_bytes() for f in files)
    digest = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``csrc/<name>.cpp``,
    building it if needed."""
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
            source = _source(name)
            if source.suffix == ".cu":
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
            else:
                cmd = [_cxx(), *HOST_FLAGS, "-o", tmp, str(source)]
            start = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - start
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"{cmd[0]} failed for {source.name} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)
            build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
        _loaded[name] = ctypes.CDLL(str(target))
        return _loaded[name]
