"""Build the package's CUDA sources into plain-C shared libraries and load
them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use,
from the ``.cu`` files under ``sota_imagenet_tpu_torch/csrc/`` alone, into
``sota_imagenet_tpu_torch/_build/`` (git-ignored). The file name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The sources expose ``extern "C"`` launch
functions that take device pointers and a stream and return the
``cudaGetLastError()`` of the launch; nothing includes PyTorch's headers, so
a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills, kept in the .log beside the library
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit (the kernels are built at first use)")


def library_path(name: str, sources: Sequence[str]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under csrc/) unless an up-to-date
    library exists; returns its path. Raises with nvcc's output on failure."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(
        f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.2f} s\n{proc.stdout}{proc.stderr}"
    )
    os.replace(tmp, out)  # atomic: concurrent builders never load a half-written file
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (if needed) and load the library once per process. Libraries of
    different names build concurrently from several threads."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LOADED[name] = lib
        return lib
