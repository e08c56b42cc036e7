"""Build the package's CUDA sources into plain-C shared libraries and load
them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use,
from the ``.cu`` files under ``sota_imagenet_tpu_torch/csrc/`` alone (a
wheel carries them: ``MANIFEST.in``), into ``sota_imagenet_tpu_torch/_build/``
(git-ignored) where the package's directory is writable, as in a checkout,
and else into a per-user cache, ``$XDG_CACHE_HOME`` (or ``~/.cache``)
``/sota_imagenet_tpu_torch/<hash of the package's path>`` (``build_dir``): one ``nvcc`` per source,
all started together, then one link. The file name carries a
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
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Sequence

from sota_imagenet_tpu_torch.utils.logging import get_logger

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"


def _writable(path: Path) -> bool:
    """Whether ``path`` (an existing directory, or one that can be made in its parent) takes new files."""
    while not path.exists():
        path = path.parent
    return os.access(path, os.W_OK | os.X_OK)


def build_dir(package_dir: Optional[Path] = None) -> Path:
    """Where the libraries are built: ``_build/`` beside the package's
    modules where that can be written (a checkout, or a wheel installed into
    a directory of the user's), else a per-user cache directory keyed by the
    package's path (a wheel in a read-only site-packages)."""
    package_dir = Path(package_dir or PACKAGE_DIR).resolve()
    local = package_dir / "_build"
    if _writable(local):
        return local
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
    return cache / "sota_imagenet_tpu_torch" / hashlib.sha256(str(package_dir).encode()).hexdigest()[:16]


@lru_cache(maxsize=None)
def _build_dir() -> Path:
    out = build_dir()
    if out != PACKAGE_DIR / "_build":
        get_logger().info(f"CUDA kernels: {PACKAGE_DIR} is read-only; building them into {out}")
    return out

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
    return _build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under csrc/) unless an up-to-date
    library exists; returns its path. Raises with nvcc's output on failure."""
    out = library_path(name, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    nvcc = find_nvcc()
    objects = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o") for src in sources]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    steps = [[nvcc, *compile_flags, "-c", "-o", str(obj), str(CSRC_DIR / src)] for src, obj in zip(sources, objects)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(steps)) as pool:
            procs = list(pool.map(lambda cmd: subprocess.run(cmd, capture_output=True, text=True), steps))
        link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(obj) for obj in objects)]
        if all(proc.returncode == 0 for proc in procs):
            steps.append(link)
            procs.append(subprocess.run(link, capture_output=True, text=True))
        for cmd, proc in zip(steps, procs):
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed building {name} ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    log = "".join(f"# {' '.join(cmd)}\n{proc.stdout}{proc.stderr}" for cmd, proc in zip(steps, procs))
    out.with_suffix(".log").write_text(f"# {time.perf_counter() - t0:.2f} s\n{log}")
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
