"""Build and load the hand-written CUDA sketch kernels.

``csrc/sketch_kernels.cu`` has a plain C interface; it is compiled at first
use by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source and the flags so an edited source rebuilds, and loaded with
``ctypes``. A file lock guards the build against concurrent processes. A
missing ``nvcc`` or a failed build raises: there is no fallback.
``compile_library`` also builds another source with the same interface
(``time_kernels.py`` times such a build against the checkout's).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "sketch_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA sketch kernels cannot be built")


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def compile_library(source: Path = SOURCE) -> tuple[Path, str]:
    """Build ``source`` with the kernels' nvcc flags unless it is built
    already; returns the library's path and nvcc's output ("" when nothing
    was built)."""
    so = library_path(source)
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so, ""
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {source.name}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            return so, proc.stdout + proc.stderr
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def bind(so: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its two C entries."""
    lib = ctypes.CDLL(str(so))
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p]
    for name in ("sketch_accumulate", "sketch_query"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            so, log = compile_library()
            build_log = log or build_log
            _lib = bind(so)
        return _lib
