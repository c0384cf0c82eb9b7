"""Build and load the hand-written CUDA sketch kernels.

``csrc/sketch_kernels.cu`` has a plain C interface; it is compiled at first
use by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source and the flags so an edited source rebuilds, and loaded with
``ctypes``. A file lock guards the build against concurrent processes. A
missing ``nvcc`` or a failed build raises: there is no fallback.
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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"sketch_kernels_{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if so.exists():
                return ""
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            return proc.stdout + proc.stderr
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            build_log = _compile(so)
        lib = ctypes.CDLL(str(so))
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_void_p]
        for name in ("sketch_accumulate", "sketch_query"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
