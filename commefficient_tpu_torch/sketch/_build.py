"""Build and load the hand-written CUDA sketch kernels.

``csrc/sketch_kernels.cu`` has a plain C interface (four entries); it is compiled at first
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
    """Load a built kernel library and declare its C entries: the two whole-
    vector entries, and the tree accumulate where the source has it (an
    older build timed by ``time_kernels.py`` may not)."""
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    entries = {
        "sketch_accumulate": [ptr, ptr, ptr, ptr, i64, i64, i32, i64, ptr],
        "sketch_query": [ptr, ptr, ptr, ptr, i64, i64, i32, i64, ptr],
        # table, leaves (host int64 [3, count]), count, shifts, ks, d, c, r,
        # num_slabs, fresh, stream
        "sketch_accumulate_tree": [ptr, ptr, i32, ptr, ptr, i64, i64, i32, i64, i32, ptr],
        "sketch_tree_max_leaves": [],
    }
    for name, args in entries.items():
        if name not in ("sketch_accumulate", "sketch_query") and not hasattr(lib, name):
            continue
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
