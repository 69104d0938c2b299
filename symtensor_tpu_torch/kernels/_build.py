"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at the
first CUDA use, never at import, into ``symtensor_tpu_torch/_build/``. The
library's name carries a hash of the sources and flags, so an edited
source builds anew and a stale library is never loaded.

A missing ``nvcc`` or a failed build raises ``RuntimeError``: a CUDA
tensor never falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills, kept in the build log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of symtensor_tpu_torch cannot be built"
    )


def _sources() -> list:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library of the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"symtensor_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless their library exists; return its path.
    The compiler's report (registers, spills) is kept beside it as
    ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (
        f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.2f} s, "
        f"exit {proc.returncode}\n{proc.stdout}{proc.stderr}"
    )
    so.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in ("group_pass_f32", "group_pass_bf16", "group_pass_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr, ptr]
        fn.restype = ctypes.c_int
    return lib
