"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file (``group_pass.cu``, ``gather_combine.cu``) is
compiled by its own ``nvcc -c``, all started together, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``; ``SIGNATURES`` declares its entry points. The build happens at the
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

from ..utils.profiling import build_span

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _run_together(cmds) -> tuple:
    """Run the commands side by side; return (log, all succeeded)."""
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    log = f"# {time.perf_counter() - t0:.2f} s\n" + "".join(
        f"$ {' '.join(c)}\n# exit {p.returncode}\n{o}"
        for c, p, o in zip(cmds, procs, outs)
    )
    return log, all(p.returncode == 0 for p in procs)


def build() -> Path:
    """Compile the sources unless their library exists; return its path.

    One ``nvcc -c`` per source, all started together, then one link. The
    compilers' report (registers, spills) is kept beside the library as
    ``<library>.log``. A compile is timed as the span ``kernels.build``."""
    so = library_path()
    if so.exists():
        return so
    with build_span("kernels.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
        srcs = _sources()
        objs = [str(BUILD_DIR / f"{tag}.{src.stem}.o") for src in srcs]
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        log, ok = _run_together(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
             for src, obj in zip(srcs, objs)]
        )
        if ok:
            link_log, ok = _run_together(
                [[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]]
            )
            log += link_log
        so.with_suffix(".log").write_text(log)
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        if not ok:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        return so


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process),
    timed as the span ``kernels.load`` (the build within it as
    ``kernels.build``)."""
    with build_span("kernels.load"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
# Every exported kernel entry point and its C arguments: pointers and the
# stream as c_void_p, sizes as c_int64 (ctypes would cut an undeclared
# pointer to 32 bits).
SIGNATURES = {
    **{
        f"group_pass_{t}": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR, _PTR]
        for t in ("f32", "bf16", "f64")
    },
    **{
        # vals, tri, tiles, ntiles, dim, M, heads, x, corr, scale (r!), work,
        # capacity, result, stream
        f"group_eval_{t}": [_PTR] * 3 + [_I64] * 2 + [_PTR] * 4
        + [ctypes.c_double, _PTR, _I64, _PTR, _PTR]
        for t in ("f32", "bf16", "f64")
    },
    **{
        # a, b, w, idx_a, idx_b, R, n_out, n_a, n_b, items, threads, out,
        # stream
        f"gather_combine_{t}": [_PTR] * 5 + [_I64] * 4 + [ctypes.c_int] * 2
        + [_PTR, _PTR]
        for t in ("f32", "bf16", "f16", "f64")
    },
}
