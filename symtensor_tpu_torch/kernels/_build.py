"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file (``group_pass.cu``, ``gather_combine.cu``,
``batched_fold.cu``) is compiled by its own ``nvcc -c``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``; ``SIGNATURES`` declares its entry
points. The build happens at the first CUDA use, never at import, into
``symtensor_tpu_torch/_build/``. The library's name carries a hash of the
sources and flags, so an edited source builds anew and a stale library is
never loaded.

A missing ``nvcc`` or a failed build raises ``RuntimeError``: a CUDA
tensor never falls back to the plain versions.

The launch state the library's persistent kernels share lives here too:
``capacity``, the blocks a launch may keep resident, and ``work_buffer``,
one float64 buffer per stream whose last slot is the done counter that
``group_pass.cu``'s evaluation mode and ``batched_fold.cu`` both count
their blocks in (``done_counter``). Every launch finds the counter at zero
and its last block sets it back to zero.
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

import torch

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


@lru_cache(maxsize=None)
def capacity(index: int, per_sm: int = 1) -> int:
    """Blocks a persistent launch may run, one partial each: the resident
    blocks, `per_sm` a multiprocessor (``group_eval`` keeps one,
    ``batched_eval`` two)."""
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


_WORK: dict = {}


def work_buffer(dev: torch.device, stream: int) -> tuple:
    """``group_eval``'s work buffer for launches on `stream` and its
    capacity: the float64 partials, one a block, then the done counter,
    zeroed once here and set back to zero by the last block of every
    launch. Launches on one stream run in order, so they share it; each
    stream has its own."""
    key = (dev.index, stream)
    if key not in _WORK:
        cap = capacity(dev.index)
        _WORK[key] = (torch.zeros(cap + 1, dtype=torch.float64, device=dev), cap)
    return _WORK[key]


def done_counter(dev: torch.device, stream: int) -> torch.Tensor:
    """The done counter of ``work_buffer`` on `stream`, its last slot.
    ``batched_eval``'s launches count their blocks in it too: every launch
    finds it zero and leaves it zero, and launches on one stream run in
    order."""
    work, cap = work_buffer(dev, stream)
    return work[cap:]


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
    # vals, tri, M, x, heads, corr, tiles, nentries, B, Bp, N, dim, bm, bn,
    # scale (r!), partials, capacity, done, out, stream
    "batched_fold_f32": [_PTR] * 7 + [_I64] * 7 + [ctypes.c_double, _PTR, _I64]
    + [_PTR] * 3,
}
