"""Native (C++) table generation on the host.

The counterpart of ``symtensor_tpu/native/__init__.py``. ``csrc/tablegen.cpp``
(a byte-equal copy of the JAX package's source) holds the O(n·r) host loops
that gate a first call at large (rank, dim): representative enumeration,
multiplicities and σ-class ids, packed positions, the dense gather map and
the insert table. It is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into ``symtensor_tpu_torch/_build/``, under a name that carries a
hash of the source and flags (the rule of ``kernels/_build.py``), and bound
with ``ctypes``. Every entry point has a NumPy build in ``utils/`` that it is
tested bit-identical to, and returns ``None`` when the library is not
there, so ``utils/tables.py`` falls back to NumPy.

``SYMTENSOR_NO_NATIVE=1`` disables the library (read at every call). A
failed compile or load is counted and warned once through
``utils.profiling.count_fallback("native_tablegen")``; it is never silent.

``utils/tables.py`` takes ``gflat_rep`` and ``row_stats`` from here;
``dense_gather`` and ``insert_table`` are bound and tested but slower than
the NumPy builds on the H100's host (PERF.md). The library writes
int32 for ``gflat_rep``, ``dense_gather`` and ``insert_table``, so their
positions stop short of 2**31: a caller widens them to int64.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .utils.profiling import count_fallback

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "tablegen.cpp"
BUILD_DIR = _PKG / "_build"
# No -march=native: a built library may travel with a copied checkout.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FALLBACK_SITE = "native_tablegen"

_lock = threading.Lock()
# library path -> loaded library, or None after a failed build or load
_loaded: dict = {}


def library_path() -> Path:
    """Where the library of the current source lives once built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"tablegen_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile to a private name, then move it into place atomically, so
    that processes building at once never load a partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    for name, args in {
        "st_indep_size": [i32, i32],
        "st_gflat_rep": [i32, i32, i32p],
        "st_row_stats": [i32p, i64, i32, i32p, i32, f32p, i32p],
        "st_position": [i32p, i64, i32, i32, i64p],
        "st_dense_gather": [i32, i32, i32p],
        "st_insert_table": [i32p, i64, i32, i32, i32p],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("SYMTENSOR_NO_NATIVE"):
        return None
    so = library_path()
    with _lock:
        if so not in _loaded:
            try:
                if not so.exists():
                    _build(so)
                _loaded[so] = _bind(ctypes.CDLL(str(so)))
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", None) or e
                count_fallback(FALLBACK_SITE,
                               f"(g++ build or load failed: {detail}; NumPy "
                               "tables instead)")
                _loaded[so] = None
        return _loaded[so]


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def gflat_rep(rank: int, dim: int) -> Optional[np.ndarray]:
    """(n, rank) int32: the representative multiset of every packed
    position, in gflat order (rank ≥ 2)."""
    lib = _load()
    if lib is None or rank < 2:
        return None
    n = lib.st_indep_size(rank, dim)
    out = np.empty((n, rank), dtype=np.int32)
    got = lib.st_gflat_rep(rank, dim, _ptr(out, ctypes.c_int32))
    return out if got == n else None


def row_stats(rep: np.ndarray, rank: int, classes) -> Optional[tuple]:
    """(γ float32, σ-class id int32) of ascending rows; `classes` are the
    descending count tuples of ``perm_classes(rank)``. γ is exact while
    rank! < 2**24 (rank ≤ 10)."""
    lib = _load()
    if lib is None:
        return None
    rep32 = np.ascontiguousarray(rep, dtype=np.int32)
    n = len(rep32)
    cls = np.zeros((len(classes), rank), dtype=np.int32)
    for i, c in enumerate(classes):
        cls[i, : len(c)] = c
    gamma = np.empty(n, dtype=np.float32)
    cid = np.empty(n, dtype=np.int32)
    got = lib.st_row_stats(_ptr(rep32, ctypes.c_int32), n, rank,
                           _ptr(cls, ctypes.c_int32), len(classes),
                           _ptr(gamma, ctypes.c_float), _ptr(cid, ctypes.c_int32))
    return (gamma, cid) if got == n else None


def position(rows: np.ndarray, rank: int, dim: int) -> Optional[np.ndarray]:
    """int64 packed positions of ascending rows (rank ≥ 2)."""
    lib = _load()
    if lib is None or rank < 2:
        return None
    rows32 = np.ascontiguousarray(rows, dtype=np.int32)
    out = np.empty(len(rows32), dtype=np.int64)
    got = lib.st_position(_ptr(rows32, ctypes.c_int32), len(rows32), rank,
                          dim, _ptr(out, ctypes.c_int64))
    return out if got == len(rows32) else None


def dense_gather(rank: int, dim: int) -> Optional[np.ndarray]:
    """(dim**rank,) int32: the packed position of sort(I) for every dense
    index I in C order (rank ≥ 1)."""
    lib = _load()
    if lib is None:
        return None
    total = dim**rank
    out = np.empty(total, dtype=np.int32)
    got = lib.st_dense_gather(rank, dim, _ptr(out, ctypes.c_int32))
    return out if got == total else None


def insert_table(reps: np.ndarray, k: int, dim: int) -> Optional[np.ndarray]:
    """(N_k, dim) int32: the rank-(k+1) position of sort(J ∪ {i}) for every
    row J of `reps` (N_k, k) and every value i."""
    lib = _load()
    if lib is None:
        return None
    reps32 = np.ascontiguousarray(reps, dtype=np.int32)
    out = np.empty((len(reps32), dim), dtype=np.int32)
    got = lib.st_insert_table(_ptr(reps32, ctypes.c_int32), len(reps32), k,
                              dim, _ptr(out, ctypes.c_int32))
    return out if got == len(reps32) * dim else None
