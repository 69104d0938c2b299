"""Serialization: a JSON codec, ``.npz`` files, and the reference payload.

The counterpart of ``symtensor_tpu/serialization.py``, for all five
formats:

- ``to_dict``/``from_dict`` and ``to_json``/``from_json``: {format, rank,
  dim, dtype, data}, with σ-classes under their labels, exactly the JAX
  package's layout;
- ``save``/``load``: one ``.npz`` file in the JAX package's layout (a
  ``__meta__`` JSON string and the same array names, read with
  ``allow_pickle=False``), so a file written by either package loads in
  the other. bfloat16 arrays are stored as the JAX package stores them,
  raw 2-byte records (NumPy has no bfloat16 of its own), and load back bit
  for bit;
- ``from_reference_json``, ``to_reference_payload``, ``to_reference_json``:
  the reference library's scityping ``Data`` payload.

Values move to the host with ``.cpu()``; loading puts them on `device`,
by default ``config.default_device``. Training state (a model's
``state_dict``, an optimizer's) is checkpointed with ``torch.save``.
"""

from __future__ import annotations

import json
import re
from typing import Union

import numpy as np
import torch

from .config import config
from .core.base import SymmetricTensor, as_torch_dtype, default_device, dtype_name, host
from .core.decomp import DecompSymmetricTensor
from .core.dense import DenseSymmetricTensor
from .core.flat import FlatSymmetricTensor
from .core.permcls import PermClsSymmetricTensor
from .core.sparse_flat import SparseFlatSymmetricTensor
from .utils import combinatorics as comb

# The format names of files and dicts, and the class of each: the one map
# from a name to a class (the JAX package's ``FORMATS``).
FORMATS = {
    "dense": DenseSymmetricTensor,
    "flat": FlatSymmetricTensor,
    "permcls": PermClsSymmetricTensor,
    "decomp": DecompSymmetricTensor,
    "sparse_flat": SparseFlatSymmetricTensor,
}

# NumPy's record type for bfloat16 values in a file: what np.save writes
# for the JAX package's (ml_dtypes) bfloat16 arrays
_BF16_RECORD = np.dtype("V2")


def _format(name: str):
    """The class of a format name, or TypeError."""
    try:
        return FORMATS[name]
    except KeyError:
        raise TypeError(f"unknown format {name!r}") from None


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, bfloat16 as raw 2-byte records."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """An array read from a file as a tensor on `device`; 2-byte records
    are bfloat16 bits."""
    a = np.asarray(a, order="C")  # keeps 0-d arrays 0-d
    if a.dtype == _BF16_RECORD or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _lists(t: torch.Tensor):
    """JSON-ready nested lists (bfloat16 values as the floats they are)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).tolist()


def to_dict(t: SymmetricTensor) -> dict:
    """JSON-ready dict representation."""
    head = {"format": t.format, "rank": t.rank, "dim": t.dim,
            "dtype": dtype_name(t.dtype)}
    if t.format in ("dense", "flat"):
        head["data"] = _lists(t.data)
    elif t.format == "permcls":
        head["data"] = {comb.class_label(k): _lists(v) for k, v in t.data.items()}
    elif t.format == "decomp":
        head["data"] = {
            "weights": _lists(t.weights),
            "factors": _lists(t.factors),
            "multiplicities": list(t.multiplicities),
        }
    elif t.format == "sparse_flat":
        head["data"] = {"values": _lists(t.vals), "indices": _lists(t.rep)}
    else:
        raise TypeError(f"unknown format {t.format!r}")
    return head


def from_dict(d: dict, device=None) -> SymmetricTensor:
    fmt = d["format"]
    rank, dim = int(d["rank"]), int(d["dim"])
    dtype = as_torch_dtype(d["dtype"])
    data = d["data"]
    dev = _device(device)

    def tensor(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    cls = _format(fmt)
    if fmt in ("dense", "flat"):
        return cls._raw(rank, dim, tensor(data))
    if fmt == "permcls":
        # rank 0: the empty label maps to counts ()
        store = {comb.class_counts(label): tensor(v) for label, v in data.items()}
        return cls(rank, dim, store, dtype=dtype, device=dev)
    if fmt == "decomp":
        return cls._raw(
            rank, dim, tensor(data["weights"]), tensor(data["factors"]),
            tuple(data["multiplicities"]),
        )
    idx = torch.tensor(data["indices"], dtype=torch.int64).reshape(-1, rank)
    return cls.from_entries(rank, dim, idx, tensor(data["values"]), device=dev)


def to_json(t: SymmetricTensor) -> str:
    return json.dumps(to_dict(t))


def from_json(s: Union[str, bytes], device=None) -> SymmetricTensor:
    return from_dict(json.loads(s), device=device)


def _npz_path(path) -> str:
    """np.savez appends '.npz' to extensionless paths; normalize so that
    save/load agree for any input path."""
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def save(path, t: SymmetricTensor) -> None:
    """Write one tensor to a ``.npz`` file in the JAX package's layout."""
    arrays = {}
    meta = {"format": t.format, "rank": t.rank, "dim": t.dim}
    if t.format in ("dense", "flat"):
        arrays["data"] = _to_numpy(t.data)
    elif t.format == "permcls":
        meta["classes"] = [comb.class_label(k) for k in t.data]
        for k, v in t.data.items():
            arrays[f"class_{comb.class_label(k) or 'scalar'}"] = _to_numpy(v)
    elif t.format == "decomp":
        meta["multiplicities"] = list(t.multiplicities)
        arrays["weights"] = _to_numpy(t.weights)
        arrays["factors"] = _to_numpy(t.factors)
    elif t.format == "sparse_flat":
        arrays["values"] = _to_numpy(t.vals)
        arrays["indices"] = _to_numpy(t.rep)
    else:
        raise TypeError(f"unknown format {t.format!r}")
    np.savez(_npz_path(path), __meta__=json.dumps(meta), **arrays)


def load(path, device=None) -> SymmetricTensor:
    """Read a tensor that ``save`` (of either package) wrote, onto
    `device` (by default ``config.default_device``)."""
    dev = _device(device)
    with np.load(_npz_path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        fmt, rank, dim = meta["format"], meta["rank"], meta["dim"]

        def arr(name):
            return _from_numpy(z[name], dev)

        cls = _format(fmt)
        if fmt in ("dense", "flat"):
            return cls._raw(rank, dim, arr("data"))
        if fmt == "permcls":
            store = {comb.class_counts(label): arr(f"class_{label or 'scalar'}")
                     for label in meta["classes"]}
            return cls._raw(rank, dim, store)
        if fmt == "decomp":
            return cls._raw(rank, dim, arr("weights"), arr("factors"),
                            tuple(meta["multiplicities"]))
        return cls.from_entries(rank, dim, arr("indices").to(torch.int64),
                                arr("values"))


# --------------------------------------------------------------------------
# Reference (scityping) payload
# --------------------------------------------------------------------------


def _reference_class_indices(counts, dim):
    """Index tuples of one σ-class in the REFERENCE's storage order
    (σindex_iter): distinct values are assigned to the count groups left to
    right; each group's value scans ascending over unused values,
    restricted to values greater than the previous group's when the two
    groups have equal counts (equal-count groups are interchangeable, so
    only the ordered choice is a distinct index class)."""
    counts = tuple(int(c) for c in counts)
    if not counts:
        yield ()
        return
    if len(counts) > dim:
        return

    def rec(gi, prev, used):
        if gi == len(counts):
            yield ()
            return
        m = counts[gi]
        lo = prev + 1 if gi > 0 and counts[gi - 1] == m else 0
        for v in range(lo, dim):
            if v in used:
                continue
            for rest in rec(gi + 1, v, used | {v}):
                yield (v,) * m + rest

    yield from rec(0, -1, frozenset())


def _decode_reference_array(v, depth=0):
    """Tolerantly decode a scityping-style array payload: plain (nested)
    lists, scalars, ``{"data": …, "dtype": …}`` dicts, or the
    ``[type_name, payload]`` wrappers scityping emits for Serializable
    values."""
    if depth > 6:
        raise ValueError("reference payload nests too deep")
    if isinstance(v, dict):
        inner = v.get("data", v.get("value"))
        if inner is None:
            raise ValueError(f"cannot decode array payload keys={list(v)}")
        arr = _decode_reference_array(inner, depth + 1)
        dt = v.get("dtype")
        return arr.astype(np.dtype(dt)) if dt else arr
    if (
        isinstance(v, (list, tuple))
        and len(v) == 2
        and isinstance(v[0], str)
        and not isinstance(v[1], (int, float, str))
    ):
        return _decode_reference_array(v[1], depth + 1)
    return np.asarray(v)


def _class_positions(counts, rank: int, dim: int) -> np.ndarray:
    """Packed positions of one σ-class's index tuples, in the reference's
    order."""
    idx = np.array(list(_reference_class_indices(counts, dim)),
                   dtype=np.int64).reshape(-1, rank)
    srt = np.sort(idx, axis=1)
    if rank == 1 or not len(srt):
        return srt[:, 0] if rank else np.zeros(len(srt), np.int64)
    return comb.gflat_layout(rank, dim).position_array(srt)


def from_reference_json(payload, device=None) -> PermClsSymmetricTensor:
    """Import a tensor serialized by the REFERENCE library's scityping
    ``Data`` codec: ``(rank, dim, {str(σ-count-tuple): array})``, where
    JSON turns the tuple into a list and the σ-class keys into strings like
    ``"(2, 1)"``.

    Accepts a JSON string/bytes, the decoded dict (``{"rank": …, "dim": …,
    "data": {…}}``, extra keys ignored), the raw 3-element encode list, or
    a scityping ``[type_name, payload]`` wrapper of any of these. Class
    keys may be any string containing the count digits. Per-class value
    order follows the reference's σindex_iter enumeration, mapped index by
    index onto the packed layout. Classes absent from the payload are
    zero."""
    if isinstance(payload, (str, bytes)):
        payload = json.loads(payload)
    for _ in range(4):  # unwrap scityping [type_name, payload] layers
        if (isinstance(payload, (list, tuple)) and len(payload) == 2
                and isinstance(payload[0], str)):
            payload = payload[1]
        else:
            break
    if isinstance(payload, (list, tuple)) and len(payload) == 3:
        rank, dim, data = payload
    elif isinstance(payload, dict):
        low = {str(k).lower(): v for k, v in payload.items()}
        try:
            rank, dim, data = low["rank"], low["dim"], low["data"]
        except KeyError as e:
            raise ValueError(
                f"reference payload lacks {e.args[0]!r}; keys={list(payload)}"
            ) from None
    else:
        raise ValueError(f"unrecognized reference payload: {type(payload)}")
    rank, dim = int(rank), int(dim)
    if not isinstance(data, dict):
        raise ValueError("reference payload 'data' must be a class dict")

    # Decode every class first so that the staging buffer's type can keep
    # complex values.
    decoded = []
    out_dtype = None
    for key_str, arr_payload in data.items():
        counts = tuple(int(c) for c in re.findall(r"\d+", str(key_str)))
        if sum(counts) != rank:
            raise ValueError(
                f"σ-class key {key_str!r} has rank {sum(counts)}, "
                f"expected {rank}"
            )
        if any(a < b for a, b in zip(counts, counts[1:])):
            # the reference's classes are non-increasing multiplicities; a
            # key like "(1, 2)" would be enumerated in another order
            raise ValueError(
                f"σ-class key {key_str!r} is not in canonical "
                "(non-increasing) multiplicity order"
            )
        vals = _decode_reference_array(arr_payload)
        decoded.append((key_str, counts, vals))
        out_dtype = (vals.dtype if out_dtype is None
                     else np.promote_types(vals.dtype, out_dtype))
    complex_ = out_dtype is not None and np.issubdtype(out_dtype, np.complexfloating)
    flat = np.zeros((comb.indep_size(rank, dim),),
                    dtype=np.complex128 if complex_ else np.float64)
    for key_str, counts, vals in decoded:
        if rank == 0:
            flat[0] = vals.reshape(-1)[0]
            continue
        pos = _class_positions(counts, rank, dim)
        if vals.ndim == 0:
            vals = np.broadcast_to(vals, pos.shape)
        if vals.shape != pos.shape:
            raise ValueError(
                f"σ-class {key_str!r} expects {pos.shape[0]} values at "
                f"dim {dim}; payload has shape {vals.shape}"
            )
        flat[pos] = vals
    out_dtype = out_dtype or np.dtype(config.default_dtype)
    data = torch.from_numpy(flat.astype(out_dtype)).to(_device(device))
    return PermClsSymmetricTensor.from_flat(FlatSymmetricTensor._raw(rank, dim, data))


def to_reference_payload(t: SymmetricTensor) -> tuple:
    """Export a tensor in the REFERENCE library's ``Data.encode`` layout:
    ``(rank, dim, {str(σ-count-tuple): values})`` with every σ-class of
    the rank present and per-class values (NumPy arrays) in the
    reference's σindex_iter order. The inverse of
    :func:`from_reference_json`."""
    rank, dim = t.rank, t.dim
    flat = host(t.toflat().data)
    out = {}
    for counts in comb.perm_classes(rank):
        if rank == 0:
            out[str(counts)] = np.asarray(flat.reshape(-1)[0])
            continue
        out[str(counts)] = flat[_class_positions(counts, rank, dim)]
    return (rank, dim, out)


def to_reference_json(t: SymmetricTensor) -> str:
    """JSON form of :func:`to_reference_payload` (arrays as plain lists)."""
    rank, dim, data = to_reference_payload(t)
    return json.dumps(
        (rank, dim, {k: np.asarray(v).tolist() for k, v in data.items()})
    )
