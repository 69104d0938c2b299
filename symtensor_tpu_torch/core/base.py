"""Abstract base for symmetric tensors over ``torch`` tensors.

The counterpart of ``symtensor_tpu/core/base.py``: the attributes
(``rank``, ``dim``, ``shape``, ``ndim``, ``indep_size``, ``dense_size``,
``data_alignment``, ``tables``, ``dtype``, ``device``), conversions
(``todense``/``toflat``/``topermcls``/``astype``/``to``/``copy``/
``transpose``), element, σ-class and partial indexing (trailing full
slices allowed), the functional updates ``A.at[...].set/add`` and
``set_*``/``add_*``, the host-side iterators (``indep_iter*``,
``permcls_*``, ``flat``/``flat_index``, ``keys``/``values``/``items``,
``__iter__``), ``memory_footprint``, and the arithmetic and comparison
operators (``+ - * / **`` with scalars and rank-0 broadcasting,
``allclose``, ``array_equal``, and ``==``/``!=`` refused), and the interop
hooks: NumPy ufuncs and functions on a tensor stay packed where the JAX
package keeps them packed (``__array_ufunc__``, ``__array_function__`` with
its table ``_array_function_impls``), ``np.asarray(A)`` densifies with a
warning (``__array__``), and a tensor is a pydantic field through the JSON
codec of ``serialization``. A tensor's data lives on one device, and its
tables are made on that device. Tensors are treated as immutable: updates
return new tensors.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..utils import combinatorics as comb
from ..utils.tables import Tables, tables


def default_dtype() -> torch.dtype:
    return getattr(torch, config.default_dtype)


def default_device() -> torch.device:
    """``config.default_device``; raises if it names CUDA and there is no
    CUDA device, rather than quietly making a CPU tensor."""
    dev = torch.device(config.default_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "symtensor_tpu_torch creates tensors on "
            f"config.default_device = {config.default_device!r}, and CUDA is "
            "not available: pass device='cpu' (or another device), or set "
            "symtensor_tpu_torch.config.default_device = 'cpu'"
        )
    return dev


def leaf_device(leaves, device=None) -> torch.device:
    """The one device of a tensor's storage: `device` if given, else that
    of the ``torch.Tensor`` leaves (which must agree), else
    ``config.default_device``."""
    if device is not None:
        return torch.device(device)
    devs = {v.device for v in leaves if isinstance(v, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(
            f"storage leaves lie on more than one device: {sorted(map(str, devs))}"
        )
    return devs.pop() if devs else default_device()


def dtype_name(dtype: torch.dtype) -> str:
    """NumPy's name of a torch dtype: 'float32', 'bfloat16', 'bool', …"""
    return str(dtype).removeprefix("torch.")


def as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a NumPy dtype or type, or a name
    ('float64', 'bfloat16'); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return out


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a tensor's values on the host (bfloat16 as
    float32, as ``host`` gives them)."""
    return np.dtype("float32" if dtype == torch.bfloat16 else dtype_name(dtype))


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a NumPy array (bfloat16 as float32: NumPy has
    no bfloat16 of its own)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def is_sharded(data) -> bool:
    """Whether `data` is a ``DTensor``: values split over a device mesh
    (``parallel.shard_flat``, ``basis_change_packed(..., mesh=...)``)."""
    if type(data) is torch.Tensor or not isinstance(data, torch.Tensor):
        return False
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(data, DTensor)


def require_local(op: str, *operands) -> None:
    """Raise ``TypeError`` if an operand (a tensor, or a symmetric tensor's
    values) is sharded over a device mesh: the ops outside
    ``symtensor_tpu_torch.parallel`` compute on whole values and would
    otherwise see one rank's shard as the tensor."""
    for t in operands:
        data = vars(t).get("data") if isinstance(t, SymmetricTensor) else t
        if is_sharded(data):
            raise TypeError(
                f"{op}: an operand's values are sharded over a device mesh (a "
                "DTensor); the parallel layer, symtensor_tpu_torch.parallel, "
                "computes on sharded tensors (poly_eval_batched_sharded, "
                "tensordot_sharded, basis_change_packed(mesh=...)); gather "
                "the values with parallel.sharding.full_values for any other op")


class SymmetricTensor:
    """Common API of all storage formats."""

    # Subclasses set this to a short format name.
    format: str = "abstract"

    rank: int
    dim: int

    # ------------------------------------------------------------ structure

    @property
    def tables(self) -> Tables:
        require_local("tables", self)
        return tables(self.rank, self.dim, self.device)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dim,) * self.rank

    @property
    def ndim(self) -> int:
        return self.rank

    @property
    def dense_size(self) -> int:
        return self.dim**self.rank

    @property
    def indep_size(self) -> int:
        """Number of independent components C(d+r−1, r)."""
        return comb.indep_size(self.rank, self.dim)

    @property
    def data_alignment(self) -> str:
        """Storage-layout tag: the format name, since every format stores
        independent components in one canonical order."""
        return self.format

    @property
    def perm_classes(self) -> Tuple[str, ...]:
        """σ-class labels, largest multiplicity first ('iii', 'iij', …)."""
        return tuple(comb.class_label(c) for c in comb.perm_classes(self.rank))

    @property
    def size(self) -> int:
        """Number of stored elements (format-specific)."""
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    # ------------------------------------------------------------- content

    def todense(self) -> torch.Tensor:
        """Materialize the full d^r dense tensor. Guarded by
        config.max_dense_elements."""
        raise NotImplementedError

    def toflat(self) -> "FlatSymmetricTensor":  # noqa: F821
        raise NotImplementedError

    def topermcls(self) -> "PermClsSymmetricTensor":  # noqa: F821
        from .permcls import PermClsSymmetricTensor

        return PermClsSymmetricTensor.from_flat(self.toflat())

    def astype(self, dtype) -> "SymmetricTensor":
        raise NotImplementedError

    def to(self, device) -> "SymmetricTensor":
        raise NotImplementedError

    def copy(self) -> "SymmetricTensor":
        """A tensor with storage of its own: torch tensors are mutable, so
        an in-place write into the copy's data (every leaf of a permcls
        tensor) leaves this tensor as it was."""
        data = self.data
        if isinstance(data, dict):
            data = {k: v.clone() for k, v in data.items()}
        else:
            data = data.clone()
        return self._raw(self.rank, self.dim, data)

    def transpose(self, *axes) -> "SymmetricTensor":
        """No-op: symmetric tensors are invariant under axis permutation."""
        return self

    @property
    def T(self) -> "SymmetricTensor":
        return self

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        """Values of one σ-class as a 1-D tensor in storage order."""
        raise NotImplementedError

    def _canon_index(self, idx) -> Tuple[int, ...]:
        """Normalize a multi-index: negative entries wrap NumPy-style,
        out-of-range entries raise IndexError."""
        out = []
        for k in idx:
            if isinstance(k, torch.Tensor) and k.ndim == 0:
                k = int(k)
            if not isinstance(k, (int, np.integer)):
                raise TypeError(f"index entries must be integers; got {k!r}")
            kk = int(k)
            if kk < 0:
                kk += self.dim
            if not 0 <= kk < self.dim:
                raise IndexError(f"index {int(k)} out of range for dim {self.dim}")
            out.append(kk)
        return tuple(out)

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        """One element by full multi-index, as a 0-d tensor."""
        raise NotImplementedError

    def _full_index(self, idx) -> Tuple[int, ...]:
        """A canonical full multi-index; IndexError unless it has rank
        entries."""
        idx = self._canon_index(idx)
        if len(idx) != self.rank:
            raise IndexError(
                f"element needs {self.rank} indices; got {len(idx)}"
            )
        return idx

    def _partial(self, idx: Tuple[int, ...]) -> "SymmetricTensor":
        """Partial indexing by k < rank leading indices → rank−k tensor."""
        raise NotImplementedError

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.class_values(key)
        if isinstance(key, (int, np.integer)) or (
            isinstance(key, torch.Tensor) and key.ndim == 0
        ):
            key = (key,)
        if isinstance(key, tuple):
            if len(key) > self.rank:
                raise IndexError(
                    f"too many indices ({len(key)}) for rank {self.rank}"
                )
            nslice = sum(1 for k in key if isinstance(k, slice))
            if nslice:
                # trailing full slices are allowed and ignored: A[i, :, :]
                if any(
                    not isinstance(k, slice) for k in key[len(key) - nslice:]
                ) or any(isinstance(k, slice) and k != slice(None) for k in key):
                    raise IndexError(
                        "only trailing full slices are supported in indexing"
                    )
                key = key[: len(key) - nslice]
            key = self._canon_index(key)
            if len(key) == self.rank:
                return self.element(key)
            return self._partial(key)
        if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
            return self
        raise IndexError(f"unsupported index {key!r}")

    # ------------------------------------------------------------ updates

    @property
    def at(self) -> "_AtHelper":
        """Functional update helper: ``A.at['iij'].set(v)``,
        ``A.at[1, 2, 2].set(v)`` (sets the whole index class), ``.add(v)``
        likewise; each returns a new tensor."""
        return _AtHelper(self)

    def set_class(self, cls, value) -> "SymmetricTensor":
        raise NotImplementedError

    def set_element(self, idx: Sequence[int], value) -> "SymmetricTensor":
        raise NotImplementedError

    def add_class(self, cls, value) -> "SymmetricTensor":
        c = comb.as_class_counts(cls)
        old = self.class_values(c)
        return self.set_class(c, old + torch.as_tensor(value, device=old.device))

    def add_element(self, idx, value) -> "SymmetricTensor":
        old = self.element(idx)
        return self.set_element(idx, old + torch.as_tensor(value, device=old.device))

    # --------------------------------------------------------- iterators
    # Host-side conveniences; they build small index tables on the host and
    # never belong in hot code.

    def indep_iter(self) -> Iterator:
        """Values of independent components, storage order."""
        return iter(host(self.toflat().data))

    def indep_iter_repindex(self) -> Iterator[Tuple[int, ...]]:
        """Representative (ascending) index of each independent component."""
        return (tuple(int(v) for v in row) for row in self.tables.rep_np())

    def indep_iter_index(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Advanced index (all distinct permutations) of each independent
        component."""
        for rep in self.indep_iter_repindex():
            perms = np.array(list(comb.distinct_permutations(rep)))
            yield tuple(perms.T)

    def _class_order(self, cls):
        return (
            comb.perm_classes(self.rank) if cls is None
            else (comb.as_class_counts(cls),)
        )

    def permcls_indep_iter(self, cls=None) -> Iterator:
        """Values of independent components, optionally restricted to one
        σ-class, storage order within each class."""
        vals = host(self.toflat().data)
        for c in self._class_order(cls):
            yield from vals[self.tables.class_positions_np(c)]

    def permcls_indep_iter_repindex(self, cls=None) -> Iterator[Tuple[int, ...]]:
        rep = self.tables.rep_np()
        for c in self._class_order(cls):
            for row in rep[self.tables.class_positions_np(c)]:
                yield tuple(int(v) for v in row)

    def permcls_multiplicity_iter(self) -> Iterator[int]:
        """γ of each independent component, class by class."""
        for c in comb.perm_classes(self.rank):
            yield from [comb.class_multiplicity(c)] * comb.class_size(c, self.dim)

    def keys(self):
        """KeysView over the storage: the single key ``()`` for
        single-array formats; PermCls overrides with its σ-classes."""
        return dict.fromkeys([()]).keys()

    def values(self) -> Iterator:
        """The storage tensors, aligned with :meth:`keys`."""
        return iter([self.data])

    def items(self) -> Iterator:
        return zip(self.keys(), self.values())

    def __iter__(self) -> Iterator:
        """The ``dim`` rank-(r−1) sub-tensors ``self[i]``."""
        for i in range(self.dim):
            yield self[i]

    @property
    def flat(self) -> Iterator:
        """All d^r component values, each independent component repeated
        by its multiplicity γ, storage order: zippable with
        :attr:`flat_index`, and streamed from packed storage without
        materializing d^r. Dense storage overrides with C order."""

        def gen():
            vals = host(self.toflat().data)
            gamma = host(self.tables.multiplicity)
            for v, g in zip(vals, gamma):
                for _ in range(int(g)):
                    yield v

        return gen()

    @property
    def flat_index(self) -> Iterator[Tuple[int, ...]]:
        """Each index tuple once, grouped per independent component (every
        distinct permutation of its representative, sorted), aligned with
        :attr:`flat`."""

        def gen():
            for row in self.tables.rep_np():
                base_idx = tuple(int(v) for v in row)
                yield from sorted(set(itertools.permutations(base_idx)))

        return gen()

    def memory_footprint(self) -> int:
        """Bytes of stored data."""
        return sum(v.numel() * v.element_size() for v in self.values())

    # --------------------------------------------------------- arithmetic

    def _binary(self, other, op_name: str, reverse: bool = False):
        from ..ops import elementwise

        return elementwise.binary(op_name, self, other, reverse=reverse)

    def __add__(self, other):
        return self._binary(other, "add")

    def __radd__(self, other):
        return self._binary(other, "add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "subtract")

    def __rsub__(self, other):
        return self._binary(other, "subtract", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "multiply")

    def __rmul__(self, other):
        return self._binary(other, "multiply", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "divide")

    def __rtruediv__(self, other):
        return self._binary(other, "divide", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "power")

    def __rpow__(self, other):
        return self._binary(other, "power", reverse=True)

    def __neg__(self):
        from ..ops import elementwise

        return elementwise.unary(torch.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        from ..ops import elementwise

        return elementwise.unary(torch.abs, self)

    # -------------------------------------------------------- comparisons

    def allclose(self, other, rtol=1e-5, atol=1e-8) -> bool:
        from ..ops import elementwise

        return elementwise.allclose(self, other, rtol=rtol, atol=atol)

    def array_equal(self, other) -> bool:
        from ..ops import elementwise

        return elementwise.array_equal(self, other)

    def __eq__(self, other):
        """`==` is refused: the reference treats comparison elementwise
        while Python's default would silently compare object identity; an
        error is safer than either surprise."""
        raise TypeError(
            "elementwise `==` on SymmetricTensor is not supported; use "
            "A.array_equal(B) for exact equality, A.allclose(B) for "
            "tolerance, or symalg.isclose(A, B) for an elementwise result"
        )

    def __ne__(self, other):
        raise TypeError(
            "elementwise `!=` on SymmetricTensor is not supported; use "
            "`not A.array_equal(B)` or symalg.isclose(A, B)"
        )

    # ------------------------------------------------------------- interop

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """NEP-13 hook: ``np.exp(A)``, ``np.add(A, B)`` and the like run on
        the packed storage, on its device (unary ufuncs through the torch
        function of ``_UNARY_UFUNCS``, binary ones through the elementwise
        ops). Only elementwise ``__call__`` is defined: in particular
        ``np.multiply.outer(A, B)`` raises, because the unsymmetrized outer
        product of symmetric tensors is not symmetric; use
        ``symalg.multiply.outer``. A ufunc with no torch counterpart gives
        NotImplemented, and NumPy raises ``TypeError``."""
        from ..ops import elementwise

        if kwargs.get("out") is not None:
            raise TypeError("out= is unsupported: SymmetricTensors are immutable")
        if method != "__call__":
            raise TypeError(
                f"np.{ufunc.__name__}.{method} is not defined for "
                "SymmetricTensors; for the symmetrized outer product use "
                "symalg.add/subtract/multiply .outer"
            )
        if ufunc.nin == 1 and ufunc.nout == 1:
            fn = _UNARY_UFUNCS.get(ufunc.__name__)
            if fn is None:
                return NotImplemented
            return elementwise.unary(fn, self)
        op = _BINARY_UFUNCS.get(ufunc.__name__)
        if op is None or ufunc.nin != 2:
            return NotImplemented
        a, b = inputs
        reverse = b is self and not isinstance(a, SymmetricTensor)
        if reverse:
            a, b = b, a
        return elementwise.binary(op, a, b, reverse=reverse)

    def __array_function__(self, func, types, args, kwargs):
        """NEP-18 hook. ``np.tensordot`` raises (the plain tensordot of
        symmetric tensors is not symmetric; use ``symalg.tensordot``).
        ``np.allclose``, ``np.isclose``, ``np.array_equal``,
        ``np.result_type``, ``np.all`` and ``np.any`` run on the packed
        storage on its device and never densify; ``np.asarray``/
        ``np.asanyarray``/``np.empty`` with ``like=`` a tensor build packed
        tensors. Everything else densifies with a warning through
        ``__array__``."""
        if func is np.tensordot:
            raise TypeError(
                "np.tensordot of SymmetricTensors is not symmetrized; use "
                "symalg.tensordot"
            )
        handler = _array_function_impls().get(func)
        if handler is not None:
            hkw = kwargs
            if func in (np.asarray, np.asanyarray, np.empty):
                # NEP-35 creation functions: NumPy strips `like=` before
                # dispatching, and the like object is `self`. Only the
                # handler sees it: the densifying fallback below must not
                # dispatch back here through a SymmetricTensor `like`.
                hkw = {**kwargs, "like": kwargs.get("like", self)}
            res = handler(*args, **hkw)
            if res is not NotImplemented:
                return res
        densified = tuple(
            np.asarray(a) if isinstance(a, SymmetricTensor) else a for a in args
        )
        return func(*densified, **kwargs)

    @classmethod
    def __get_pydantic_core_schema__(cls, source_type, handler):
        """Pydantic-v2 field support: a SymmetricTensor field validates
        from an instance or the dict of ``serialization.to_dict`` and
        serializes through it. Called only when pydantic reads the
        annotation; the package works without pydantic."""
        from pydantic_core import core_schema

        from .. import serialization as _ser

        def _validate(v):
            if isinstance(v, SymmetricTensor):
                return v
            if isinstance(v, dict):
                return _ser.from_dict(v)
            raise TypeError(
                "expected a SymmetricTensor or its serialization dict; "
                f"got {type(v).__name__}"
            )

        return core_schema.no_info_plain_validator_function(
            _validate,
            serialization=core_schema.plain_serializer_function_ser_schema(
                _ser.to_dict, info_arg=False
            ),
        )

    def __array__(self, dtype=None, copy=None):
        """NumPy interop: copies the dense tensor to the host with a
        warning (bfloat16 as float32: NumPy has no bfloat16 of its own)."""
        warnings.warn(
            f"Implicitly densifying {type(self).__name__} "
            f"(rank {self.rank}, dim {self.dim}) to a NumPy array.",
            stacklevel=2,
        )
        arr = host(self.todense())
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return (
            f"{type(self).__name__}(rank={self.rank}, dim={self.dim}, "
            f"dtype={self.dtype}, device={self.device}, size={self.size})"
        )

    __hash__ = None  # type: ignore[assignment]


class _AtHelper:
    def __init__(self, t: SymmetricTensor):
        self._t = t

    def __getitem__(self, key) -> "_AtRef":
        return _AtRef(self._t, key)


class _AtRef:
    def __init__(self, t: SymmetricTensor, key):
        self._t = t
        self._key = key

    def _dispatch(self, setter_cls, setter_el, value):
        t, key = self._t, self._key
        if isinstance(key, str):
            return setter_cls(comb.as_class_counts(key), value)
        if isinstance(key, (int, np.integer)):
            key = (key,)
        if isinstance(key, tuple):
            if len(key) != t.rank:
                raise IndexError(
                    "functional updates need a σ-class label or a full "
                    f"multi-index of length {t.rank}; got {key!r}"
                )
            return setter_el(t._canon_index(key), value)
        if key is Ellipsis:
            raise IndexError("whole-tensor assignment: construct a new tensor")
        raise IndexError(f"unsupported update key {key!r}")

    def set(self, value):
        return self._dispatch(self._t.set_class, self._t.set_element, value)

    def add(self, value):
        return self._dispatch(self._t.add_class, self._t.add_element, value)


def _check_dense_size(rank: int, dim: int, what: str = "todense") -> None:
    if dim**rank > config.max_dense_elements:
        raise MemoryError(
            f"{what}: dense size {dim}^{rank} = {dim**rank:,} exceeds "
            f"config.max_dense_elements = {config.max_dense_elements:,}"
        )


# NumPy's unary ufuncs by name → the torch function with the same meaning
# (several names differ). A unary ufunc missing here has no counterpart
# and gives NotImplemented.
_UNARY_UFUNCS = {
    "negative": torch.neg, "positive": torch.positive,
    "absolute": torch.abs, "fabs": torch.abs, "sign": torch.sign,
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "square": torch.square,
    "reciprocal": torch.reciprocal,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "deg2rad": torch.deg2rad, "radians": torch.deg2rad,
    "rad2deg": torch.rad2deg, "degrees": torch.rad2deg,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "rint": torch.round, "conjugate": torch.conj_physical,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "signbit": torch.signbit, "logical_not": torch.logical_not,
    "invert": torch.bitwise_not,
}

# NumPy's binary ufuncs that the elementwise ops take, by name
_BINARY_UFUNCS = {
    "add": "add",
    "subtract": "subtract",
    "multiply": "multiply",
    "divide": "divide",
    "true_divide": "divide",
    "power": "power",
}

_ARRAY_FUNCTION_IMPLS: dict = {}


def _array_function_impls() -> dict:
    """Packed NEP-18 implementations, built at first use (ops.elementwise
    imports this module). A handler returns NotImplemented for operands it
    does not cover, and ``__array_function__`` then densifies with a
    warning."""
    if _ARRAY_FUNCTION_IMPLS:
        return _ARRAY_FUNCTION_IMPLS
    from ..ops import elementwise as _ew

    def _st_or_scalar(x) -> bool:
        return isinstance(x, SymmetricTensor) or _ew._is_scalar(x)

    def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
        if not (_st_or_scalar(a) and _st_or_scalar(b)):
            return NotImplemented
        return _ew.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)

    def _isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
        if not (_st_or_scalar(a) and _st_or_scalar(b)):
            return NotImplemented
        if (isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor)
                and (a.rank, a.dim) != (b.rank, b.dim)):
            return NotImplemented  # NumPy's broadcasting: densify
        return _ew.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)

    def _array_equal(a, b, equal_nan=False):
        if not (isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor)):
            return NotImplemented
        return _ew.array_equal(a, b)

    def _result_type(*arrays_and_dtypes):
        return np.result_type(*(
            numpy_dtype(a.dtype) if isinstance(a, SymmetricTensor) else a
            for a in arrays_and_dtypes
        ))

    # every dense element equals some packed component, so truth over the
    # packed values is truth over the dense tensor
    def _all(a, *args, **kwargs):
        if not isinstance(a, SymmetricTensor) or args or kwargs:
            return NotImplemented
        return bool(a.toflat().data.all())

    def _any(a, *args, **kwargs):
        if not isinstance(a, SymmetricTensor) or args or kwargs:
            return NotImplemented
        return bool(a.toflat().data.any())

    # The creation handlers are terminal: they raise rather than return
    # NotImplemented where `like=` is a tensor, since the fallback would
    # call func again with `like=` and dispatch back here.
    def _asarray(a=None, dtype=None, order=None, *, like=None, **kwargs):
        if isinstance(a, SymmetricTensor):
            dt = as_torch_dtype(dtype)
            return a if dt is None or dt == a.dtype else a.astype(dt)
        if isinstance(like, SymmetricTensor) and a is not None:
            arr = np.asarray(a, dtype=dtype)
            if arr.shape != (like.dim,) * arr.ndim:
                raise ValueError(
                    f"np.asarray(..., like=<{type(like).__name__}>) needs "
                    f"square data of dim {like.dim}; got shape {arr.shape}"
                )
            return type(like).from_dense(torch.as_tensor(arr, device=like.device))
        return NotImplemented

    def _empty(shape, dtype=None, order="C", *, like=None, **kwargs):
        # np.empty(shape, like=A): a zero tensor of A's format on A's
        # device; the shape must be square
        if not isinstance(like, SymmetricTensor):
            return NotImplemented
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        if len(set(shape)) > 1:
            raise ValueError(
                "np.empty(like=SymmetricTensor) needs a square shape; "
                f"got {shape}"
            )
        rank, dim = len(shape), (shape[0] if shape else like.dim)
        dt = as_torch_dtype(dtype)
        zeros = getattr(type(like), "zeros", None)
        if zeros is not None:
            return zeros(rank, dim, dtype=dt, device=like.device)
        from .flat import FlatSymmetricTensor

        # formats without zeros (sparse) are built from flat zeros
        return type(like).from_flat(
            FlatSymmetricTensor.zeros(rank, dim, dtype=dt, device=like.device))

    _ARRAY_FUNCTION_IMPLS.update({
        np.allclose: _allclose,
        np.isclose: _isclose,
        np.array_equal: _array_equal,
        np.result_type: _result_type,
        np.all: _all,
        np.any: _any,
        np.asarray: _asarray,
        np.asanyarray: _asarray,
        np.empty: _empty,
    })
    return _ARRAY_FUNCTION_IMPLS
