"""The port's serialization against the JAX package's, on the CPU.

Mirrors the thirteen tests of ``tests/test_serialization.py`` and adds the
cross-package checks: a file written by either package loads in the other,
for all five formats, bit for bit, and the JSON forms are the same text.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu import serialization as jser
from symtensor_tpu.ops.symmetrize import symmetrize
from symtensor_tpu.utils.profiling import reset_counters as jax_reset_counters
from symtensor_tpu_torch import serialization as ser
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.profiling import reset_counters


@pytest.fixture(autouse=True)
def _cpu_and_fresh_warnings(monkeypatch):
    """Tensors go to the CPU, and each test leaves both packages'
    once-per-site warnings as a fresh process has them."""
    monkeypatch.setattr(config, "default_device", "cpu")
    yield
    reset_counters()
    jax_reset_counters()


def random_sym(rank, dim, rng):
    return np.asarray(symmetrize(rng.normal(size=(dim,) * rank)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------ tests/test_serialization.py


@pytest.mark.parametrize("fmt", ["DenseSymmetricTensor", "FlatSymmetricTensor",
                                 "PermClsSymmetricTensor"])
def test_json_roundtrip(fmt):
    rng = np.random.default_rng(0)
    A = getattr(stt, fmt).from_dense(_t(random_sym(3, 4, rng)))
    B = ser.from_json(ser.to_json(A))
    assert type(B) is type(A)
    assert (B.rank, B.dim) == (A.rank, A.dim)
    assert A.allclose(B, rtol=1e-12, atol=1e-12)


def test_json_roundtrip_decomp():
    rng = np.random.default_rng(1)
    A = stt.DecompSymmetricTensor(
        rank=3, dim=4, weights=_t(rng.normal(size=(2, 2))),
        factors=_t(rng.normal(size=(2, 4))), multiplicities=(2, 1),
        dtype=torch.float64)
    B = ser.from_json(ser.to_json(A))
    assert B.multiplicities == (2, 1)
    assert A.toflat().allclose(B.toflat())


def test_json_scalar_compression_preserved():
    A = stt.PermClsSymmetricTensor(rank=3, dim=6, data={"iii": 2.0})
    B = ser.from_json(ser.to_json(A))
    assert set(B.scalar_classes) == set(A.scalar_classes)
    assert A.allclose(B)


@pytest.mark.parametrize("fmt", ["FlatSymmetricTensor", "PermClsSymmetricTensor"])
def test_npz_roundtrip(fmt, tmp_path):
    rng = np.random.default_rng(2)
    A = getattr(stt, fmt).from_dense(_t(random_sym(4, 3, rng)))
    p = str(tmp_path / "t.npz")
    ser.save(p, A)
    B = ser.load(p)
    assert type(B) is type(A)
    assert A.array_equal(B)


def test_npz_roundtrip_decomp(tmp_path):
    A = stt.DecompSymmetricTensor.from_vector(
        _t(np.random.default_rng(3).normal(size=5)), 3)
    p = str(tmp_path / "d.npz")
    ser.save(p, A)
    B = ser.load(p)
    assert B.multiplicities == A.multiplicities
    assert A.toflat().array_equal(B.toflat())


def test_pytree_checkpoint_shape():
    """The storage leaves are all a tensor holds: saved as NumPy arrays
    and wrapped again, they give the same tensor (the counterpart of the
    JAX package's pytree flatten/unflatten)."""
    A = stt.PermClsSymmetricTensor.from_dense(
        _t(random_sym(3, 4, np.random.default_rng(4))))
    as_np = {k: v.numpy().copy() for k, v in A.items()}
    B = stt.PermClsSymmetricTensor._raw(3, 4, {k: _t(v) for k, v in as_np.items()})
    assert A.array_equal(B)


def test_npz_path_without_suffix(tmp_path):
    A = stt.FlatSymmetricTensor.from_dense(_t(random_sym(2, 3, np.random.default_rng(5))))
    p = str(tmp_path / "noext")
    ser.save(p, A)
    B = ser.load(p)
    assert A.array_equal(B)


def _reference_payload(dense, rank, dim):
    """A payload in the reference's encode shape: (rank, dim, {str(σ-counts):
    values}), per-class values in σindex_iter order."""
    data = {}
    for counts in comb.perm_classes(rank):
        idx = list(ser._reference_class_indices(counts, dim))
        if idx:
            data[str(tuple(counts))] = [float(dense[i]) for i in idx]
    return [rank, dim, data]


@pytest.mark.parametrize("rank,dim", [(0, 1), (1, 4), (2, 3), (3, 4), (4, 3)])
def test_from_reference_json(rank, dim):
    dense = random_sym(rank, dim, np.random.default_rng(6 + rank))
    payload = _reference_payload(dense, rank, dim)
    forms = [
        payload,
        {"rank": rank, "dim": dim, "data": payload[2]},
        ["symtensor.permcls_symtensor.PermClsSymmetricTensor.Data",
         {"rank": rank, "dim": dim, "data": payload[2]}],
    ]
    for form in forms + [json.dumps(f) for f in forms]:
        t = ser.from_reference_json(form)
        assert isinstance(t, stt.PermClsSymmetricTensor)
        np.testing.assert_allclose(t.todense().numpy(), dense, atol=1e-12)
        np.testing.assert_array_equal(
            t.toflat().data.numpy(),
            np.asarray(jser.from_reference_json(form).toflat().data))


def test_from_reference_json_partial_and_errors():
    dense = random_sym(3, 3, np.random.default_rng(7))
    payload = _reference_payload(dense, 3, 3)
    data = dict(payload[2])
    data.pop(str((1, 1, 1)))
    t = ser.from_reference_json([3, 3, data])
    np.testing.assert_allclose(t.class_values("ijk").numpy(), 0.0)
    np.testing.assert_allclose(
        t.class_values("iij").numpy(),
        ser.from_reference_json(payload).class_values("iij").numpy())
    with pytest.raises(ValueError):
        ser.from_reference_json([3, 3, {"(2, 2)": [1.0]}])
    with pytest.raises(ValueError):
        ser.from_reference_json([3, 3, {"(3,)": [1.0]}])
    with pytest.raises(ValueError):
        ser.from_reference_json({"rank": 3, "dim": 3})


@pytest.mark.parametrize("rank,dim", [(0, 1), (1, 4), (2, 3), (3, 4), (4, 3)])
def test_to_reference_json_roundtrip(rank, dim):
    dense = random_sym(rank, dim, np.random.default_rng(8 + rank))
    payload = _reference_payload(dense, rank, dim)
    t = ser.from_reference_json(payload)
    got_rank, got_dim, got = ser.to_reference_payload(t)
    assert (got_rank, got_dim) == (rank, dim)
    want = payload[2]
    for key, vals in got.items():
        if key in want:
            np.testing.assert_allclose(np.asarray(vals, dtype=float), want[key], atol=1e-12)
        else:
            assert np.asarray(vals).size == 0
    assert set(want) <= set(got)
    s = ser.to_reference_json(t)
    t2 = ser.from_reference_json(s)
    assert ser.to_reference_json(t2) == s
    assert s == jser.to_reference_json(jser.from_reference_json(payload))
    decoded = json.loads(s)
    assert decoded[0] == rank and decoded[1] == dim


def test_from_reference_json_complex_and_canonical_keys():
    rng = np.random.default_rng(9)
    dense = random_sym(2, 3, rng) + 1j * random_sym(2, 3, rng)
    data = {}
    for counts in comb.perm_classes(2):
        idx = list(ser._reference_class_indices(counts, 3))
        data[str(tuple(counts))] = {
            "data": [complex(dense[i]) for i in idx], "dtype": "complex128"}
    t = ser.from_reference_json([2, 3, data])
    assert t.dtype == torch.complex128
    np.testing.assert_allclose(t.todense().numpy(), dense, atol=1e-12)
    with pytest.raises(ValueError, match="canonical"):
        ser.from_reference_json([3, 3, {"(1, 2)": [1.0, 2.0, 3.0]}])


def test_reference_class_order_contract():
    assert list(ser._reference_class_indices((2, 1), 3)) == [
        (0, 0, 1), (0, 0, 2), (1, 1, 0), (1, 1, 2), (2, 2, 0), (2, 2, 1)]
    assert list(ser._reference_class_indices((2, 2), 3)) == [
        (0, 0, 1, 1), (0, 0, 2, 2), (1, 1, 2, 2)]


def test_pydantic_model_embedding():
    pydantic = pytest.importorskip("pydantic")

    class Foo(pydantic.BaseModel):
        model_config = dict(arbitrary_types_allowed=True)
        A: stt.SymmetricTensor

    for fmt in (stt.FlatSymmetricTensor, stt.PermClsSymmetricTensor):
        A = fmt.from_dense(_t(random_sym(3, 3, np.random.default_rng(10))))
        foo = Foo(A=A)
        foo2 = Foo.model_validate_json(foo.model_dump_json())
        assert isinstance(foo2.A, stt.SymmetricTensor)
        assert foo2.A.format == A.format
        assert A.array_equal(foo2.A)
        assert foo2.model_dump_json() == foo.model_dump_json()
    with pytest.raises((TypeError, pydantic.ValidationError)):
        Foo(A=[1.0, 2.0])


# ------------------------------------------------------ across the packages


def _formats(dtype=np.float64, seed=11):
    """One tensor of each format in both packages, from the same values:
    {format: (jax tensor, port tensor)}."""
    rng = np.random.default_rng(seed)
    dense = random_sym(3, 4, rng).astype(dtype)
    Fj = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    Ft = stt.FlatSymmetricTensor.from_dense(_t(dense))
    w, f = rng.normal(size=(2, 2)).astype(dtype), rng.normal(size=(2, 4)).astype(dtype)
    idx, vals = rng.integers(0, 4, size=(9, 3)), rng.normal(size=9).astype(dtype)
    jdt = jnp.dtype(dtype)
    return {
        "flat": (Fj, Ft),
        "permcls": (st.PermClsSymmetricTensor(rank=3, dim=4, data={
            "iii": 1.5, "iij": np.asarray(Fj.class_values("iij")),
            "ijk": np.asarray(Fj.class_values("ijk"))}, dtype=jdt),
                    stt.PermClsSymmetricTensor(3, 4, {
                        "iii": 1.5, "iij": Ft.class_values("iij"),
                        "ijk": Ft.class_values("ijk")}, dtype=Ft.dtype)),
        "dense": (st.DenseSymmetricTensor(data=jnp.asarray(dense)),
                  stt.DenseSymmetricTensor(data=_t(dense))),
        "decomp": (st.DecompSymmetricTensor(
            rank=3, dim=4, weights=jnp.asarray(w), factors=jnp.asarray(f),
            multiplicities=(2, 1), dtype=jdt),
            stt.DecompSymmetricTensor(3, 4, _t(w), _t(f), (2, 1), dtype=Ft.dtype)),
        "sparse_flat": (st.SparseFlatSymmetricTensor.from_entries(
            3, 4, idx, vals, dtype=jdt),
            stt.SparseFlatSymmetricTensor.from_entries(3, 4, _t(idx), _t(vals))),
    }


def _leaves_j(t):
    if t.format == "permcls":
        return {k: np.asarray(v) for k, v in t.data.items()}
    if t.format == "decomp":
        return {"w": np.asarray(t.weights), "f": np.asarray(t.factors),
                "m": np.asarray(t.multiplicities)}
    if t.format == "sparse_flat":
        return {"v": np.asarray(t.bcoo.data), "i": np.asarray(t.rep)}
    return {"d": np.asarray(t.data)}


def _leaves_t(t):
    if t.format == "permcls":
        return {k: v.numpy() for k, v in t.data.items()}
    if t.format == "decomp":
        return {"w": t.weights.numpy(), "f": t.factors.numpy(),
                "m": np.asarray(t.multiplicities)}
    if t.format == "sparse_flat":
        return {"v": t.vals.numpy(), "i": t.rep.numpy()}
    return {"d": t.data.numpy()}


def _same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# The JAX package's loader reads sparse values in its default dtype
# (float32), so the sparse files cross over in float32.
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fmt", ["flat", "permcls", "dense", "decomp", "sparse_flat"])
def test_npz_files_cross_between_the_packages(fmt, dtype, tmp_path):
    if fmt == "sparse_flat" and dtype == np.float64:
        dtype = np.float32
    Aj, At = _formats(dtype)[fmt]
    _same_bits(_leaves_t(At), _leaves_j(Aj))
    ser.save(tmp_path / "port", At)
    jser.save(str(tmp_path / "jax"), Aj)
    from_port, from_jax = jser.load(str(tmp_path / "port")), ser.load(tmp_path / "jax")
    assert from_port.format == from_jax.format == fmt
    _same_bits(_leaves_j(from_port), _leaves_j(Aj))
    _same_bits(_leaves_t(from_jax), _leaves_t(At))
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert str(zp["__meta__"]) == str(zj["__meta__"])


@pytest.mark.parametrize("fmt", ["flat", "permcls", "dense", "decomp", "sparse_flat"])
def test_json_is_the_same_text_in_both_packages(fmt):
    Aj, At = _formats()[fmt]
    assert ser.to_json(At) == jser.to_json(Aj)
    B = jser.from_json(ser.to_json(At))
    C = ser.from_json(jser.to_json(Aj))
    assert B.format == C.format == fmt
    _same_bits(_leaves_t(C), _leaves_j(B))


def test_bfloat16_files_follow_the_jax_convention(tmp_path):
    """The JAX package writes bfloat16 as raw 2-byte records; the port
    reads them bit for bit and writes them the same way."""
    vals = (np.arange(10) * 1.37 - 4.0).astype(np.float32)
    Aj = st.FlatSymmetricTensor._raw(2, 4, jnp.asarray(vals, dtype=jnp.bfloat16))
    jser.save(str(tmp_path / "jax"), Aj)
    At = ser.load(tmp_path / "jax")
    assert At.dtype == torch.bfloat16
    assert At.data.view(torch.int16).numpy().tobytes() == np.asarray(Aj.data).tobytes()
    ser.save(tmp_path / "port", At)
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert zp["data"].dtype == zj["data"].dtype
        assert zp["data"].tobytes() == zj["data"].tobytes()
    assert torch.equal(ser.load(tmp_path / "port").data.view(torch.int16),
                       At.data.view(torch.int16))
    assert ser.to_json(At) == jser.to_json(Aj)


def test_load_puts_values_on_the_requested_device(tmp_path, monkeypatch):
    A = stt.FlatSymmetricTensor.from_dense(_t(random_sym(2, 3, np.random.default_rng(12))))
    ser.save(tmp_path / "a", A)
    assert ser.load(tmp_path / "a", device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(config, "default_device", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ser.load(tmp_path / "a")
