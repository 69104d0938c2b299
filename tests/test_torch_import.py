"""The port imports and evaluates with jax blocked, and builds nothing;
its symalg names are the JAX package's."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import _build, gather_mm, group_pass
    from symtensor_tpu_torch.ops import basis_change, elementwise, outer
    from symtensor_tpu_torch.core import decomp
    from symtensor_tpu_torch.models import moments
    from symtensor_tpu_torch.utils import profiling
    from symtensor_tpu_torch import interop
    from symtensor_tpu_torch.parallel import dryrun, launch, sharding
    from symtensor_tpu_torch.testing import parallel_cases, parallel_smoke

    A = stt.FlatSymmetricTensor(
        4, 3, torch.arange(15, dtype=torch.float64) / 7.0
    )
    x = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    got = float(stt.symalg.contract_all_indices_with_vector(A, x))
    dense = A.todense()
    for _ in range(4):
        dense = dense @ x
    assert abs(got - float(dense)) <= 1e-12 * abs(float(dense)), got
    B = stt.symalg.multiply.outer(A, A) - stt.symalg.tensordot(A, A, axes=0)
    assert B.rank == 8 and stt.symalg.allclose(B, 0.0)
    C = stt.symalg.tensordot(A, A, axes=2, stream=False)
    assert C.rank == 4 and bool(torch.isfinite(C.data).all())
    # permcls (a scalar and a vector class) and dense, evaluated and promoted
    P = stt.PermClsSymmetricTensor(
        4, 3, {"iiii": 0.5, "iijj": torch.arange(3, dtype=torch.float64)},
        dtype=torch.float64, device="cpu")
    D = stt.DenseSymmetricTensor(data=A.todense())
    for T in (P, D):
        got = float(stt.symalg.contract_all_indices_with_vector(T, x))
        dense = T.todense()
        for _ in range(4):
            dense = dense @ x
        assert abs(got - float(dense)) <= 1e-12 * abs(float(dense)), (T, got)
    assert (P + P).format == "permcls" and (D * 2.0).format == "dense"
    assert (P + D).format == "permcls" and (P - A).format == "flat"
    assert stt.symalg.multiply.outer(D, D).format == "dense"
    assert stt.symalg.tensordot(P, P, axes=1).format == "permcls"
    # decomp: built, evaluated, contracted against a list, and the moments
    C = stt.DecompSymmetricTensor(
        3, 3, torch.ones(2, 2, dtype=torch.float64),
        torch.arange(6, dtype=torch.float64).reshape(2, 3) / 5.0, (2, 1),
        dtype=torch.float64)
    got = float(stt.symalg.contract_all_indices_with_vector(C, x))
    dense = C.todense()
    for _ in range(3):
        dense = dense @ x
    assert abs(got - float(dense)) <= 1e-12 * abs(float(dense)), got
    assert (C + C).format == "decomp" and (C * 2.0).format == "decomp"
    assert stt.symalg.multiply.outer(C, C).format == "decomp"
    chis = [stt.DecompSymmetricTensor.from_matrix(
        torch.eye(3, dtype=torch.float64) * (i + 1)) for i in range(3)]
    out = stt.symalg.contract_tensor_list(C, chis, n_times=2)
    assert out.format == "flat" and out.rank == 5
    ms = moments.gaussian_moments(x, torch.eye(3, dtype=torch.float64), 4)
    assert [m.rank for m in ms] == [1, 2, 3, 4]
    # the packed basis change: identity W returns the values, formats kept
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.equal(basis_change.basis_change_packed(A, eye).data, A.data)
    assert stt.symalg.contract_all_indices_with_matrix(P, eye[:, :2]).format == "permcls"
    assert stt.symalg.contract_all_indices_with_matrix(A, eye[:, :2]).dim == 2
    leaked = sorted(m for m in sys.modules if m == "triton" or m.startswith("triton."))
    assert not leaked, leaked
    leaked = sorted(m for m in sys.modules
                    if m == "symtensor_tpu" or m.startswith("symtensor_tpu.")
                    or (m.startswith("jax") and sys.modules[m] is not None))
    assert not leaked, leaked
    assert _build.load_library.cache_info().currsize == 0
    print("ok")
    """
)


def test_port_imports_without_jax_and_builds_nothing():
    build_dir = os.path.join(ROOT, "symtensor_tpu_torch", "_build")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    assert after == before


def test_symalg_names_are_a_subset_of_the_jax_packages():
    import symtensor_tpu as st
    import symtensor_tpu_torch as stt

    ported = set(stt.symalg.__all__)
    assert ported <= set(st.symalg.__all__), ported - set(st.symalg.__all__)
    assert {"add", "subtract", "multiply", "tensordot", "symmetric_outer",
            "allclose", "isclose", "array_equal", "apply"} <= ported
    for name in ported:
        assert hasattr(stt.symalg, name), name
