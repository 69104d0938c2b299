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
    from symtensor_tpu_torch.ops import elementwise, outer

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
