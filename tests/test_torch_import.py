"""The port imports and evaluates with jax blocked, and builds nothing."""

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
    from symtensor_tpu_torch.kernels import _build

    A = stt.FlatSymmetricTensor(
        4, 3, torch.arange(15, dtype=torch.float64) / 7.0
    )
    x = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    got = float(stt.symalg.contract_all_indices_with_vector(A, x))
    dense = A.todense()
    for _ in range(4):
        dense = dense @ x
    assert abs(got - float(dense)) <= 1e-12 * abs(float(dense)), got
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
