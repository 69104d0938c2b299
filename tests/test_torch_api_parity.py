"""Every public name of the JAX package has a counterpart in the port.

Walks every module of ``symtensor_tpu`` and checks that each public name
defined there, and each public method of each class defined there, exists
under the same name in the matching module of ``symtensor_tpu_torch``.
Names a module imports (modules, typing aliases, functions, classes and
objects whose ``__module__`` is another module) are the other module's
business and are skipped. What the port leaves out on purpose is the
explicit list below, one entry per item of ROADMAP's "Not ported on
purpose" list; each entry must still be missing from the port, so the list
cannot go stale.
"""

import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import symtensor_tpu
from symtensor_tpu import serialization as jax_serialization
from symtensor_tpu.utils.tables import tables as jax_tables
from symtensor_tpu_torch import serialization
from symtensor_tpu_torch.utils.tables import tables

PORT = "symtensor_tpu_torch"

# Modules of the JAX package with no counterpart module.
MODULES_LEFT_OUT = {
    # the Pallas group pass: csrc/group_pass.cu through kernels/group_pass.py
    # takes its place
    "symtensor_tpu.kernels.pallas_poly",
    # the slab gather, which nothing in production uses
    "symtensor_tpu.utils.slabs",
    # the native library itself: a shared object, not a Python module
    # (symtensor_tpu.native binds it, and has its counterpart)
    "symtensor_tpu.native._tablegen",
}

# Names of the JAX package the port leaves out on purpose, each under its
# item of ROADMAP's "Not ported on purpose" list.
NAMES_LEFT_OUT = {
    # the jit battery case, which has no eager counterpart
    "symtensor_tpu.testing.api_suite.SymTensorSuite.test_jit",
    # compile-cache host fingerprinting
    "symtensor_tpu.config.enable_persistent_compile_cache",
    # Tables.class_rep, which lost to the flat route at every shape
    "symtensor_tpu.utils.tables.Tables.class_rep",
    # the one-hot MXU gather's size gate
    "symtensor_tpu.kernels.gather_mm.fits",
    # the per-group views (the premultiplied views replace them) and the
    # TPU's fast batched variant
    "symtensor_tpu.kernels.poly_eval.group_views",
    "symtensor_tpu.kernels.poly_eval.poly_eval_flat_batched_fast",
    # the precision knobs: the port has one rule, full_fp32_matmul
    "symtensor_tpu.utils.precision.value_prec",
    "symtensor_tpu.utils.precision.batched_value_prec",
    # the TPU workarounds of the basis change: compile-helper budgets
    # (g_chunks, chunk_cols), the parent copied into group blocks, the
    # donated dump slots and the root pass as jitted XLA programs (the
    # port's root_pass reads views of the parent)
    "symtensor_tpu.ops.basis_root.g_chunks",
    "symtensor_tpu.ops.basis_root.chunk_cols",
    "symtensor_tpu.ops.basis_root.split_root_groups",
    "symtensor_tpu.ops.basis_root.root_dus",
    "symtensor_tpu.ops.basis_root.root_pass_kernel",
    # the *_jnp* table helpers: the port's tables are torch tensors
    # (position_T, position_base_T, position_insert_T, root_tables)
    "symtensor_tpu.ops.basis_root.root_tables_jnp",
    "symtensor_tpu.utils.tables.Tables.position_jnp",
    "symtensor_tpu.utils.tables.Tables.position_jnp_T",
    "symtensor_tpu.utils.tables.Tables.position_base_jnp_T",
    "symtensor_tpu.utils.tables.Tables.position_insert_jnp_T",
    # the kernel counter (each kernel's ``.launches`` counts its launches)
    # and the median timer, which nothing called (the port's spans and
    # ``trace`` time its layers)
    "symtensor_tpu.utils.profiling.count_kernel",
    "symtensor_tpu.utils.profiling.timeit",
}
# JAX pytree hooks, on every class that registers itself as a pytree
PYTREE_HOOKS = {"tree_flatten", "tree_unflatten"}


def _jax_modules():
    return sorted(info.name for info in pkgutil.walk_packages(
        symtensor_tpu.__path__, "symtensor_tpu."))


def _defined_here(obj, module: str) -> bool:
    """Whether `obj` is defined in `module` (not imported into it)."""
    if isinstance(obj, types.ModuleType):
        return False
    return getattr(obj, "__module__", module) in (module, "builtins")


def _public_names(module):
    """Qualified public names of `module`: its own names, and the public
    attributes of each class it defines."""
    name = module.__name__
    for attr, obj in vars(module).items():
        if attr.startswith("_") or not _defined_here(obj, name):
            continue
        yield f"{name}.{attr}", attr, None
        if inspect.isclass(obj):
            for meth in vars(obj):
                if not meth.startswith("_") and meth not in PYTREE_HOOKS:
                    yield f"{name}.{attr}.{meth}", attr, meth


def _missing(module_name: str):
    mod = importlib.import_module(module_name)
    port = importlib.import_module(PORT + module_name[len("symtensor_tpu"):])
    missing = []
    for qual, attr, meth in _public_names(mod):
        obj = getattr(port, attr, None)
        if obj is None or (meth is not None and not hasattr(obj, meth)):
            missing.append(qual)
    return missing


@pytest.mark.parametrize("module_name", [
    m for m in _jax_modules() if m not in MODULES_LEFT_OUT])
def test_every_public_name_has_a_counterpart(module_name):
    missing = [q for q in _missing(module_name) if q not in NAMES_LEFT_OUT]
    assert not missing, f"no counterpart in {PORT}: {missing}"


def test_every_left_out_name_is_still_missing():
    """An entry of the lists that the port now has must leave the lists
    (and ROADMAP's "Not ported on purpose")."""
    assert MODULES_LEFT_OUT <= set(_jax_modules())
    for m in MODULES_LEFT_OUT:
        with pytest.raises(ImportError):
            importlib.import_module(PORT + m[len("symtensor_tpu"):])
    missing = {q for m in _jax_modules() if m not in MODULES_LEFT_OUT
               for q in _missing(m)}
    assert NAMES_LEFT_OUT <= missing


def test_formats_registry_matches_jax():
    assert list(serialization.FORMATS) == list(jax_serialization.FORMATS)
    for name, cls in serialization.FORMATS.items():
        assert cls.__module__.startswith(PORT + ".core.")
        assert cls.__name__ == jax_serialization.FORMATS[name].__name__
        assert cls.format == name
    with pytest.raises(TypeError, match="unknown format"):
        serialization.from_dict({"format": "nope", "rank": 1, "dim": 2,
                                 "dtype": "float64", "data": [0.0, 0.0]},
                                device="cpu")


@pytest.mark.parametrize("rank,dim", [(0, 3), (1, 4), (2, 5), (3, 4), (5, 3)])
def test_tables_rep_matches_jax(rank, dim):
    t = tables(rank, dim)
    rep = t.rep
    assert rep.dtype == torch.int32 and rep.device == t.device
    want = np.asarray(jax_tables(rank, dim).rep)
    assert want.dtype == np.int32 and rep.shape == want.shape
    np.testing.assert_array_equal(rep.numpy(), want)
    assert t.rep is rep  # memoized, as rep_T is
    if rank == 0:
        assert rep.shape == (1, 0)
    else:
        np.testing.assert_array_equal(rep.numpy().T, t.rep_T.numpy())
