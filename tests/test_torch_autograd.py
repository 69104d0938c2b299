"""Gradients of the port's public contraction with a vector, single input
and batched, against ``jax.grad`` of the JAX package's op, on the CPU in
float64.

The single-input op goes through ``group_pass`` (its twin on the CPU) and
the batched op through ``_BatchedEval``; both carry plain-torch backwards
(``kernels/group_pass.py``, ``kernels/poly_eval.py``), which these tests
hold to rtol 1e-10 in the values and in x. The JAX package routes traced
tensors away from its Pallas path, so ``jax.grad`` differentiates its plain
per-group loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.kernels import group_pass as gp
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.utils import combinatorics as comb

SHAPES = [(0, 2), (1, 4), (2, 3), (3, 1), (3, 4), (4, 3), (4, 6), (5, 2),
          (5, 4), (6, 1), (6, 3), (6, 5)]
BATCH = 5


def _grad(t: torch.Tensor) -> np.ndarray:
    """A leaf's gradient, zeros where the output does not depend on it
    (``jax.grad``'s convention)."""
    return np.zeros(tuple(t.shape)) if t.grad is None else t.grad.numpy()


@functools.lru_cache(maxsize=None)
def _jax_grads(rank, dim, batched):
    def single(data, x):
        A = st.FlatSymmetricTensor._raw(rank, dim, data)
        return st.symalg.contract_all_indices_with_vector(A, x)

    def batch(data, xs, v):
        A = st.FlatSymmetricTensor._raw(rank, dim, data)
        return jnp.dot(st.symalg.contract_all_indices_with_vector_batched(A, xs), v)

    return jax.jit(jax.grad(batch if batched else single, argnums=(0, 1)))


def _inputs(rank, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=comb.indep_size(rank, dim)), rng.normal(size=dim),
            rng.normal(size=(BATCH, dim)), rng.normal(size=BATCH))


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_single_input_gradient_matches_jax(rank, dim):
    data, x, _, _ = _inputs(rank, dim, 700 + 10 * rank + dim)
    ga, gx = _jax_grads(rank, dim, False)(jnp.asarray(data), jnp.asarray(x))
    a, xt = _leaves(data, x)
    y = stt.symalg.contract_all_indices_with_vector(
        stt.FlatSymmetricTensor._raw(rank, dim, a), xt)
    assert y.requires_grad
    y.backward()
    np.testing.assert_allclose(_grad(a), np.asarray(ga), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_grad(xt), np.asarray(gx), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_batched_gradient_matches_jax(rank, dim):
    data, _, xs, v = _inputs(rank, dim, 800 + 10 * rank + dim)
    ga, gx = _jax_grads(rank, dim, True)(jnp.asarray(data), jnp.asarray(xs),
                                         jnp.asarray(v))
    a, xt = _leaves(data, xs)
    y = stt.symalg.contract_all_indices_with_vector_batched(
        stt.FlatSymmetricTensor._raw(rank, dim, a), xt)
    (y @ torch.from_numpy(v)).backward()
    np.testing.assert_allclose(_grad(a), np.asarray(ga), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_grad(xt), np.asarray(gx), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("wrt", ["values", "x"])
@pytest.mark.parametrize("batched", [False, True])
def test_one_input_requiring_grad(wrt, batched):
    """Only the values, or only x, require a gradient: the backward
    computes what is asked and agrees with the full one."""
    rank, dim = 5, 4
    data, x, xs, v = _inputs(rank, dim, 91)
    inp = xs if batched else x
    full_a, full_x = _leaves(data, inp)
    op = (stt.symalg.contract_all_indices_with_vector_batched if batched
          else stt.symalg.contract_all_indices_with_vector)

    def run(a, xx):
        y = op(stt.FlatSymmetricTensor._raw(rank, dim, a), xx)
        return y @ torch.from_numpy(v) if batched else y

    run(full_a, full_x).backward()
    a = torch.tensor(data, requires_grad=wrt == "values")
    xx = torch.tensor(inp, requires_grad=wrt == "x")
    run(a, xx).backward()
    got, want = (a.grad, full_a.grad) if wrt == "values" else (xx.grad, full_x.grad)
    other = xx if wrt == "values" else a
    assert other.grad is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("rank,dim", [(3, 4), (4, 3), (6, 3)])
def test_group_pass_backward_matches_autograd_of_the_loop(rank, dim):
    """The group pass's backward against autograd through three plain
    ``torch.mv`` per group, for a random weighting of its (3, ΣP_j)
    output."""
    rng = np.random.default_rng(rank * 7 + dim)
    lay = comb.gflat_layout(rank, dim)
    vals, tri = _leaves(rng.normal(size=lay.n), rng.normal(size=comb.tri_size(dim)))
    w = torch.from_numpy(rng.normal(size=(3, int(lay.P.sum()))))
    (gp.group_pass(vals, tri, lay) * w).sum().backward()
    v2, t2 = _leaves(vals.detach().numpy(), tri.detach().numpy())
    prow = gp.row_offsets(lay)
    total = 0
    for j in range(dim):
        P, T = int(lay.P[j]), int(lay.T[j])
        g, s, to = int(lay.group_off[j]), int(prow[j]), int(lay.tri_off[j])
        V, tj = v2[g : g + P * T].view(P, T), t2[to : to + T]
        rl = dim - j
        total = total + (w[0, s : s + P] * torch.mv(V, tj)).sum()
        total = total + (w[1, s : s + P] * torch.mv(V[:, :rl], tj[:rl])).sum()
        total = total + (w[2, s : s + P] * V[:, 0] * tj[0]).sum()
    total.backward()
    np.testing.assert_allclose(vals.grad.numpy(), v2.grad.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tri.grad.numpy(), t2.grad.numpy(), rtol=1e-12, atol=1e-14)


def test_group_pass_ref_is_differentiable():
    """The twin itself no longer writes through ``out=`` under autograd."""
    lay = comb.gflat_layout(4, 3)
    vals = torch.randn(lay.n, dtype=torch.float64, requires_grad=True)
    tri = torch.randn(comb.tri_size(3), dtype=torch.float64)
    gp.group_pass_ref(vals, tri, lay).sum().backward()
    assert vals.grad is not None and vals.grad.shape == (lay.n,)


def test_float32_and_bfloat16_values_carry_gradients():
    """Lower-precision storage: the gradient comes back in the values'
    type and agrees with the float64 one to the storage's precision."""
    rank, dim = 4, 5
    data, x, xs, v = _inputs(rank, dim, 17)
    want = None
    for dt, tol in ((torch.float64, 0), (torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for batched in (False, True):
            a = torch.tensor(data, dtype=dt, requires_grad=True)
            A = stt.FlatSymmetricTensor._raw(rank, dim, a)
            if batched:
                y = stt.symalg.contract_all_indices_with_vector_batched(A, torch.tensor(xs))
                y = y @ torch.from_numpy(v).to(y.dtype)
            else:
                y = stt.symalg.contract_all_indices_with_vector(A, torch.tensor(x))
            y.backward()
            assert a.grad.dtype == dt
            if dt == torch.float64:
                want = (want or {}) | {batched: a.grad.numpy()}
                continue
            got = a.grad.double().numpy()
            err = np.abs(got - want[batched]).max() / np.abs(want[batched]).max()
            assert err <= tol, (dt, batched, err)


def test_batched_backward_saves_only_its_inputs():
    """Nothing of size B × ΣP_j outlives the forward: the graph holds the
    values and the inputs, and no other tensor."""
    rank, dim = 5, 4
    data, _, xs, _ = _inputs(rank, dim, 23)
    a, xt = _leaves(data, xs)
    y = tpe.poly_eval_flat_batched(stt.FlatSymmetricTensor._raw(rank, dim, a), xt)
    node = y.grad_fn
    assert type(node).__name__ == "_BatchedEvalBackward"
    saved = node.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == a.data_ptr() and saved[1].shape == xt.shape


@pytest.mark.parametrize("batched", [False, True])
def test_second_derivative_raises(batched):
    """The backwards are once differentiable: asking for a gradient with
    ``create_graph=True`` raises rather than returning one whose own
    derivative drops the terms that run through the backward."""
    rank, dim = 5, 4
    data, x, xs, v = _inputs(rank, dim, 31)
    a, xt = _leaves(data, xs if batched else x)
    A = stt.FlatSymmetricTensor._raw(rank, dim, a)
    if batched:
        y = stt.symalg.contract_all_indices_with_vector_batched(A, xt) @ torch.from_numpy(v)
    else:
        y = stt.symalg.contract_all_indices_with_vector(A, xt)
    name = "_BatchedEval" if batched else "_Epilogue|_GroupPass"
    with pytest.raises(RuntimeError, match=f"({name}) is differentiable once"):
        torch.autograd.grad(y, xt, create_graph=True)
    (gx,) = torch.autograd.grad(y, xt)  # the first derivative alone is fine
    assert not gx.requires_grad


def test_group_pass_second_derivative_raises():
    lay = comb.gflat_layout(4, 3)
    vals, tri = _leaves(np.ones(lay.n), np.ones(comb.tri_size(3)))
    with pytest.raises(RuntimeError, match="_GroupPass is differentiable once"):
        torch.autograd.grad(gp.group_pass(vals, tri, lay).sum(), tri, create_graph=True)
