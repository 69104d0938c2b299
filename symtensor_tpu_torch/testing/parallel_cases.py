"""Collective cases of the parallel layer, run on every rank of a world
(``parallel.launch``): each takes NumPy inputs and returns NumPy values, so
that the caller holds them to a reference in its own process. They live in
the package so that a spawned rank imports them without a test module.

`shape` is the (dp, tp) mesh; `device` is "cpu" or "cuda". Meshes are made
once per (shape, device) in each rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.base import host
from ..core.flat import FlatSymmetricTensor
from ..ops import basis_change as bc
from ..parallel import sharding

_MESHES = {}
_ROW_PASS_INCID = bc._ROW_PASS_INCID
_ROOT_STEP_FITS = bc._root_step_fits


def mesh_of(shape, device: str = "cpu"):
    key = (tuple(shape), device)
    if key not in _MESHES:
        _MESHES[key] = sharding.make_mesh(shape, ("dp", "tp"), device_type=device)
    return _MESHES[key]


def _dev(device: str) -> torch.device:
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _t(x, device: str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=_dev(device))


def colex_eval(shape, rank, dim, vals, xs, device="cpu"):
    """poly_eval_batched_sharded and the gradient of the sum of its
    outputs in the values and in xs: (out, d vals, d xs)."""
    mesh = mesh_of(shape, device)
    v = _t(vals, device).requires_grad_()
    x = _t(xs, device).requires_grad_()
    out = sharding.poly_eval_batched_sharded(FlatSymmetricTensor._raw(rank, dim, v), x, mesh)
    out.sum().backward()
    return host(out), host(v.grad), host(x.grad)


def flat_placement(shape, rank, dim, vals, x, device="cpu"):
    """shard_flat's placement, its local size, the layer's evaluation of
    the sharded tensor, what the ops outside the layer do with it, and
    shard_flat's refusal of an indivisible n."""
    from .. import symalg

    mesh = mesh_of(shape, device)
    A = FlatSymmetricTensor._raw(rank, dim, _t(vals, device))
    As = sharding.shard_flat(A, mesh, "tp")
    xt = _t(x, device)
    outside = {}
    for name, op in (("contract_all_indices_with_vector",
                      lambda: symalg.contract_all_indices_with_vector(As, xt)),
                     ("multiply.outer", lambda: symalg.multiply.outer(As, As)),
                     ("add", lambda: As + A),
                     ("todense", lambda: As.todense())):
        try:
            op()
            outside[name] = None
        except TypeError as e:
            outside[name] = str(e)
    try:
        sharding.shard_flat(FlatSymmetricTensor.zeros(2, 9, dtype=A.dtype, device=A.device),
                            mesh, "tp")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {
        "placements": [str(p) for p in As.data.placements],
        "local": int(As.data.to_local().shape[0]),
        "whole": bool(torch.equal(sharding.full_values(As.data), A.data)),
        "eval": host(sharding.poly_eval_batched_sharded(As, torch.stack([xt] * shape[0]),
                                                        mesh)[:1]),
        "outside": outside,
        "indivisible": refused,
    }


def grouped_eval(shape, rank, dim, vals, xs, device="cpu"):
    """poly_eval_batched_sharded_grouped, with views placed first and
    passed in: its outputs, the gradient of their sum in xs, each group's
    placement mode, the local blocks' elements and the whole blocks'."""
    mesh = mesh_of(shape, device)
    A = FlatSymmetricTensor._raw(rank, dim, _t(vals, device))
    again = sharding.poly_eval_batched_sharded_grouped(A, _t(xs, device), mesh)
    if rank < 3:  # data-parallel only: no views
        return {"out": host(again), "again": host(again), "modes": [], "local": 0,
                "n": int(A.data.shape[0])}
    views = sharding.shard_group_views(A, mesh)
    x = _t(xs, device).requires_grad_()
    out = sharding.poly_eval_batched_sharded_grouped(A, x, mesh, views=views)
    out.sum().backward()
    return {
        "out": host(out),
        "dx": host(x.grad),
        "again": host(again),
        "modes": [g.mode for g in views.groups],
        "local": int(sum(g.block.numel() for g in views.groups)),
        "n": int(A.data.shape[0]),
    }


def basis(shape, rank, dim, vals, W, block_elems=None, gather_max_bytes=None,
          device="cpu", sharded_input=False, row_pass=False, gather_root=False):
    """basis_change_packed under the mesh: the whole result, its
    placements, its local size and the root shard's and root's sizes.
    `row_pass` sweeps every level whose child rank is 3 or more row by
    row through the root pass (as rank 6 dim 100 does at level 1);
    `gather_root` treats level 0's tables as past the guard (as at rank 6
    dim 100), so that the root is gathered for the root pass."""
    mesh = mesh_of(shape, device)
    bc._ROW_PASS_INCID = 1 if row_pass else _ROW_PASS_INCID
    bc._root_step_fits = (lambda *a: False) if gather_root else _ROOT_STEP_FITS
    A = FlatSymmetricTensor._raw(rank, dim, _t(vals, device))
    if sharded_input:
        A = sharding.shard_flat(A, mesh, "tp")
    old = os.environ.get("SYMTENSOR_GATHER_MAX_BYTES")
    if gather_max_bytes is not None:
        os.environ["SYMTENSOR_GATHER_MAX_BYTES"] = str(gather_max_bytes)
    try:
        C = bc.basis_change_packed(A, _t(W, device), mesh=mesh, block_elems=block_elems)
    finally:
        if gather_max_bytes is not None:
            if old is None:
                del os.environ["SYMTENSOR_GATHER_MAX_BYTES"]
            else:
                os.environ["SYMTENSOR_GATHER_MAX_BYTES"] = old
    return {
        "data": host(sharding.full_values(C.data)),
        "placements": [str(p) for p in C.data.placements],
        "local": int(C.data.to_local().shape[0]),
        "root_shard": int(bc.last_call.get("root_shard", -1)),
        "root": int(bc.last_call.get("root", -1)),
        "route": bc.last_call.get("route"),
        "row_windows": int(bc.last_call.get("row_windows", 0)),
        "root_windows": int(bc.last_call.get("root_windows", 0)),
        "root_gathered": bool(bc.last_call.get("root_gathered")),
    }


def tensordot(shape, ra, rb, axes, dim, a, b, operands, device="cpu", sharded_input=False):
    """tensordot_sharded: (the result's values, each operand's shard
    length in the "sharded" mode)."""
    mesh = mesh_of(shape, device)
    A = FlatSymmetricTensor._raw(ra, dim, _t(a, device))
    B = FlatSymmetricTensor._raw(rb, dim, _t(b, device))
    if sharded_input:
        A = sharding.shard_flat(A, mesh, "tp")
    out = sharding.tensordot_sharded(A, B, axes, mesh, axis="tp", operands=operands)
    tp = sharding._axis(mesh, "tp")
    return {
        "data": host(out.data),
        "shards": [int(sharding._operand_shard(T, tp, mesh, "tp").data.shape[0])
                   for T in (A, B)],
    }


def train(shape, dim, terms, bias, xs, ys, steps, lr, device="cpu"):
    """Adam on models.polynomial with the loss through
    poly_eval_batched_sharded (``dryrun.sharded_loss``) from the given
    coefficients {rank: values}: the losses of every step."""
    from ..models import polynomial
    from ..parallel.dryrun import sharded_loss

    mesh = mesh_of(shape, device)
    dt = torch.as_tensor(np.asarray(bias)).dtype
    model = polynomial.SymmetricPolynomial(sorted(terms), dim, dtype=dt, device=_dev(device))
    with torch.no_grad():
        model.bias.copy_(_t(bias, device))
        for r, v in terms.items():
            model.terms[f"rank{r}"].copy_(_t(v, device))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    xt, yt = _t(xs, device), _t(ys, device)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = sharded_loss(model, xt, yt, mesh)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses


def foreign_modules():
    """The modules of jax, of the JAX package and of tests that this rank
    has imported (none, for a rank of a world)."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "symtensor_tpu", "conftest", "tests")
                  or ("." not in m and m.startswith("test_")))


def raise_on(rank_to_fail: int):
    """Raise on one rank while the others wait in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    dist.barrier()
    return dist.get_rank()
