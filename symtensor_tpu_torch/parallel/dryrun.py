"""A dry run of every sharded path on a world of n ranks.

The counterpart of ``__graft_entry__.dryrun_multichip``: n ranks factor
into a (dp, tp) mesh, tp = 2 where n is even; two Adam steps of
``models.polynomial`` with the loss through ``poly_eval_batched_sharded``
(held to ``polynomial.train_step`` from the same seed); the grouped
evaluation, the sharded basis change and both tensordot modes against the
unsharded ops, also at the shapes where the sharded branches differ (a
rank-4 dim-24 tensor has groups that neither axis of tp = 2 divides; a
ring of many blocks a rank). One "OK" line names the mesh and the backend.

    python -m symtensor_tpu_torch.parallel.dryrun [N] [--device cpu|cuda]

NCCL runs when every rank has a card of its own; else gloo, whose ranks
may share ``cuda:0``.
"""

from __future__ import annotations

import argparse
import math
import os

import torch

from .launch import spawn_world
from .sharding import (
    full_values,
    make_mesh,
    poly_eval_batched_sharded,
    poly_eval_batched_sharded_grouped,
    shard_group_views,
    tensordot_sharded,
)


def sharded_loss(model, xs, ys, mesh, dp_axis: str = "dp", tp_axis: str = "tp"):
    """Mean squared error of a ``models.polynomial.SymmetricPolynomial``
    over the batch (B, dim), every term through
    ``poly_eval_batched_sharded``: the same value on every rank, and each
    rank's backward gives the whole gradient."""
    out = model.bias
    for t in model.tensors().values():
        out = out + poly_eval_batched_sharded(t, xs, mesh, dp_axis, tp_axis)
    return torch.mean((out - torch.as_tensor(ys, device=out.device)) ** 2)


def _close(got, want, what: str, rtol: float = 1e-4, atol: float = 1e-6) -> float:
    got, want = got.double(), want.double()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(atol))
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: sharded result disagrees (normalised "
                             f"error {err:.3e})")
    return err


def _rank(dp: int, tp: int, device: str) -> dict:
    from ..core.flat import FlatSymmetricTensor
    from ..kernels.poly_eval import poly_eval_flat_batched
    from ..models import polynomial
    from ..ops import outer
    from ..ops.basis_change import basis_change_packed

    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh((dp, tp), ("dp", "tp"), device_type=device)
    dim, ranks, batch = 12, (2, 3), 2 * dp
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn(batch, dim, generator=gen, device=dev)
    ys = torch.randn(batch, generator=gen, device=dev)
    W = torch.randn(dim, dim, generator=gen, device=dev)

    def model():
        return polynomial.init(ranks, dim, generator=torch.Generator(device=dev).manual_seed(1),
                               dtype=torch.float32, device=dev)

    sharded, plain = model(), model()
    opt_s = torch.optim.Adam(sharded.parameters(), lr=1e-3)
    opt_p = torch.optim.Adam(plain.parameters(), lr=1e-3)
    losses = []
    for _ in range(2):
        opt_s.zero_grad(set_to_none=True)
        loss = sharded_loss(sharded, xs, ys, mesh)
        loss.backward()
        opt_s.step()
        got = float(loss.detach())
        want = float(polynomial.train_step(plain, opt_p, xs, ys))
        if not (math.isfinite(got) and abs(got - want) <= 1e-4 * abs(want)):
            raise AssertionError(f"sharded loss {got!r} against train_step's {want!r}")
        losses.append(got)

    A = sharded.tensors()["rank3"]
    A = FlatSymmetricTensor._raw(3, dim, A.data.detach())
    errs = {"grouped": _close(poly_eval_batched_sharded_grouped(A, xs, mesh),
                              poly_eval_flat_batched(A, xs), "grouped eval")}
    C = basis_change_packed(A, W, mesh=mesh, tp_axis="tp", block_elems=2000)
    errs["basis"] = _close(full_values(C.data), basis_change_packed(A, W).data,
                           "basis change")
    td = outer.tensordot(A, A, axes=1, stream=True).data
    for mode in ("replicated", "sharded"):
        errs[f"tensordot {mode}"] = _close(
            tensordot_sharded(A, A, 1, mesh, axis="tp", operands=mode).data, td,
            f"tensordot ({mode} operands)")

    # where the branches differ: groups replicated over tp = 2 at rank 4
    # dim 24, and a ring of many blocks a rank
    g24 = torch.Generator(device=dev).manual_seed(2)
    A4 = FlatSymmetricTensor._raw(4, 24, 0.1 * torch.randn(
        FlatSymmetricTensor.zeros(4, 24, device=dev).data.shape[0], generator=g24, device=dev))
    views = shard_group_views(A4, mesh)
    x24 = torch.randn(2 * dp, 24, generator=g24, device=dev)
    errs["grouped dim 24"] = _close(
        poly_eval_batched_sharded_grouped(A4, x24, mesh, views=views),
        poly_eval_flat_batched(A4, x24), "grouped eval at rank 4 dim 24", rtol=2e-3)
    A3 = FlatSymmetricTensor._raw(3, 16, 0.1 * torch.randn(816, generator=g24, device=dev))
    old = os.environ.get("SYMTENSOR_STREAM_BLOCK_ELEMS")
    os.environ["SYMTENSOR_STREAM_BLOCK_ELEMS"] = "40000"
    try:
        ring = tensordot_sharded(A3, A3, 1, mesh, axis="tp", operands="sharded").data
    finally:
        if old is None:
            del os.environ["SYMTENSOR_STREAM_BLOCK_ELEMS"]
        else:
            os.environ["SYMTENSOR_STREAM_BLOCK_ELEMS"] = old
    errs["long ring"] = _close(ring, outer.tensordot(A3, A3, axes=1, stream=True).data,
                               "operand-sharded tensordot, many blocks", rtol=1e-3)
    return {"losses": losses, "errors": errs,
            "replicated groups": sum(g.mode == "replicated" for g in views.groups)}


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the dry run on a new world of `n_devices` ranks and print one
    "OK" line; returns rank 0's losses and normalised errors. Raises if
    any rank fails or the world passes its deadline."""
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    if device == "cuda" and torch.cuda.device_count() >= n_devices:
        backend = "nccl"
    else:
        backend = "gloo"
    out = spawn_world(_rank, n_devices, backend=backend, device=device,
                      timeout_s=timeout_s, args=(dp, tp, device))[0]
    where = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"dryrun_multichip OK: mesh=({dp}x{tp}) dp×tp, backend {backend} on "
          f"{where}; loss {out['losses'][0]:.6f} → {out['losses'][1]:.6f} (as "
          f"train_step); grouped sharded eval ✓ (rank-4 dim-24 with "
          f"{out['replicated groups']} replicated groups ✓), sharded basis "
          f"change ✓, sharded tensordot ✓ (+operand-sharded, long ring ✓)",
          flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
