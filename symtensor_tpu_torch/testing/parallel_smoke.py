"""The parallel layer on the card at full width: the cases of
``chip_smoke.py``'s phase 30, run on every rank of a world
(``parallel.launch``). Each rank computes; rank 0 returns the lines for
the caller to print. A result that disagrees raises, which fails the
world and the caller.

`cfg` holds the shapes (chip_smoke.py's ``PARALLEL`` constants); every
input is drawn on the card from a seeded generator.
"""

from __future__ import annotations

import statistics
import time

import torch
import torch.distributed as dist

from ..core.flat import FlatSymmetricTensor
from ..kernels import group_pass as gp
from ..kernels.poly_eval import (
    group_views_premul,
    poly_eval_flat_batched,
    views_eval_batched_premul,
)
from ..models import polynomial
from ..ops import basis_change as bc
from ..ops import outer
from ..ops.contract import contract_all_indices_with_vector
from ..parallel import sharding
from ..parallel.dryrun import sharded_loss
from ..utils import indep_size
from ..utils.tables import tables


def _dev() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def _events(fn, reps: int):
    """(median ms of `reps` calls by CUDA events, the last result)."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def _turns(fns: dict, reps: int):
    """{name: (median ms, last result)}: one warm-up call each, then
    `reps` rounds in turns, the order reversed every other round."""
    names = list(fns)
    out = {n: fns[n]() for n in names}
    times = {n: [] for n in names}
    for i in range(reps):
        for n in (names if i % 2 == 0 else names[::-1]):
            t, out[n] = _events(fns[n], 1)
            times[n].append(t)
    return {n: (statistics.median(times[n]), out[n]) for n in names}


def _nerr(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _check(lines, what: str, err: float, tol: float) -> None:
    lines.append(f"{what}: normalised error {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"parallel: {what} disagrees ({err:.3e} > {tol:g})")


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device=_dev())


def _mesh_text(mesh) -> str:
    return f"mesh {tuple(mesh.shape)} (dp, tp), {dist.get_backend()}"


def grouped(mesh, lines, ranks, dim, batch, reps, seed, tol, vs_premul_bits=False):
    """poly_eval_batched_sharded_grouped against the premultiplied views'
    unsharded route (``views_eval_batched_premul``), float32."""
    for r in ranks:
        gen = torch.Generator(device=_dev()).manual_seed(seed + r)
        A = FlatSymmetricTensor._raw(r, dim, _rand(gen, indep_size(r, dim)))
        xs = _rand(gen, batch, dim) / dim**0.5
        t0 = time.perf_counter()
        views = sharding.shard_group_views(A, mesh)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        ref_views = group_views_premul(A)
        res = _turns({
            "sharded": lambda: sharding.poly_eval_batched_sharded_grouped(
                A, xs, mesh, views=views),
            "unsharded": lambda: views_eval_batched_premul(ref_views, xs)}, reps)
        (ms, got), (ref_ms, want) = res["sharded"], res["unsharded"]
        modes = [g.mode for g in views.groups]
        what = (f"grouped eval rank {r} dim {dim} B {batch} float32, {_mesh_text(mesh)}: "
                f"{ms:.3f} ms against {ref_ms:.3f} ms unsharded (medians of {reps} in "
                "turns); "
                f"placement {place_s:.3f} s, groups by rows {modes.count('rows')}, by "
                f"columns {modes.count('cols')}, replicated {modes.count('replicated')}; "
                f"equal bit for bit {torch.equal(got, want)}")
        _check(lines, what, _nerr(got, want), tol)
        if vs_premul_bits and not torch.equal(got, want):
            raise AssertionError("parallel: at tp = 1 the grouped eval should run the "
                                 "unsharded GEMMs bit for bit")
        del A, xs, views, ref_views, got, want
        torch.cuda.empty_cache()


def colex(mesh, lines, rank, dim, batch, reps, seed, tol):
    """poly_eval_batched_sharded against poly_eval_flat_batched, float32."""
    gen = torch.Generator(device=_dev()).manual_seed(seed)
    A = FlatSymmetricTensor._raw(rank, dim, _rand(gen, indep_size(rank, dim)))
    xs = _rand(gen, batch, dim) / dim**0.5
    t0 = time.perf_counter()
    sharding.poly_eval_batched_sharded(A, xs, mesh)  # first call: its tables
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _events(lambda: sharding.poly_eval_batched_sharded(A, xs, mesh), 1)
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    res = _turns({"sharded": lambda: sharding.poly_eval_batched_sharded(A, xs, mesh),
                  "unsharded": lambda: poly_eval_flat_batched(A, xs)}, reps)
    (ms, got), (ref_ms, want) = res["sharded"], res["unsharded"]
    _check(lines, f"colex eval rank {rank} dim {dim} B {batch} float32, {_mesh_text(mesh)}: "
           f"{ms:.3f} ms against poly_eval_flat_batched's {ref_ms:.3f} ms (medians of "
           f"{reps} in turns; first call {first:.3f} s with its tables), peak {peak:.3f} "
           "GB over its inputs", _nerr(got, want), tol)


def train(mesh, lines, ranks, dim, batch, steps, lr, scale, seed, tol):
    """Adam steps of the dry run's loss (``dryrun.sharded_loss``) against
    ``polynomial.train_step`` from the same seed."""
    dev = _dev()

    def model():
        return polynomial.init(ranks, dim, generator=torch.Generator(device=dev).manual_seed(seed),
                               dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    xs = _rand(gen, batch, dim) * (scale / dim)
    ys = _rand(gen, batch)
    sharded, plain = model(), model()
    opt_s = torch.optim.Adam(sharded.parameters(), lr=lr)
    opt_p = torch.optim.Adam(plain.parameters(), lr=lr)
    got, want, ms = [], [], []
    for _ in range(steps):
        def step():
            opt_s.zero_grad(set_to_none=True)
            loss = sharded_loss(sharded, xs, ys, mesh)
            loss.backward()
            opt_s.step()
            return loss.detach()
        t, loss = _events(step, 1)
        ms.append(t)
        got.append(float(loss))
        want.append(float(polynomial.train_step(plain, opt_p, xs, ys)))
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    falling = all(b < a for a, b in zip(got, got[1:]))
    _check(lines, f"training ranks {ranks} dim {dim} B {batch}, {steps} Adam steps (lr "
           f"{lr:g}) through the colex route, {_mesh_text(mesh)}: losses "
           f"{', '.join(f'{v:.6f}' for v in got)} against train_step's "
           f"{', '.join(f'{v:.6f}' for v in want)}; steps "
           f"{', '.join(f'{v:.1f}' for v in ms)} ms; finite and falling {falling} "
           "(relative error of the losses)", err, tol)
    if not (falling and all(v == v and abs(v) < float("inf") for v in got)):
        raise AssertionError("parallel: sharded training losses not finite and falling")


def basis(mesh, lines, cases, seed, tol, check_inputs, unsharded=False):
    """basis_change_packed under the mesh: time, peak memory, and p_C(y)
    against p_A(W y) through the group-pass kernel (the launches counted),
    or against the unsharded call where `unsharded`."""
    dev = _dev()
    for r, d, d_out in cases:
        gen = torch.Generator(device=dev).manual_seed(seed + d)
        A = FlatSymmetricTensor._raw(r, d, _rand(gen, indep_size(r, d)))
        W = _rand(gen, d, d_out) / d**0.5
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        C = bc.basis_change_packed(A, W, mesh=mesh)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        lc = dict(bc.last_call)
        full = sharding.full_values(C.data)
        if not (C.rank == r and C.dim == d_out and full.shape == (indep_size(r, d_out),)
                and bool(torch.isfinite(full).all())):
            raise AssertionError("parallel: sharded basis change gave a wrong shape or "
                                 "non-finite values")
        what = (f"basis change rank {r} dim {d} -> {d_out} float32 blocks, "
                f"{_mesh_text(mesh)}: {start.elapsed_time(end) / 1e3:.3f} s by CUDA "
                f"events (host {wall:.3f} s, first call, tables included), peak "
                f"{peak:.3f} GB over A and W; root shard {lc['root_shard']} of "
                f"{lc['root']} values, result shard {C.data.to_local().shape[0]}, "
                f"{lc['chunks']} chunks, rows a level {lc['rows']}")
        if unsharded:
            want = bc.basis_change_packed(A, W).data
            _check(lines, what + "; against the unsharded call", _nerr(full, want), tol)
            del want
        else:
            ys = _rand(gen, check_inputs, d_out) / d_out**0.5
            gp.group_pass.launches = 0
            got = torch.stack([contract_all_indices_with_vector(
                FlatSymmetricTensor._raw(r, d_out, full), y) for y in ys])
            ref = torch.stack([contract_all_indices_with_vector(A, W @ y) for y in ys])
            launches = gp.group_pass.launches
            _check(lines, what + f"; p_C(y) vs p_A(W y), {check_inputs} inputs "
                   f"({launches} group_pass launches)", _nerr(got, ref), tol)
            if launches < 2 * check_inputs:
                raise AssertionError("parallel: the checks did not launch group_pass")
        del A, W, C, full
        for rr, dd in {(r, d), (r, d_out)} | {(k, d) for k in range(1, r + 1)}:
            tables(rr, dd, dev)._cache.clear()
        torch.cuda.empty_cache()


def tensordot(mesh, lines, rank, dim, axes, reps, seed, tol):
    """Both operand modes of tensordot_sharded against the streamed route."""
    gen = torch.Generator(device=_dev()).manual_seed(seed)
    n = indep_size(rank, dim)
    A = FlatSymmetricTensor._raw(rank, dim, _rand(gen, n))
    B = FlatSymmetricTensor._raw(rank, dim, _rand(gen, n))
    res = _turns({
        "streamed": lambda: outer.tensordot(A, B, axes=axes, stream=True),
        "replicated": lambda: sharding.tensordot_sharded(A, B, axes, mesh, axis="tp",
                                                         operands="replicated"),
        "sharded": lambda: sharding.tensordot_sharded(A, B, axes, mesh, axis="tp",
                                                      operands="sharded")}, reps)
    ref_ms, want = res["streamed"]
    for mode in ("replicated", "sharded"):
        ms, got = res[mode]
        _check(lines, f"tensordot rank {rank} x rank {rank} dim {dim} axes {axes}, "
               f"operands {mode}, {_mesh_text(mesh)}: {ms:.3f} ms against the streamed "
               f"route's {ref_ms:.3f} ms (medians of {reps} in turns)",
               _nerr(got.data, want.data), tol)


def world1(cfg: dict):
    """The world of one rank (NCCL, mesh (1, 1)) at full width."""
    mesh = sharding.make_mesh((1, 1), ("dp", "tp"), device_type="cuda")
    lines = []
    grouped(mesh, lines, cfg["grouped_ranks"], cfg["dim"], cfg["batch"], cfg["reps"],
            cfg["seed"], 1e-6, vs_premul_bits=True)
    colex(mesh, lines, cfg["colex_rank"], cfg["dim"], cfg["colex_batch"], cfg["reps"],
          cfg["seed"], 1e-5)
    train(mesh, lines, cfg["train_ranks"], cfg["dim"], cfg["colex_batch"], cfg["steps"],
          cfg["lr"], cfg["input_scale"], cfg["seed"], 1e-4)
    basis(mesh, lines, cfg["basis_cases"], cfg["seed"], 1e-4, cfg["check_inputs"])
    tensordot(mesh, lines, *cfg["c1"], 1, cfg["reps"], cfg["seed"], 1e-5)
    return lines


def world2(cfg: dict):
    """The world of two ranks on one card (gloo), meshes (1, 2) and (2, 1):
    each result against the unsharded op on the card."""
    lines = []
    for shape in ((1, 2), (2, 1)):
        mesh = sharding.make_mesh(shape, ("dp", "tp"), device_type="cuda")
        grouped(mesh, lines, [cfg["colex_rank"]], cfg["dim"], cfg["batch"], cfg["reps"],
                cfg["seed"], 1e-5)
        colex(mesh, lines, cfg["colex_rank"], cfg["dim"], cfg["colex_batch"], cfg["reps"],
              cfg["seed"], 1e-5)
        basis(mesh, lines, [cfg["basis_small"]], cfg["seed"], 1e-5, 0, unsharded=True)
        tensordot(mesh, lines, *cfg["c1"], 1, cfg["reps"], cfg["seed"], 1e-5)
    return lines if dist.get_rank() == 0 else None


def cards(cfg: dict):
    """A world of one rank a card (NCCL), meshes (1, n) and (2, n/2) at
    full width: rank 6 grouped, the colex route and training through it,
    the rank-6 dim-100 basis change over all n cards, and tensordot."""
    n = dist.get_world_size()
    lines = []
    for shape in ((1, n), (2, n // 2)):
        mesh = sharding.make_mesh(shape, ("dp", "tp"), device_type="cuda")
        grouped(mesh, lines, (6,), cfg["dim"], cfg["batch"], cfg["reps"], cfg["seed"], 1e-5)
        colex(mesh, lines, cfg["colex_rank"], cfg["dim"], cfg["colex_batch"], cfg["reps"],
              cfg["seed"], 1e-5)
        train(mesh, lines, cfg["train_ranks"], cfg["dim"], cfg["colex_batch"], cfg["steps"],
              cfg["lr"], cfg["input_scale"], cfg["seed"], 1e-4)
        if shape[0] == 1:
            basis(mesh, lines, cfg["basis_cases"][:1], cfg["seed"], 1e-4, cfg["check_inputs"])
        tensordot(mesh, lines, *cfg["c1"], 1, cfg["reps"], cfg["seed"], 1e-5)
    return lines if dist.get_rank() == 0 else None
