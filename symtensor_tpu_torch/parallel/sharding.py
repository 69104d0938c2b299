"""Multi-device execution over a ``torch.distributed`` device mesh.

The counterpart of ``symtensor_tpu/parallel/sharding.py``. A mesh has a
data axis and a tensor axis (``make_mesh((dp, tp), ("dp", "tp"))``):

- **dp**: a batch of evaluations is split over the data axis;
- **tp**: the packed values (or a view of them) are split over the tensor
  axis, and a contraction ends with one sum over it.

JAX's ``shard_map`` with ``psum``/``ppermute`` becomes per-rank work on the
rank's part, then explicit collectives on the mesh's subgroups:
``all_reduce`` for the sum over tp, ``all_gather`` to put results back
together, and a ring rotation (``ring_shift``) for the operand-sharded
tensordot. ``NamedSharding`` becomes a ``DTensor`` placement: ``shard_flat``
gives a tensor whose values are a ``DTensor`` with ``Shard(0)`` on the
axis, and ``basis_change_packed(..., mesh=...)`` returns one.

Every function here is collective: each rank of the mesh calls it with the
same arguments (replicated tensors hold the same values on every rank).
The evaluations and ``tensordot_sharded`` return their whole result on
every rank. Gradients: an input that every rank holds whole, of which each
rank reads a disjoint part, passes through ``_GradSum``, whose backward
sums its cotangent over the axes that split the work; the sum over tp is
``_Sum``, whose backward is the identity (the cotangent of a replicated
result is replicated), and the gather over dp is ``_Gather``, whose
backward keeps the rank's slice. So each rank back-propagating the same
replicated loss gets the whole gradient, counted once.

A sharded tensor given to an op outside this layer raises ``TypeError``
(``core.base.require_local``): its local shard is never computed on as if
it were the tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.base import is_sharded
from ..core.flat import FlatSymmetricTensor
from ..utils.precision import compute_dtype, full_fp32_matmul
from ..utils.tables import tables


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape `axis_sizes` over every rank of the
    initialised process group (their product must be its world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.launch.spawn_world)")
    sizes = tuple(int(s) for s in axis_sizes)
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"mesh {sizes} needs {math.prod(sizes)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axis_names))


class _Axis(NamedTuple):
    size: int
    index: int
    group: object


def _axis(mesh, name: str) -> _Axis:
    """(size, this rank's index, process group) of one mesh axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.make_mesh); got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    return _Axis(int(mesh.shape[names.index(name)]), int(mesh.get_local_rank(name)),
                 mesh.get_group(name))


def _placements(mesh, axis: str):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == axis else Replicate() for n in mesh.mesh_dim_names)


def replicated(mesh):
    """The placements that replicate a tensor over the whole mesh."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _sharded_values(local: torch.Tensor, n: int, mesh, axis: str):
    """A ``DTensor`` of n values, ``Shard(0)`` on `axis`, from this rank's
    part (torch.chunk's split: ceil(n/size) a rank, the last ones shorter)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, _placements(mesh, axis),
                              shape=torch.Size((n,)), stride=(1,))


def shard_flat(t: FlatSymmetricTensor, mesh, axis: str) -> FlatSymmetricTensor:
    """`t` with its packed values split over `axis`: a ``DTensor`` with
    ``Shard(0)`` there, each rank keeping n/size values (a copy of its
    part). n must divide by the axis size; the layer's ops pad internally
    and take unsharded tensors."""
    ax = _axis(mesh, axis)
    n = t.data.shape[0]
    if n % ax.size:
        raise ValueError(
            f"component count {n} not divisible by mesh axis '{axis}' "
            f"({ax.size}); use poly_eval_batched_sharded which pads internally")
    L = n // ax.size
    local = t.data[ax.index * L:(ax.index + 1) * L].clone()
    return FlatSymmetricTensor._raw(t.rank, t.dim, _sharded_values(local, n, mesh, axis))


def full_values(data: torch.Tensor) -> torch.Tensor:
    """The whole of 1-D values on this rank: a ``DTensor`` split by
    ``Shard(0)`` over one mesh axis is all-gathered (collective), anything
    else is returned as it is. The layer's own all-gather: DTensor's
    ``full_tensor`` crashes the process under gloo with CUDA tensors."""
    from torch.distributed.tensor import Shard

    if not is_sharded(data):
        return data
    mesh, local = data.device_mesh, data.to_local()
    dims = [i for i, p in enumerate(data.placements) if isinstance(p, Shard)]
    if not dims:
        return local
    if len(dims) > 1 or data.placements[dims[0]].dim != 0 or data.ndim != 1:
        raise TypeError(f"values placed as {data.placements}: the layer gathers "
                        "1-D values split over one mesh axis")
    ax = _axis(mesh, mesh.mesh_dim_names[dims[0]])
    n = data.shape[0]
    L = -(-n // ax.size)
    if local.shape[0] < L:
        local = torch.cat([local, local.new_zeros(L - local.shape[0])])
    return all_gather(local, ax)[:n]


def _values(A: FlatSymmetricTensor) -> torch.Tensor:
    """A's values whole on this rank (a sharded tensor is gathered)."""
    return full_values(A.data)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """Sum `t` over the axis, in place; returns it."""
    if ax.size > 1:
        dist.all_reduce(t, group=ax.group)
    return t


# torch 2.13 renames all_gather_into_tensor (and deprecates the old name)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """The axis' tensors concatenated along dim 0, in axis order."""
    if ax.size == 1:
        return t
    out = t.new_empty((ax.size * t.shape[0], *t.shape[1:]))
    _all_gather_single(out, t.contiguous(), group=ax.group)
    return out


def ring_shift(t: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """The tensor of the rank one before this one on the axis (each rank
    sends its own to the next, the last to the first): one
    ``all_to_all_single`` whose only non-empty splits go to the next rank
    and come from the one before. gloo and NCCL both take it, for CPU and
    CUDA tensors alike; gloo's point-to-point sends take CPU tensors only."""
    if ax.size == 1:
        return t
    n = t.numel()
    send = [0] * ax.size
    recv = [0] * ax.size
    send[(ax.index + 1) % ax.size] = n
    recv[(ax.index - 1) % ax.size] = n
    out = torch.empty_like(t)
    dist.all_to_all_single(out.view(-1), t.contiguous().view(-1), output_split_sizes=recv,
                           input_split_sizes=send, group=ax.group)
    return out


class _GradSum(torch.autograd.Function):
    """The identity on tensors every rank holds whole; backward, each
    cotangent summed over `axes` (the ranks read disjoint parts of them).
    One node for all of a call's inputs, so that every rank runs the
    backward's collectives in one order."""

    @staticmethod
    def forward(ctx, axes, *xs):
        ctx.axes = axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.contiguous().clone()
            for ax in ctx.axes:
                all_reduce(g, ax)
            out.append(g)
        return (None, *out)


def _grad_sum(axes, *xs):
    axes = tuple(ax for ax in axes if ax.size > 1)
    if not axes or not any(x.requires_grad for x in xs) or not torch.is_grad_enabled():
        return xs
    return _GradSum.apply(axes, *xs)


class _Sum(torch.autograd.Function):
    """Sum over the axis forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenate over the axis forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[0]
        return all_gather(x, ax)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.ax.index, ctx.n
        return g[i * n:(i + 1) * n], None


def _sum(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _Sum.apply(x, ax) if ax.size > 1 else x


def _gather(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    return _Gather.apply(x, ax) if ax.size > 1 else x


# ---------------------------------------------------------------------------
# colex-EGF evaluation
# ---------------------------------------------------------------------------


def _batch_slice(xs: torch.Tensor, dp: _Axis) -> torch.Tensor:
    B = xs.shape[0]
    if B % dp.size:
        raise ValueError(f"batch {B} not divisible by dp axis ({dp.size})")
    Bl = B // dp.size
    return xs[dp.index * Bl:(dp.index + 1) * Bl]


def _colex_tables_padded(t, ntp: int):
    """The EGF levels 1..r−1, the last level's (parent, maxel, runlen)
    padded to a multiple of `ntp` (0, 0, 1), the storage position of each
    colex position (0 in the padding) and which positions are real."""

    def build():
        levels = t.mono_tables_weighted(t.rank)
        par, mx, run = levels[-1]
        n = par.shape[0]
        pad = (-n) % ntp
        z = par.new_zeros(pad)
        inv = torch.argsort(t.colex_perm)  # colex position → storage position
        valid = torch.arange(n + pad, device=par.device) < n
        return (levels[:-1], (torch.cat([par, z]), torch.cat([mx, z]),
                              torch.cat([run, z + 1])), torch.cat([inv, z]), valid)

    return t.memo(("colex_sharded", ntp), build)


def poly_eval_batched_sharded(A: FlatSymmetricTensor, xs, mesh, dp_axis: str = "dp",
                              tp_axis: str = "tp") -> torch.Tensor:
    """Batched full contraction Σ A·x⊗…⊗x, xs (B, d) → (B,) on every rank,
    with the batch split over `dp_axis` and the packed values, in colex
    order, over `tp_axis`; one all-reduce over tp. Differentiable in the
    values and in xs (see the module docstring).

    Levels 1..r−1 of the EGF recursion are replicated work; the last
    level's gather and dot run on the rank's shard of the values. Its
    (B/dp, n/tp) transients shrink with tp, the (B/dp, N_{r−1}) level
    before it does not: for large tensors prefer
    ``poly_eval_batched_sharded_grouped``. Ranks 0 and 1 are replicated."""
    r, d = A.rank, A.dim
    vals = _values(A)
    xs = torch.as_tensor(xs, device=vals.device)
    ct = compute_dtype(vals, xs)
    xs = xs.to(ct)
    if r < 2:
        if r == 0:
            return vals[0].to(ct).expand(xs.shape[0])
        with full_fp32_matmul():
            return xs @ vals.to(ct)
    dp, tp = _axis(mesh, dp_axis), _axis(mesh, tp_axis)
    t = tables(r, d, vals.device)
    prior, (par, mx, run), inv, valid = _colex_tables_padded(t, tp.size)
    L = par.shape[0] // tp.size
    sl = slice(tp.index * L, (tp.index + 1) * L)
    vals, xs = _grad_sum((dp, tp), vals, xs)
    xl = _batch_slice(xs, dp)
    v = torch.where(valid[sl], vals[inv[sl]].to(ct), 0.0)
    w = torch.ones((xl.shape[0], 1), dtype=ct, device=xl.device)
    for pl, ml, rl in prior:
        w = w[:, pl] * xl[:, ml] / rl.to(ct)
    w = w[:, par[sl]] * xl[:, mx[sl]] / run[sl].to(ct)
    with full_fp32_matmul():
        part = w @ v
    return float(math.factorial(r)) * _gather(_sum(part, tp), dp)


# ---------------------------------------------------------------------------
# grouped evaluation: the production multi-device path
# ---------------------------------------------------------------------------


class GroupShard(NamedTuple):
    """One group's (P_j, T_j) premultiplied block as a tp rank holds it:
    mode "rows" (rows lo:hi), "cols" (columns lo:hi) or "replicated" (the
    whole block, added by tp rank 0 alone)."""

    mode: str
    lo: int
    hi: int
    block: torch.Tensor


class ShardedGroupViews(NamedTuple):
    """``shard_group_views``'s result: the rank's part of every group, and
    the tp axis size and index it was placed for."""

    rank: int
    tp: int
    index: int
    groups: Tuple[GroupShard, ...]


def shard_group_views(A: FlatSymmetricTensor, mesh, tp_axis: str = "tp") -> ShardedGroupViews:
    """The premultiplied group blocks of A (``kernels/poly_eval.py``,
    ``group_views_premul``), each split over `tp_axis`: its P_j rows where
    they divide by the axis size, else its T_j columns (the product is
    linear in them too), else replicated (groups are small at both ends of
    j). Each rank keeps a copy of its parts: about 1/tp of the values, plus
    the replicated groups; at tp = 1 the blocks are views of one copy of
    the values, as on one device. Rank ≥ 3."""
    from ..kernels.poly_eval import _grouped_static, _premul_blocks

    r, d = A.rank, A.dim
    if r < 3:
        raise ValueError(f"group views need rank >= 3; got rank {r}")
    tp = _axis(mesh, tp_axis)
    views = _premul_blocks(_values(A).detach(), r, d)
    P, T, _, _ = _grouped_static(r, d)
    groups = []
    for j, V in enumerate(views.blocks):
        if P[j] % tp.size == 0:
            L = P[j] // tp.size
            g = GroupShard("rows", tp.index * L, (tp.index + 1) * L, None)
            blk = V[g.lo:g.hi]
        elif T[j] % tp.size == 0:
            L = T[j] // tp.size
            g = GroupShard("cols", tp.index * L, (tp.index + 1) * L, None)
            blk = V[:, g.lo:g.hi]
        else:
            g, blk = GroupShard("replicated", 0, P[j], None), V
        groups.append(g._replace(block=blk.clone() if tp.size > 1 else blk))
    return ShardedGroupViews(r, tp.size, tp.index, tuple(groups))


def poly_eval_batched_sharded_grouped(A: FlatSymmetricTensor, xs, mesh,
                                      dp_axis: str = "dp", tp_axis: str = "tp",
                                      views: ShardedGroupViews = None) -> torch.Tensor:
    """Batched full contraction on the premultiplied group blocks, xs
    (B, d) → (B,) on every rank: the batch split over `dp_axis`, every
    group split over `tp_axis` as ``shard_group_views`` places it. Each
    rank computes tri[:, T-slice]·V_localᵀ for every group, weighted by its
    slice of M̃ and by x_j, adds all groups, and one all-reduce over tp
    sums the ranks. At tp = 1 it runs the GEMMs of
    ``views_eval_batched_premul`` in the same order. Pass `views` (from
    ``shard_group_views`` on the same axis) to reuse a placement; ranks
    below 3 are data-parallel only. Differentiable in xs."""
    from ..kernels.poly_eval import _grouped_static, _head_weights, _tri
    from ..ops.contract import contract_all_indices_with_vector_batched

    r, d = A.rank, A.dim
    dp, tp = _axis(mesh, dp_axis), _axis(mesh, tp_axis)
    if r < 3:
        vals = _values(A)
        xs = torch.as_tensor(xs, device=vals.device)
        vals, xs = _grad_sum((dp,), vals, xs)
        xl = _batch_slice(xs, dp)
        if r == 0:
            ct = compute_dtype(vals, xs)
            return vals[0].to(ct).expand(xs.shape[0])
        out = contract_all_indices_with_vector_batched(
            FlatSymmetricTensor._raw(r, d, vals), xl)
        return _gather(out, dp)
    if views is None:
        views = shard_group_views(A, mesh, tp_axis)
    elif (views.rank, views.tp, views.index) != (r, tp.size, tp.index):
        raise ValueError("views were placed for another rank or tp axis")
    V0 = views.groups[0].block
    xs = torch.as_tensor(xs, device=V0.device)
    ct = compute_dtype(V0, xs)
    (xs,) = _grad_sum((dp, tp), xs.to(ct))
    xl = _batch_slice(xs, dp)
    t = tables(r, d, V0.device)
    tri = _tri(t, xl)
    M, _, _ = _head_weights(t, xl, r)
    P, T, _, toff = _grouped_static(r, d)
    total = torch.zeros((xl.shape[0],), dtype=ct, device=xl.device)
    with full_fp32_matmul():
        for j, g in enumerate(views.groups):
            if g.mode == "replicated" and tp.index:
                continue
            if g.mode == "cols":
                u = tri[:, toff[j] + g.lo:toff[j] + g.hi] @ g.block.to(ct).T
                w = M[:, :P[j]]
            else:
                u = tri[:, toff[j]:toff[j] + T[j]] @ g.block.to(ct).T
                w = M[:, g.lo:g.hi]
            total = total + xl[:, j] * torch.einsum("bp,bp->b", w, u)
    return _gather(float(math.factorial(r)) * _sum(total, tp), dp)


# ---------------------------------------------------------------------------
# tensordot with output blocks split over an axis
# ---------------------------------------------------------------------------


def _td_setup(a, b, axes: int):
    from ..ops import outer as outer_mod

    af, bf = outer_mod._as_flat(_gathered(a)), outer_mod._as_flat(_gathered(b))
    ra, rb, k = af.rank, bf.rank, int(axes)
    if k > min(ra, rb) or k < 1:
        raise ValueError(f"cannot contract {k} axes between ranks {ra} and {rb}")
    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    return af, bf, outer_mod._stream_setup(af, bf, k)


def _gathered(t):
    """A flat operand with sharded values, gathered whole."""
    if isinstance(t, FlatSymmetricTensor) and is_sharded(t.data):
        return FlatSymmetricTensor._raw(t.rank, t.dim, full_values(t.data))
    return t


def _blocks(st, B: int, ax: _Axis):
    """This rank's output blocks [o0, o0 + B): the block count rounded up
    to a multiple of the axis size, a contiguous run of them a rank (the
    ones past n_out are empty)."""
    nblk = -(-st.n_out // B)
    per = -(-nblk // ax.size)
    return [(ax.index * per + i) * B for i in range(per)], per * B


def _td_result(st, local: torch.Tensor, ax: _Axis) -> FlatSymmetricTensor:
    out = all_gather(local, ax)[:st.n_out]
    if st.r_out == 0:
        return FlatSymmetricTensor._raw(0, 1, out[:1])
    return FlatSymmetricTensor._raw(st.r_out, st.t_a.dim, out)


def tensordot_sharded(a, b, axes: int, mesh, axis: str = "tp",
                      operands: str = "replicated") -> FlatSymmetricTensor:
    """Symmetrized streamed tensordot with the output blocks split over
    `axis`; the result whole on every rank (one all-gather).

    - ``operands="replicated"``: every rank holds both operands and runs
      the streamed route's block loop (``ops/outer.py``) on its own blocks.
      Compute scales with the axis; memory does not.
    - ``operands="sharded"``: the operands' values are padded and split
      over `axis` (a ``shard_flat`` operand keeps its own shards); each
      block runs `size` ring steps, each a masked gather of the resident
      shards into two (n_sub, n_k, B) workspaces, then a rotation of the
      shards one rank along (``ring_shift``). No rank holds a whole
      operand.

    Values equal ``ops.outer.tensordot(..., stream=True)``."""
    if operands == "sharded":
        return _tensordot_sharded_operands(a, b, axes, mesh, axis)
    if operands != "replicated":
        raise ValueError(f"unknown operands mode {operands!r}")
    from ..ops import outer as outer_mod

    af, bf, st = _td_setup(a, b, axes)
    ax = _axis(mesh, axis)
    B = outer_mod._stream_block_size(st)
    starts, span = _blocks(st, B, ax)
    local = torch.zeros(span, dtype=st.dt, device=af.device)
    for i, o0 in enumerate(starts):
        if o0 < st.n_out:
            local[i * B:i * B + min(B, st.n_out - o0)] = outer_mod._stream_block(
                st, af.data, bf.data, st.rep_T[:, o0:o0 + B])
    return _td_result(st, local, ax)


def _operand_shard(t, ax: _Axis, mesh, axis: str) -> FlatSymmetricTensor:
    """An operand's rank and dim with this rank's part of its values,
    padded to a multiple of the axis size: a sharded operand's own shard,
    else a slice."""
    from ..ops import outer as outer_mod

    if isinstance(t, FlatSymmetricTensor) and is_sharded(t.data):
        if tuple(t.data.placements) != _placements(mesh, axis):
            raise TypeError(f"operand is sharded as {t.data.placements}; "
                            f"tensordot_sharded needs Shard(0) on '{axis}'")
        return FlatSymmetricTensor._raw(t.rank, t.dim, t.data.to_local())
    t = outer_mod._as_flat(t)
    L = -(-t.data.shape[0] // ax.size)
    part = t.data[ax.index * L:(ax.index + 1) * L]
    if part.shape[0] < L:
        part = torch.cat([part, part.new_zeros(L - part.shape[0])])
    return FlatSymmetricTensor._raw(t.rank, t.dim, part)


def _tensordot_sharded_operands(a, b, axes: int, mesh, axis: str) -> FlatSymmetricTensor:
    from ..ops import outer as outer_mod

    ax = _axis(mesh, axis)
    am, bm = _operand_shard(a, ax, mesh, axis), _operand_shard(b, ax, mesh, axis)
    a_sh, b_sh = am.data, bm.data
    k = int(axes)
    if k > min(am.rank, bm.rank) or k < 1:
        raise ValueError(f"cannot contract {k} axes between ranks {am.rank} and {bm.rank}")
    if am.dim != bm.dim:
        raise ValueError(f"dim mismatch: {am.dim} vs {bm.dim}")
    st = outer_mod._stream_setup(am, bm, k)
    n_k, n_sub = st.creps_T.shape[1], len(st.subsets)
    # the ring keeps two (n_sub, n_k, B) workspaces resident
    B = max(1, min(st.n_out, outer_mod._streamed_block_elems() // max(1, 2 * n_sub * n_k)))
    starts, span = _blocks(st, B, ax)
    La, Lb = a_sh.shape[0], b_sh.shape[0]
    local = torch.zeros(span, dtype=st.dt, device=a_sh.device)
    for i, o0 in enumerate(starts):
        # blocks past n_out still run the ring (every rank rotates in step)
        blk = st.rep_T[:, min(o0, st.n_out - 1):min(o0 + B, st.n_out)]
        pos = list(outer_mod._stream_positions(st, blk))
        pa = torch.stack([p for p, _ in pos])  # (n_sub, n_k, Bb)
        pb = torch.stack([q for _, q in pos])
        av = torch.zeros(pa.shape, dtype=st.dt, device=a_sh.device)
        bv = torch.zeros(pb.shape, dtype=st.dt, device=a_sh.device)
        a_cur, b_cur, sid = a_sh, b_sh, ax.index
        for step in range(ax.size):
            _masked_add(av, a_cur, pa - sid * La)
            _masked_add(bv, b_cur, pb - sid * Lb)
            if step + 1 < ax.size:
                # after the rotation this rank holds the shard of the rank
                # one before it
                a_cur, b_cur = ring_shift(a_cur, ax), ring_shift(b_cur, ax)
                sid = (sid - 1) % ax.size
        if o0 < st.n_out:
            acc = (st.gam[None, :, None] * (av * bv)).sum((0, 1)) / n_sub
            local[i * B:i * B + acc.shape[0]] = acc
    return _td_result(st, local, ax)


def _masked_add(acc: torch.Tensor, shard: torch.Tensor, loc: torch.Tensor) -> None:
    """acc += shard[loc] where 0 ≤ loc < len(shard)."""
    inside = (loc >= 0) & (loc < shard.shape[0])
    acc += torch.where(inside, shard[loc.clamp(0, shard.shape[0] - 1)], 0.0)
