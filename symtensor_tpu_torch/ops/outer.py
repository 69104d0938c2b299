"""Symmetrized outer products and tensordot on packed storage.

The counterpart of ``symtensor_tpu/ops/outer.py``, for flat operands and
plain tensors. The position-subset identity: for symmetric A (rank ra) and
B (rank rb),

    sym(A ⊗ B)[K] = (1/C(r, ra)) · Σ_{S ⊆ positions(K), |S|=ra} A[K_S]·B[K_∖S]

with K a sorted output multiset; symmetrized tensordot over k axes adds an
inner sum over contraction multisets C with multiplicity γ_C:

    sym(A ·_k B)[K] = (1/C(r_out, ra−k)) Σ_S Σ_C γ_C · A[sort(K_S ∪ C)] · B[sort(C ∪ K_∖S)]

Routes, in the JAX package's order and with its gates and environment
names:

- ``multiply.outer`` of floating operands under the table guard: host
  subset tables, then the gather-combine kernel (``kernels/gather_mm.py``;
  the plain twin on a CPU tensor). Integer operands, and ``add``/
  ``subtract``, loop over the subsets in plain torch.
- ``tensordot``: the pair-contraction route (one GEMM over small expanded
  matrices, then n_sub gathers per output) when its tables fit
  ``SYMTENSOR_TENSORDOT_PAIRED`` (1.5·10⁸ entries); else the host tables
  and the gather-combine kernel under the table guard; else streamed.
- Streamed (``stream=True``, or past the table guard): a Python loop over
  output blocks of ``SYMTENSOR_STREAM_BLOCK_ELEMS`` (2**22) budgeted
  elements, ranking gather positions on the device by the closed form
  (``Tables.position_T``/``position_insert_T``). The last block is just
  shorter: eager torch needs no padding to a fixed shape.

Left behind with the TPU: the traced-table limit and every
``jax.core.Tracer`` check (torch has no tracing that bakes tables into a
program), the int8/int16 index tables of the streamed route and their
``SYMTENSOR_STREAM_IDT`` variable (a lane-layout trick; positions here are
int64), and the TPU's reasons in the block budget.

Two decomp operands stay decomposed: ``multiply.outer`` is
``outer_decomp`` and ``tensordot`` is ``tensordot_decomp`` (exact,
structural, plain torch). A decomp operand beside any other goes through
``toflat()`` like every other format.

Result formats follow ``_wrap_result`` (``outer.py:50-58``): dense if
every symmetric operand is dense, permcls if every one is permcls, else
flat. Every route computes on flat operands (``_as_flat``), so permcls,
dense and mixed decomp operands take the same kernels.
"""

from __future__ import annotations

import itertools
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import config
from ..core.base import SymmetricTensor, default_device, require_local
from ..core.dense import DenseSymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..kernels import gather_mm
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import _check_table, tables

_FNS = {
    "multiply": torch.mul,
    "add": torch.add,
    "subtract": torch.sub,
}


def _as_flat(x, device=None) -> FlatSymmetricTensor:
    """Coerce an operand to flat: a symmetric tensor of any format, a
    scalar (rank 0), a vector (rank 1) or a dense symmetric array. A
    ``torch.Tensor`` keeps its device; other data goes to `device`, by
    default ``config.default_device``."""
    require_local("outer product", x)
    if isinstance(x, SymmetricTensor):
        return x.toflat()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(
            x, device=device if device is not None else default_device()
        )
    if x.ndim == 0:
        return FlatSymmetricTensor._raw(0, 1, x.reshape(1))
    if x.ndim == 1:
        return FlatSymmetricTensor._raw(1, x.shape[0], x)
    return FlatSymmetricTensor.from_dense(x)


def _as_flat_pair(a, b) -> Tuple[FlatSymmetricTensor, FlatSymmetricTensor]:
    """Coerce both operands to flat. Data that is not a tensor goes to the
    device of the other operand where that one is a tensor, else to
    ``config.default_device``."""
    flat = [
        _as_flat(x) if isinstance(x, (SymmetricTensor, torch.Tensor)) else None
        for x in (a, b)
    ]
    known = [f.device for f in flat if f is not None]
    dev = known[0] if known else None
    return tuple(
        f if f is not None else _as_flat(x, dev) for f, x in zip(flat, (a, b))
    )


def _flat(rank: int, dim: int, vals: torch.Tensor) -> FlatSymmetricTensor:
    if rank == 0:
        return FlatSymmetricTensor._raw(0, 1, vals.reshape(1))
    return FlatSymmetricTensor._raw(rank, dim, vals)


def _wrap_result(flat: FlatSymmetricTensor, *operands) -> SymmetricTensor:
    """The result's format: dense only if every symmetric operand is dense
    (densified under ``config.max_dense_elements``), permcls only if every
    one is permcls, else flat."""
    formats = {o.format for o in operands if isinstance(o, SymmetricTensor)}
    if formats == {"dense"}:
        return DenseSymmetricTensor._raw(flat.rank, flat.dim, flat.todense())
    if formats == {"permcls"}:
        return flat.topermcls()
    return flat


def _position_rows(rank: int, dim: int, rows: np.ndarray) -> np.ndarray:
    """Host int64 positions of ascending (N, rank) rows."""
    if rank == 0:
        return np.zeros(len(rows), dtype=np.int64)
    if rank == 1:
        return rows[:, 0]
    return comb.gflat_layout(rank, dim).position_array(rows)


def _dev_i32(x: np.ndarray, device) -> torch.Tensor:
    """An int32 device copy of an int64 host position table."""
    if x.size and int(x.max()) >= gather_mm.INDEX_LIMIT:
        raise OverflowError("index table exceeds int32 range")
    return torch.as_tensor(x.astype(np.int32), device=device)


def _subsets(r: int, ra: int):
    """The position subsets S of size ra and their complements."""
    for S in itertools.combinations(range(r), ra):
        yield list(S), [i for i in range(r) if i not in S]


def _subset_tables(ra: int, rb: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each of the C(ra+rb, ra) position subsets: packed positions of
    the A-part and B-part of every output multiset, as (n_sub, n_out) int32
    device tensors (positions computed in int64 on the host)."""
    t_out = tables(ra + rb, dim, device)

    def build():
        rep = t_out.rep_np()
        _check_table(
            2 * comb.binom(ra + rb, ra) * t_out.n, f"subset_tables({ra},{rb})"
        )
        rows = [
            (_position_rows(ra, dim, rep[:, S]), _position_rows(rb, dim, rep[:, Sc]))
            for S, Sc in _subsets(ra + rb, ra)
        ]
        return tuple(
            _dev_i32(np.stack([r[i] for r in rows]), device) for i in (0, 1)
        )

    return t_out.memo(("subset_tables", ra, rb), build)


def symmetric_outer(a, b, fn: str = "multiply", stream: bool = None):
    """sym(fn.outer(a, b)) for fn ∈ {multiply, add, subtract}. `stream`
    forces (True) or forbids (False) the blocked streamed route; by default
    it streams when the subset tables would exceed the table guard. Two
    decomp operands of rank ≥ 1 under ``multiply`` stay decomp."""
    if fn == "multiply" and _both_decomp(a, b) and a.rank > 0 and b.rank > 0:
        return a.outer_decomp(b)
    return _wrap_result(_outer_flat(a, b, fn, stream), a, b)


def _both_decomp(a, b) -> bool:
    return (
        isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor)
        and a.format == b.format == "decomp"
    )


def _outer_flat(a, b, fn: str, stream) -> FlatSymmetricTensor:
    af, bf = _as_flat_pair(a, b)
    ra, rb = af.rank, bf.rank
    f = _FNS[fn]

    # A scalar operand makes fn.outer elementwise against the other
    # operand, keeping argument order.
    if ra == 0 or rb == 0:
        if ra == 0 and rb == 0:
            return _flat(0, 1, f(af.data, bf.data))
        if ra == 0:
            return _flat(rb, bf.dim, f(af.data[0], bf.data))
        return _flat(ra, af.dim, f(af.data, bf.data[0]))

    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim, r = af.dim, ra + rb

    if stream is None:
        entries = 2 * comb.binom(r, ra) * comb.indep_size(r, dim)
        stream = entries > config.max_table_entries
    if stream:
        if fn == "multiply":
            vals = _combine_streamed(af, bf, 0)
        else:
            # add/subtract outers are affine in the operands: the
            # multiplicative route against an all-ones operand.
            ones_a = FlatSymmetricTensor._raw(ra, dim, torch.ones_like(af.data))
            ones_b = FlatSymmetricTensor._raw(rb, dim, torch.ones_like(bf.data))
            va = _combine_streamed(af, ones_b, 0)
            vb = _combine_streamed(ones_a, bf, 0)
            vals = va + vb if fn == "add" else va - vb
        return _flat(r, dim, vals)

    ta, tb = _subset_tables(ra, rb, dim, af.device)
    if fn == "multiply" and gather_mm.usable(af.data, bf.data):
        return _flat(r, dim, gather_mm.gather_combine(af.data, bf.data, ta, tb))

    acc = None
    for s in range(ta.shape[0]):
        term = f(af.data[ta[s]], bf.data[tb[s]])
        acc = term if acc is None else acc + term
    return _flat(r, dim, acc / ta.shape[0])


def _tensordot_tables(ra: int, rb: int, k: int, dim: int, device):
    """Subset × contraction-multiset gather tables of symmetrized
    tensordot: positions into A of sort(K_S ∪ C) and into B of
    sort(C ∪ K_∖S), each (n_sub, n_k, n_out) int32 on the device; γ_C in
    float64; n_sub."""
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim, device)

    def build():
        rep = t_out.rep_np()
        creps = tables(k, dim, device).rep_np()  # (n_k, k)
        n_k, n_out = len(creps), len(rep)
        subsets = list(_subsets(r_out, ka))
        _check_table(
            2 * len(subsets) * n_k * max(n_out, 1),
            f"tensordot_tables({ra},{rb},{k})",
        )
        A_tab = np.empty((len(subsets), n_k, n_out), dtype=np.int64)
        B_tab = np.empty_like(A_tab)
        full = np.empty((n_out, max(ra, rb)), dtype=np.int64)
        for si, (S, Sc) in enumerate(subsets):
            for ci, c in enumerate(creps):
                for tab, part, rk in ((A_tab, S, ra), (B_tab, Sc, rb)):
                    cols = full[:, :rk]
                    cols[:, : len(part)] = rep[:, part]
                    cols[:, len(part):] = c
                    tab[si, ci] = _position_rows(rk, dim, np.sort(cols, axis=1))
        gam = tables(k, dim, device).multiplicity
        return _dev_i32(A_tab, device), _dev_i32(B_tab, device), gam, len(subsets)

    return t_out.memo(("tensordot_tables", ra, rb, k), build)


# ---------------------------------------------------------------------------
# Pair-contraction route: out[K] = (1/n_sub) Σ_S G[pos(K_S), pos(K_∖S)]
# with G = F_A · diag(γ) · F_Bᵀ and F_A[u, c] = A[sort(u ∪ c)].
#
# The contraction-multiset sum collapses into one GEMM over the small
# expanded matrices (N_ka, N_k)·(N_k, N_kb), and the per-output work drops
# from 2·n_sub·n_k gathered elements to n_sub gathered elements of G.
#
# Every position the route reads is static per (ranks, dim). The JAX
# package computes them inside one jitted program; eager torch would
# recompute them at every call (about 200 small launches at rank-3 ×
# rank-3 dim 30), so they are computed once per device and memoized on the
# tables: a call is two gathers, one GEMM and n_sub gather-adds.
# ---------------------------------------------------------------------------


def _paired_limit() -> int:
    return int(os.environ.get("SYMTENSOR_TENSORDOT_PAIRED", 150_000_000))


def _expand_positions(klvl: int, k: int, dim: int, device) -> torch.Tensor:
    """(N_klvl, N_k) int64 on the device: position in the rank-(klvl+k)
    layout of sort(u ∪ c), u the row multiset (size klvl), c the column
    contraction multiset. k = 1 ranks on the device by
    ``position_insert_T`` (the d singletons are the contraction
    multisets); k ≥ 2 sorts and ranks on the host."""
    t_full = tables(klvl + k, dim, device)

    def build():
        if k == 1:
            return t_full.position_insert_T(tables(klvl, dim, device).rep_T)
        rep_u = tables(klvl, dim, device).rep_np()  # (n_u, klvl)
        rep_c = tables(k, dim, device).rep_np()  # (n_k, k)
        out = np.empty((len(rep_u), len(rep_c)), np.int64)
        cols = np.empty((len(rep_u), klvl + k), np.int64)
        cols[:, :klvl] = rep_u
        for ci, c in enumerate(rep_c):
            cols[:, klvl:] = c
            out[:, ci] = _position_rows(klvl + k, dim, np.sort(cols, axis=1))
        return torch.as_tensor(out, device=device)

    return t_full.memo(("expand_positions", klvl, k), build)


def _expand(data: torch.Tensor, lvl_rank: int, k: int, dim: int) -> torch.Tensor:
    """F[u, c] = data[pos(sort(u ∪ c))], (n_lvl, n_k)."""
    if lvl_rank == 0:
        return data.reshape(1, -1)
    return data[_expand_positions(lvl_rank, k, dim, data.device)]


def _paired_gather(ka: int, kb: int, dim: int, device) -> torch.Tensor:
    """(n_sub, n_out) on the device: for each position subset S, the flat
    index pos(K_S)·N_kb + pos(K_∖S) into G of every output K. int32 while
    G has fewer than 2**31 entries (always under the default paired gate),
    so the table takes 4·n_sub·n_out bytes."""
    t_out = tables(ka + kb, dim, device)

    def build():
        n_kb = comb.indep_size(kb, dim)
        rep_T = t_out.rep_T
        idx = torch.stack([
            tables(ka, dim, device).position_T(rep_T[S]) * n_kb
            + tables(kb, dim, device).position_T(rep_T[Sc])
            for S, Sc in _subsets(ka + kb, ka)
        ])
        small = comb.indep_size(ka, dim) * n_kb < 2**31
        return idx.to(torch.int32) if small else idx

    return t_out.memo(("paired_gather", ka, kb), build)


def _paired_feasible(ra, rb, k, dim) -> bool:
    if k < 1:
        return False
    lim = _paired_limit()
    if lim <= 0:
        return False
    ka, kb = ra - k, rb - k
    n_k = comb.indep_size(k, dim)
    n_ka = comb.indep_size(ka, dim)
    n_kb = comb.indep_size(kb, dim)
    n_out = comb.indep_size(ka + kb, dim)
    return (
        n_ka * n_k <= lim
        and n_kb * n_k <= lim
        and n_ka * n_kb <= lim
        and n_out * max(1, ka + kb) <= lim
    )


def _combine_paired(af: FlatSymmetricTensor, bf: FlatSymmetricTensor, k: int):
    ra, rb, dim = af.rank, bf.rank, af.dim
    ka, kb = ra - k, rb - k
    ct = torch.result_type(af.data, bf.data)
    gam = tables(k, dim, af.device).multiplicity.to(ct)
    FA = _expand(af.data, ka, k, dim).to(ct)
    FBw = _expand(bf.data, kb, k, dim).to(ct) * gam[None, :]
    if ct.is_floating_point:
        with full_fp32_matmul():
            G = FA @ FBw.T  # (n_ka, n_kb)
    else:  # exact integer products, which CUDA matmuls do not take
        G = sum(torch.outer(FA[:, c], FBw[:, c]) for c in range(FA.shape[1]))
    Gf = G.reshape(-1)
    if ka + kb == 0:
        return Gf
    idx = _paired_gather(ka, kb, dim, af.device)
    acc = Gf[idx[0]]
    for row in idx[1:]:
        acc = acc + Gf[row]
    return acc / idx.shape[0]


# ---------------------------------------------------------------------------
# Streamed route.
# ---------------------------------------------------------------------------


def _streamed_block_elems() -> int:
    return int(os.environ.get("SYMTENSOR_STREAM_BLOCK_ELEMS", 2**22))


def _stream_pos_of_T(t_fmt, part_T, rank_part, creps_T, k, n_k):
    """Gather positions for one subset of a streamed block: part_T carries
    (rank_part − k, n_k, B) output-part components on the leading axis;
    append the contraction multiset, sort along axis 0, rank. (n_k, B)."""
    if k == 1 and rank_part >= 2:
        # one inserted element: creps are the d singletons in order, so the
        # sort-free insert ranking applies
        return t_fmt.position_insert_T(part_T[:, 0, :]).T
    full_T = torch.cat(
        [part_T, creps_T[:, :, None].expand(k, n_k, part_T.shape[2])], dim=0
    )
    full_T = torch.sort(full_T, dim=0).values
    if rank_part == 1:
        return full_T[0]
    return t_fmt.position_T(full_T)


class _Stream(NamedTuple):
    """What every block of the streamed route shares: the operands' and the
    result's tables, the contraction multisets (k, n_k) with their
    multiplicities, the position subsets and the result type."""

    ra: int
    rb: int
    k: int
    r_out: int
    n_out: int
    t_a: object
    t_b: object
    rep_T: torch.Tensor  # (r_out, n_out); (0, 1) at r_out = 0
    creps_T: torch.Tensor
    gam: torch.Tensor
    subsets: list
    dt: torch.dtype


def _stream_setup(af: FlatSymmetricTensor, bf: FlatSymmetricTensor, k: int) -> _Stream:
    ra, rb, dim = af.rank, bf.rank, af.dim
    dev = af.device
    r_out = ra + rb - 2 * k
    t_out = tables(r_out, dim, dev)
    dt = torch.result_type(af.data, bf.data)
    if k > 0:
        tk = tables(k, dim, dev)
        creps_T = tk.rep_T  # (k, n_k)
        gam = tk.multiplicity.to(dt)
    else:
        creps_T = torch.zeros((0, 1), dtype=torch.int64, device=dev)
        gam = torch.ones(1, dtype=dt, device=dev)
    return _Stream(ra, rb, k, r_out, t_out.n, tables(ra, dim, dev),
                   tables(rb, dim, dev), t_out.rep_T, creps_T, gam,
                   list(_subsets(r_out, ra - k)), dt)


def _stream_block_size(st: _Stream) -> int:
    """Outputs a block: each subset term makes sort and gather temporaries
    of shape (rank, n_k, B), under ``SYMTENSOR_STREAM_BLOCK_ELEMS``."""
    n_k = st.creps_T.shape[1]
    per_elem = max(1, n_k * (st.ra + st.rb - st.k)) * max(1, min(len(st.subsets), 4))
    return max(1, min(st.n_out, _streamed_block_elems() // per_elem))


def _stream_positions(st: _Stream, blk: torch.Tensor):
    """(pa, pb) gather positions, (n_k, Bb) each, of every subset term for
    the output multisets blk (r_out, Bb)."""
    ka, kb = st.ra - st.k, st.rb - st.k
    n_k, Bb = st.creps_T.shape[1], blk.shape[1]
    for S, Sc in st.subsets:
        ia = blk[S][:, None, :].expand(ka, n_k, Bb)
        ib = blk[Sc][:, None, :].expand(kb, n_k, Bb)
        yield (_stream_pos_of_T(st.t_a, ia, st.ra, st.creps_T, st.k, n_k),
               _stream_pos_of_T(st.t_b, ib, st.rb, st.creps_T, st.k, n_k))


def _stream_block(st: _Stream, a: torch.Tensor, b: torch.Tensor,
                  blk: torch.Tensor) -> torch.Tensor:
    """The outputs of the multisets blk (r_out, Bb) from values a and b."""
    acc = torch.zeros(blk.shape[1], dtype=st.dt, device=a.device)
    for pa, pb in _stream_positions(st, blk):
        acc += (st.gam[:, None] * (a[pa] * b[pb])).sum(0)
    return acc / len(st.subsets)


def _combine_streamed(af: FlatSymmetricTensor, bf: FlatSymmetricTensor, k: int):
    """Streamed symmetrized outer (k = 0) or tensordot: the output in
    blocks, gather positions ranked on the device per block, so no
    (n_sub·n_k·n_out) table is built and memory stays bounded.

        out[K] = (1/C(r_out, ka)) Σ_S Σ_C γ_C · A[sort(K_S∪C)]·B[sort(C∪K_∖S)]
    """
    st = _stream_setup(af, bf, k)
    B = _stream_block_size(st)
    out = torch.empty(st.n_out, dtype=st.dt, device=af.device)
    for o0 in range(0, st.n_out, B):
        # the last block is shorter
        out[o0 : o0 + B] = _stream_block(st, af.data, bf.data, st.rep_T[:, o0 : o0 + B])
    return out


def tensordot(a, b, axes=1, stream: bool = None):
    """Symmetrized tensordot: contract `axes` index pairs, then symmetrize,
    in the packed domain. `axes` may be an int or NumPy-style axis lists
    (which collapse to their count: axis identity is immaterial for
    symmetric tensors). `stream` forces (True) or forbids (False) the
    streamed route; by default the paired route runs where its tables fit,
    then the table route under the table guard, then the streamed one. Two
    decomp operands stay decomp (a full contraction gives a rank-0 flat
    tensor)."""
    k = _axes_count(axes)
    if k == 0:
        return symmetric_outer(a, b, "multiply")
    if _both_decomp(a, b):
        out = a.tensordot_decomp(b, axes=k)
        if isinstance(out, SymmetricTensor):
            return out
        return FlatSymmetricTensor._raw(0, 1, out.reshape(1))
    return _wrap_result(_tensordot_flat(a, b, k, stream), a, b)


def _axes_count(axes) -> int:
    """The number of contracted axes of an int or NumPy-style `axes`."""
    if isinstance(axes, int):
        return axes
    ax_a, ax_b = axes
    ax_a = (ax_a,) if isinstance(ax_a, int) else tuple(ax_a)
    ax_b = (ax_b,) if isinstance(ax_b, int) else tuple(ax_b)
    if len(ax_a) != len(ax_b):
        raise ValueError("axes lists must have equal length")
    return len(ax_a)


def _tensordot_flat(a, b, k: int, stream) -> FlatSymmetricTensor:
    af, bf = _as_flat_pair(a, b)
    ra, rb = af.rank, bf.rank
    if k > min(ra, rb):
        raise ValueError(f"cannot contract {k} axes between ranks {ra} and {rb}")
    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim = af.dim
    r_out = ra + rb - 2 * k

    if stream is None and _paired_feasible(ra, rb, k, dim):
        return _flat(r_out, dim, _combine_paired(af, bf, k))

    if stream is None:
        entries = (
            2 * comb.binom(r_out, ra - k) * comb.indep_size(k, dim)
            * comb.indep_size(r_out, dim)
        )
        stream = entries > config.max_table_entries
    if stream:
        return _flat(r_out, dim, _combine_streamed(af, bf, k))

    A_tab, B_tab, gam, n_sub = _tensordot_tables(ra, rb, k, dim, af.device)
    n_k = A_tab.shape[1]
    if r_out > 0 and gather_mm.usable(af.data, bf.data):
        R = n_sub * n_k
        ct = torch.result_type(af.data, bf.data)
        w = gam.to(gather_mm.acc_dtype(ct)).repeat(n_sub) / n_sub
        acc = gather_mm.gather_combine(
            af.data, bf.data, A_tab.reshape(R, -1), B_tab.reshape(R, -1),
            weights=w,
        )
    else:
        gam = gam.to(torch.result_type(af.data, bf.data))
        acc = 0
        for s in range(n_sub):
            # (n_k, n_out) gathers, weighted over the contraction multisets
            acc = acc + (gam[:, None] * (af.data[A_tab[s]] * bf.data[B_tab[s]])).sum(0)
        acc = acc / n_sub
    return _flat(r_out, dim, acc)
