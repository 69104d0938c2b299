"""Plain float64 polynomial evaluation over packed symmetric values.

    y(x) = bias + Σ_r Σ_{i1…ir} A^(r)_{i1…ir} x_{i1}…x_{ir}
         = bias + Σ_r Σ_{I sorted} v_I · r!/∏_u c_u(I)! · ∏_k x_{I_k}

over the independent components I = (i1 ≤ … ≤ ir) of each rank, which
the packed (gflat) format stores in this order: rank 1 by index; rank 2
as the row-major upper triangle (a ≤ b); rank r ≥ 3 in groups j = 0…d−1
(j the third-largest index), each a row-major (P_j, T_j) block whose rows
are the heads (i1 … i_{r−3}) ≤ j in colexicographic order and whose
columns are the tails (a, b), j ≤ a ≤ b, as for rank 2. Every component
is visited once, at its position; ``_Rank`` checks that the groups cover
the stored values exactly.

The factor r!/∏c_u! of a sorted tuple is r!/∏_k m_k with m_k its running
multiplicity (m_k = m_{k−1} + 1 where i_k = i_{k−1}, else 1). For a group
block that is x_j/(q+1) · x_a/m_a · x_b/m_b times the head's own product,
q the count of j in the head; the x-free part folds into the block, so
each group is one float64 GEMM over a block of inputs.

Besides y, ``evaluate`` returns the root sum of squares of the terms
(every v_I·r!/∏c!·∏x, and the bias): rounding errors of a sum grow like
it, so an error divided by it reads alike at any size.

Imports torch and NumPy only: nothing of the program under test.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache

import numpy as np
import torch

PRECISIONS = ("float64", "tf32", "fp8")
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@lru_cache(maxsize=None)
def colex_multisets(dim: int, size: int) -> np.ndarray:
    """All ascending `size`-tuples over range(dim), in colex order (by the
    last entry, then the one before, ...); shape (N, size)."""
    if size == 0:
        return np.zeros((1, 0), dtype=np.int64)  # the empty multiset
    rows = np.array(list(itertools.combinations_with_replacement(range(dim), size)),
                    dtype=np.int64)
    return rows[np.lexsort(rows.T)]


def running_multiplicity(rows: np.ndarray) -> np.ndarray:
    """m[:, k] = 1 + m[:, k−1] where rows[:, k] == rows[:, k−1], else 1."""
    m = np.ones_like(rows)
    for k in range(1, rows.shape[1]):
        m[:, k] = np.where(rows[:, k] == rows[:, k - 1], m[:, k - 1] + 1, 1)
    return m


def tails(dim: int, lo: int) -> tuple:
    """(a, b) with lo ≤ a ≤ b < dim, row-major."""
    a, b = np.triu_indices(dim - lo)
    return a + lo, b + lo


def storage_order(rank: int, dim: int) -> np.ndarray:
    """The sorted index tuples of the packed values, in storage order;
    shape (C(dim+rank−1, rank), rank). The evaluation walks the same order
    group by group without building this."""
    if rank == 0:
        return np.zeros((1, 0), dtype=np.int64)
    if rank == 1:
        return np.arange(dim, dtype=np.int64)[:, None]
    if rank == 2:
        return np.stack(tails(dim, 0), axis=1)
    heads, out = colex_multisets(dim, rank - 3), []
    for j in range(dim):
        h = heads[heads.max(axis=1, initial=-1) <= j] if rank > 3 else heads
        a, b = tails(dim, j)
        P, T = len(h), len(a)
        out.append(np.concatenate([np.repeat(h, T, axis=0), np.full((P * T, 1), j),
                                   np.tile(np.stack([a, b], axis=1), (P, 1))], axis=1))
    return np.concatenate(out)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 stored mantissa bits, to nearest even), as
    float64: what a TF32 tensor core reads of a float32 operand."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(torch.float64)


def quantize_fp8(v: torch.Tensor, amax: float) -> torch.Tensor:
    """v through float8_e4m3fn with one scale per tensor, as float64."""
    s = amax / FP8_MAX if amax > 0 else 1.0
    return (v.to(torch.float64) / s).to(torch.float8_e4m3fn).to(torch.float64) * s


class _Rank:
    """The enumeration of one rank's packed values, on `device`."""

    def __init__(self, rank: int, dim: int, n: int, device):
        self.rank, self.dim = rank, dim
        self.fact = float(math.factorial(rank))
        self.groups = []  # (offset, P, T, j or None, q, ta, tb)
        if rank <= 2:
            a, b = tails(dim, 0) if rank == 2 else (np.arange(dim), None)
            self.groups.append((0, 1, len(a), None, None,
                                torch.as_tensor(a, device=device),
                                None if b is None else torch.as_tensor(b, device=device)))
            size = len(a) if rank else 1
        else:
            heads = colex_multisets(dim, rank - 3)
            self.heads = torch.as_tensor(heads, device=device)
            self.head_m = torch.as_tensor(running_multiplicity(heads), device=device,
                                          dtype=torch.float64)
            off = 0
            for j in range(dim):
                P = int((heads.max(axis=1, initial=-1) <= j).sum()) if rank > 3 else 1
                q = (self.heads[:P] == j).sum(1).to(torch.float64) if rank > 3 else \
                    torch.zeros(1, dtype=torch.float64, device=device)
                a, b = tails(dim, j)
                self.groups.append((off, P, len(a), j, q,
                                    torch.as_tensor(a, device=device),
                                    torch.as_tensor(b, device=device)))
                off += P * len(a)
            size = off
        if size != n:
            raise ValueError(f"rank {rank} dim {dim}: the groups cover {size} "
                             f"values, the tensor holds {n}")

    def head_monomials(self, X: torch.Tensor) -> torch.Tensor:
        """(rows, N_heads): ∏_k x_{h_k}/m_k of each head."""
        M = torch.ones((X.shape[0], self.heads.shape[0]), dtype=X.dtype, device=X.device)
        for k in range(self.heads.shape[1]):
            M *= X[:, self.heads[:, k]] / self.head_m[:, k]
        return M

    def add(self, v: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
            sq: torch.Tensor, precision: str, amax: float) -> None:
        """y += Σ_I v_I·coef_I·∏x and sq += Σ_I (v_I·coef_I·∏x)² over the
        rows of X (float64)."""
        r = self.rank
        if r == 0:
            y += v[0].double()
            sq += v[0].double() ** 2
            return
        M = self.head_monomials(X) if r >= 3 else None
        for off, P, T, j, q, ta, tb in self.groups:
            V = v[off: off + P * T].view(P, T)
            if r == 1:
                coef, tri = self.fact, X
            elif r == 2:
                coef = torch.where(ta == tb, 1.0, 2.0).to(torch.float64)[None, :]
                tri = X[:, ta] * X[:, tb]
            else:
                m_j = (q + 1.0)[:, None]
                m_a = torch.where((ta == j)[None, :], m_j + 1.0, 1.0)
                m_b = torch.where((tb == ta)[None, :], m_a + 1.0, 1.0)
                coef = self.fact / (m_j * m_a * m_b)
                tri = X[:, ta] * X[:, tb]
            Vc = V.to(torch.float64) * coef
            S2 = (tri * tri) @ (Vc * Vc).T  # the scale, always exact
            if precision == "fp8":
                Vc = quantize_fp8(V, amax) * coef
            elif precision == "tf32":
                Vc, tri = round_tf32(Vc), round_tf32(tri)
            S = tri @ Vc.T  # (rows, P)
            if r >= 3:
                Mj = M[:, :P]
                y += X[:, j] * (Mj * S).sum(1)
                sq += X[:, j] ** 2 * (Mj * Mj * S2).sum(1)
            else:
                y += S[:, 0]
                sq += S2[:, 0]


def evaluate(values: dict, bias, xs: torch.Tensor, precision: str = "float64",
             block_rows: int = 1024) -> tuple:
    """(y, rss): the polynomial at each row of xs (B, dim), float64, and the
    root sum of squares of its terms. `values` maps rank to the packed
    values, `bias` is a 0-d tensor or None. `precision` "float64" is the
    reference; "tf32" rounds both operands of each group's product to TF32
    and "fp8" the values to float8_e4m3fn (a scale per rank), the controls
    that must fail the comparison."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dev, dim = xs.device, xs.shape[1]
    ranks = [(_Rank(r, dim, v.numel(), dev), v,
              max(-float(v.min()), float(v.max())) if precision == "fp8" else 0.0)
             for r, v in sorted(values.items())]
    X64 = xs.to(torch.float64)
    y = torch.zeros(xs.shape[0], dtype=torch.float64, device=dev)
    sq = torch.zeros_like(y)
    for s in range(0, xs.shape[0], block_rows):
        X = X64[s: s + block_rows]
        yb, sqb = y[s: s + block_rows], sq[s: s + block_rows]
        for rk, v, amax in ranks:
            rk.add(v, X, yb, sqb, precision, amax)
    if bias is not None:
        y += bias.double()
        sq += bias.double() ** 2
    return y, sq.sqrt()
