"""Plain float64 replay of a polynomial fitted by Adam on a mean squared
error: every step, from the drawn float32 coefficients.

Each step t = 1, 2, … takes a batch of B pool rows x_b with targets y*_b:

    y_b = bias + Σ_r Σ_I v_I · r!/∏c!(I) · ∏_k x_{b,I_k}     (reference/poly.py)
    loss = (1/B) Σ_b (y_b − y*_b)²,   g_b = 2 (y_b − y*_b) / B
    ∂loss/∂v_I = r!/∏c!(I) · Σ_b g_b ∏_k x_{b,I_k},   ∂loss/∂bias = Σ_b g_b

and moves every parameter p with its gradient g by Adam (Kingma and Ba,
2015, Algorithm 1, which is torch.optim.Adam's update; m and v start at 0):

    m ← β₁ m + (1 − β₁) g,   v ← β₂ v + (1 − β₂) g²
    p ← p − lr · (m / (1 − β₁ᵗ)) / (√(v / (1 − β₂ᵗ)) + eps)

A group block (P_j, T_j) of rank r ≥ 3 (``poly._Rank``: heads h ≤ j, then
j, then the tail pair a ≤ b) holds the values whose ∏x is M̃_h · x_j · x_a
x_b, with M̃ the heads' monomials over their running multiplicities and
the rest of r!/∏c! in coef = r!/(m_j m_a m_b), a whole number. With tri =
x_a x_b (B, T_j), the block adds x_bj Σ_t tri[b, t] (M̃ · (V ⊙ coef))[b, t]
to y_b, and its gradient is (M̃ᵀ · (tri ⊙ g x_j)) ⊙ coef. Ranks 1 and 2 are
one block with M̃ x_j = 1.

Departures from the published math, none of which changes a result
beyond rounding:

- Everything is float64 (TF32 off for float32 products); the published
  math names no precision.
- Adam moves each block as soon as its gradient is made, block after block
  and rank after rank, and the bias first. A step's gradient reads the
  residuals and the batch, never the coefficients, so the order changes
  nothing. No n-sized gradient is ever held: the replay keeps the float64
  coefficients and both moments (24 bytes a coefficient, 40.9 GB at ranks
  2-6, dim 100), each value's coef (int16, 2 bytes) and, per step, the head
  monomials and one block's transients.
- The update is written as torch.optim.Adam computes it, lr/(1 − β₁ᵗ) · m
  / (√v/√(1 − β₂ᵗ) + eps), which is the line above.

``precision="tf32"`` is the control: both operands of every matrix
product, the forward's and the gradient's, are rounded to TF32
(``poly.round_tf32``), as a float32 program that let the tensor cores take
its products would be.

Imports torch and NumPy only: nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import poly

PRECISIONS = ("float64", "tf32")


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Fit:
    """The float64 state of a fit: each rank's coefficients, the bias, and
    Adam's two moments of each, made from `values` (rank → packed values),
    `bias` (0-d), `pool` (rows, dim) and `targets` (rows,) on their device."""

    def __init__(self, values: dict, bias, pool, targets, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        dev, dim = pool.device, pool.shape[1]
        self.lr, self.betas, self.eps, self.precision = lr, tuple(betas), eps, precision
        self.pool = pool.to(torch.float64)
        self.targets = targets.to(torch.float64)
        self.ranks = [poly._Rank(r, dim, v.numel(), dev) for r, v in sorted(values.items())]
        self.factor = {rk.rank: _factors(rk, values[rk.rank].numel(), dev) for rk in self.ranks}
        self.coefs = {r: v.detach().to(torch.float64, copy=True) for r, v in values.items()}
        self.bias = bias.detach().to(torch.float64, copy=True).reshape(())
        self.m = {r: torch.zeros_like(p) for r, p in self.coefs.items()}
        self.v = {r: torch.zeros_like(p) for r, p in self.coefs.items()}
        self.m_bias, self.v_bias = torch.zeros_like(self.bias), torch.zeros_like(self.bias)
        self.t = 0

    def _round(self, t):
        return poly.round_tf32(t) if self.precision == "tf32" else t

    def _adam(self, p, m, v, g) -> None:
        """One Adam update of p, in place, at the step count self.t."""
        b1, b2 = self.betas
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** self.t)).add_(self.eps)
        p.addcdiv_(m, denom, value=-self.lr / (1.0 - b1 ** self.t))

    def step(self, rows, grads: dict | None = None) -> float:
        """One step at the pool rows `rows`; returns its loss, before the
        update. Where `grads` is a dict, each rank's gradient is written
        into grads[r], a flat tensor of the rank's size on any device and of
        any type (float64 on the pool's device where the dict has none), and
        the bias's is kept under "bias"."""
        idx = torch.as_tensor(np.asarray(rows), device=self.pool.device)
        X, ys = self.pool[idx], self.targets[idx]
        self.t += 1
        heads = {rk.rank: self._round(rk.head_monomials(X)) for rk in self.ranks if rk.rank >= 3}
        y = self.bias.expand(X.shape[0]).clone()
        for rk in self.ranks:
            p = self.coefs[rk.rank]
            for off, P, T, j, q, ta, tb in rk.groups:
                tri = X if tb is None else X[:, ta] * X[:, tb]
                Vc = self._round(p[off: off + P * T].view(P, T)
                                 * self.factor[rk.rank][off: off + P * T].view(P, T))
                if j is None:  # ranks 1 and 2: one row
                    y += self._round(tri) @ Vc[0]
                else:
                    y += X[:, j] * (tri * (heads[rk.rank][:, :P] @ Vc)).sum(1)
        e = y - ys
        loss = float((e * e).mean())
        g = 2.0 * e / X.shape[0]

        gb = g.sum()
        if grads is not None:
            grads["bias"] = gb.clone()
        self._adam(self.bias, self.m_bias, self.v_bias, gb)
        for rk in self.ranks:
            r = rk.rank
            if grads is not None and grads.get(r) is None:
                grads[r] = torch.empty_like(self.coefs[r])
            for off, P, T, j, q, ta, tb in rk.groups:
                tri = X if tb is None else X[:, ta] * X[:, tb]
                s = slice(off, off + P * T)
                if j is None:
                    G = (self._round(g) @ self._round(tri))[None, :]
                else:
                    G = heads[r][:, :P].T @ self._round(tri * (g * X[:, j])[:, None])
                G *= self.factor[r][s].view(P, T)
                if grads is not None:
                    grads[r][s] = G.view(-1)
                self._adam(self.coefs[r][s].view(P, T), self.m[r][s].view(P, T),
                           self.v[r][s].view(P, T), G)
                del G
            heads.pop(r, None)  # free the rank's head monomials
        return loss


def _factors(rk, n: int, device) -> torch.Tensor:
    """(n,) int16: r!/(m_j m_a m_b) of each value of the rank in storage
    order (r! for rank 1; 1 on the diagonal and 2 off it for rank 2), a
    whole number ≤ 720 for ranks up to 6."""
    out = torch.empty(n, dtype=torch.int16, device=device)
    for off, P, T, j, q, ta, tb in rk.groups:
        if rk.rank == 1:
            c = torch.full((1, T), rk.fact, dtype=torch.float64, device=device)
        elif rk.rank == 2:
            c = torch.where(ta == tb, 1.0, 2.0).to(torch.float64)[None, :]
        else:
            m_j = (q + 1.0)[:, None]
            m_a = torch.where((ta == j)[None, :], m_j + 1.0, 1.0)
            m_b = torch.where((tb == ta)[None, :], m_a + 1.0, 1.0)
            c = rk.fact / (m_j * m_a * m_b)
        out[off: off + P * T] = torch.round(c).reshape(-1).to(torch.int16)
    return out


def replay(values: dict, bias, pool, targets, steps, lr: float, betas=(0.9, 0.999),
           eps: float = 1e-8, precision: str = "float64", grads: dict | None = None,
           moved: dict | None = None) -> np.ndarray:
    """The loss of each step of `steps` (a list of pool-row arrays, in the
    order they ran), every step replayed in float64 on the pool's device
    from the drawn float32 `values`, `bias`, `pool` and `targets`. Where
    `grads` is a dict, the first step's gradients are written into it as
    ``Fit.step`` writes them; where `moved` is a dict, each rank's change
    over the replay, its coefficients less `values`, is written the same
    way into moved[r], and the bias's kept under "bias"."""
    with _no_tf32():
        fit = Fit(values, bias, pool, targets, lr, betas, eps, precision)
        losses = [fit.step(rows, grads if k == 0 else None) for k, rows in enumerate(steps)]
        if moved is not None:
            del fit.m, fit.v  # room for the differences on the card
            for r, p in fit.coefs.items():
                out = moved.get(r)
                if out is None:
                    out = moved[r] = torch.empty_like(p)
                for s in range(0, p.numel(), _CHUNK):
                    e = s + _CHUNK
                    out[s:e] = p[s:e] - values[r][s:e].to(torch.float64)
            moved["bias"] = fit.bias - bias.to(torch.float64)
        return np.asarray(losses, dtype=np.float64)


_CHUNK = 1 << 26  # values a block when the change is written out (512 MB of float64)
