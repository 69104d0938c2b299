"""SymmetricPolynomial — the flagship model.

The counterpart of ``symtensor_tpu/models/polynomial.py``: a polynomial
with one packed symmetric coefficient tensor per rank,

    y(x) = c₀ + Σ_{r ∈ ranks} ⟨A_r, x^{⊗r}⟩,

as an ``nn.Module``. ``bias`` and one packed-values ``nn.Parameter`` per
rank (``terms["rank{r}"]``, C(d+r−1, r) values in gflat order) are its
parameters; ``forward`` wraps each as a ``FlatSymmetricTensor`` without a
copy and calls the public contractions, so a single input goes through the
group-pass kernel on the card and a batch through the per-group GEMMs,
both with their own backward (``kernels/poly_eval.py``). A
``torch.optim`` optimizer takes the place of optax (``train_step``; ``adam``
builds the one the port fits with), and a
checkpoint is ``torch.save`` of the ``state_dict``. The JAX package's
weights cross over with ``interop.polynomial_from_numpy`` and
``polynomial_to_numpy``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.base import default_device, default_dtype
from ..core.flat import FlatSymmetricTensor
from ..ops.contract import (
    contract_all_indices_with_vector,
    contract_all_indices_with_vector_batched,
)
from ..utils import combinatorics as comb
from ..utils.profiling import span


class SymmetricPolynomial(nn.Module):
    """y(x) = bias + Σ_r ⟨A_r, x^{⊗r}⟩ over packed coefficient tensors,
    zero-initialised, of `dtype` (``config.default_dtype`` by default) on
    `device` (``config.default_device`` by default)."""

    def __init__(self, ranks: Sequence[int], dim: int, *, dtype=None, device=None):
        super().__init__()
        self.dim = int(dim)
        kw = {"dtype": dtype or default_dtype(),
              "device": default_device() if device is None else torch.device(device)}
        self.bias = nn.Parameter(torch.zeros((), **kw))
        self.terms = nn.ParameterDict({
            f"rank{r}": nn.Parameter(torch.zeros(comb.indep_size(r, dim), **kw))
            for r in ranks
        })

    @property
    def ranks(self):
        return tuple(int(k[4:]) for k in self.terms)

    def tensors(self):
        """{name: FlatSymmetricTensor} views of the coefficient tensors
        (sharing the parameters' storage)."""
        return {k: FlatSymmetricTensor._raw(int(k[4:]), self.dim, p)
                for k, p in self.terms.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (dim,) → 0-d, or xs (B, dim) → (B,); the span
        ``model.forward``."""
        op = (contract_all_indices_with_vector if x.ndim == 1
              else contract_all_indices_with_vector_batched)
        with span("model.forward"):
            out = self.bias
            for t in self.tensors().values():
                out = out + op(t, x)
            return out


def init(
    ranks: Sequence[int],
    dim: int,
    *,
    generator: torch.Generator,
    scale: float = 1e-2,
    dtype=None,
    device=None,
) -> SymmetricPolynomial:
    """A ``SymmetricPolynomial`` with N(0, scale²) coefficients drawn from
    `generator` and a zero bias; `dtype` and `device` default as in the
    class. The generator must live on the model's device."""
    model = SymmetricPolynomial(ranks, dim, dtype=dtype, device=device)
    dev, gdev = model.bias.device, generator.device
    if gdev.type == "cuda" and gdev.index is None:
        gdev = torch.device("cuda", torch.cuda.current_device())
    if gdev != dev:
        raise ValueError(
            f"generator on {gdev} and the model on {dev}: draw the "
            f"coefficients with a torch.Generator(device={str(dev)!r})")
    with torch.no_grad():
        for p in model.terms.values():
            p.normal_(0.0, scale, generator=generator)
    return model


def apply(model: SymmetricPolynomial, x) -> torch.Tensor:
    """The polynomial at one input x (dim,) → 0-d, or at a batch xs
    (B, dim) → (B,)."""
    return model(torch.as_tensor(x, device=model.bias.device))


# The JAX package's name for the batched call; ``forward`` picks the route
# from the input's shape.
apply_batched = apply


def loss_fn(model: SymmetricPolynomial, xs, ys) -> torch.Tensor:
    """Mean squared error over a batch."""
    ys = torch.as_tensor(ys, device=model.bias.device)
    return torch.mean((apply_batched(model, xs) - ys) ** 2)


def adam(model: SymmetricPolynomial, lr: float, *, betas=(0.9, 0.999),
         eps: float = 1e-8) -> torch.optim.Optimizer:
    """The optimizer that fits `model` by Adam: today
    ``torch.optim.Adam(model.parameters(), lr=lr, betas=betas, eps=eps)``
    with torch's other defaults (the multi-tensor ``foreach`` step on CUDA).
    Whatever computes it must keep that update: with t the step, m and v
    the moving averages of the gradient g and of g² (zero before the first
    step), p ← p − lr·(m / (1 − β₁ᵗ)) / (√(v / (1 − β₂ᵗ)) + eps), eps added
    after the square root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=betas, eps=eps)


def train_step(model: SymmetricPolynomial, optimizer: torch.optim.Optimizer,
               xs, ys) -> torch.Tensor:
    """One optimizer step on the batch; returns the loss before the step
    (detached). The spans ``train.loss`` (forward and loss),
    ``train.backward`` and ``train.optimizer`` (the step) mark its phases."""
    optimizer.zero_grad(set_to_none=True)
    with span("train.loss"):
        loss = loss_fn(model, xs, ys)
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        optimizer.step()
    return loss.detach()
