"""The flagship ``SymmetricPolynomial``, loaded from the harness's values
as a user loads a checkpoint: built on the meta device, then given the
values by ``load_state_dict(assign=True)``, so that no second copy is
made."""

from __future__ import annotations

import torch

from symtensor_tpu_torch.models import polynomial


class System:
    def __init__(self, config: dict, inputs):
        some = next(iter(inputs.values.values()))
        self.model = polynomial.SymmetricPolynomial(
            config["ranks"], config["dim"], dtype=some.dtype, device="meta")
        bias = inputs.bias
        if bias is None:
            bias = torch.zeros((), dtype=some.dtype, device=some.device)
        state = {"bias": bias,
                 **{f"terms.rank{r}": v for r, v in inputs.values.items()}}
        self.model.load_state_dict(state, assign=True)

    def batched(self, xs):
        return polynomial.apply_batched(self.model, xs)
