"""The flagship ``SymmetricPolynomial`` fitted by Adam to the harness's
targets: built on the meta device and given the drawn values by
``load_state_dict(assign=True)``, so that no second copy is made and Adam
moves the drawn tensors themselves, with the port's own optimizer
(``polynomial.adam``); a step is the port's ``polynomial.train_step``, its
loss read back as a fitting loop logs it. After the first step each
parameter's gradient is copied to the host, for the yardstick."""

from __future__ import annotations

import torch

from symtensor_tpu_torch.models import polynomial
from symtensor_tpu_torch.models.polynomial import adam  # a port without it has no result


class System:
    def __init__(self, config: dict, inputs):
        some = next(iter(inputs.values.values()))
        self.model = polynomial.SymmetricPolynomial(
            config["ranks"], config["dim"], dtype=some.dtype, device="meta")
        self.model.load_state_dict(inputs.state(), assign=True)
        self.optimizer = adam(self.model, config["lr"], betas=tuple(config["betas"]),
                              eps=config["eps"])
        self.targets = inputs.targets
        self.inputs = inputs

    def step(self, xs, rows) -> float:
        ys = self.targets[torch.as_tensor(rows, device=self.targets.device)]
        loss = polynomial.train_step(self.model, self.optimizer, xs, ys).item()
        if self.inputs.first is None:
            self.inputs.first = {
                name: p.grad.detach().reshape(-1).to("cpu", torch.float32, copy=True)
                for name, p in self.model.named_parameters()}
        return loss
