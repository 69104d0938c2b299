"""A ``SymmetricPolynomial`` of the drawn coefficients, fitted to the drawn
targets by ``torch.optim.SGD`` through the port's ``train_step``."""

import torch

from symtensor_tpu_torch.models import polynomial


class System:
    def __init__(self, config: dict, inputs):
        self.model = polynomial.SymmetricPolynomial(
            config["degrees"], config["dim"], dtype=inputs.bias.dtype,
            device=inputs.bias.device)
        self.model.load_state_dict(
            {"bias": inputs.bias,
             **{f"terms.rank{r}": v for r, v in inputs.values.items()}})
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=config["lr"])
        self.targets = inputs.targets

    def step(self, xs, rows) -> float:
        ys = self.targets[torch.as_tensor(rows, device=self.targets.device)]
        return polynomial.train_step(self.model, self.optimizer, xs, ys).item()
