"""A packed symmetric tensor of one rank: the public contraction of a
``FlatSymmetricTensor`` made from the harness's values, with no copy, at
one input."""

from __future__ import annotations

import symtensor_tpu_torch as stt


class System:
    def __init__(self, config: dict, inputs):
        (rank, vals), = inputs.values.items()
        self.A = stt.FlatSymmetricTensor(rank, config["dim"], data=vals)

    def single(self, x):
        return stt.symalg.contract_all_indices_with_vector(self.A, x)
