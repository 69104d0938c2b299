"""Testing helpers, the counterpart of ``symtensor_tpu/testing/utils.py``."""

from __future__ import annotations

import contextlib
import re
import warnings

import numpy as np
import torch


@contextlib.contextmanager
def does_not_warn(category=Warning, match=None):
    """Inverse of ``pytest.warns``: fail if a matching warning is emitted.
    With `match`, only warnings whose message matches the regex count
    (``re.search``, as ``pytest.warns(match=...)``)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        yield
    bad = [
        w
        for w in rec
        if issubclass(w.category, category)
        and (match is None or re.search(match, str(w.message)))
    ]
    if bad:
        raise AssertionError(
            f"unexpected warning(s): {[str(w.message) for w in bad]}"
        )


def random_symmetric(rank: int, dim: int, rng=None, dtype=np.float64):
    """Random dense symmetric NumPy array (the oracle side), symmetrized
    on the CPU by the port's ``symmetrize``."""
    from ..ops.symmetrize import symmetrize

    rng = rng or np.random.default_rng(0)
    if rank == 0:
        return np.asarray(rng.normal(), dtype=dtype)
    a = torch.from_numpy(rng.normal(size=(dim,) * rank).astype(dtype))
    return symmetrize(a).numpy()
