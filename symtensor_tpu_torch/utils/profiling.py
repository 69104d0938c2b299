"""Counters of slow-path dispatch.

The counterpart of ``symtensor_tpu/utils/profiling.py:25-47``: every op
that leaves a compressed format for a slower one calls
``count_fallback(site)``, which counts the site in ``op_counters`` and
warns once per site while ``config.warn_on_densify`` is set. The JAX
module's ``timeit`` and ``trace`` wrap jax's own timers and have no
counterpart here.
"""

from __future__ import annotations

import collections
import warnings

from ..config import config

op_counters = collections.Counter()
_warned_sites = set()


def count_fallback(site: str, detail: str = "") -> None:
    """Record (and optionally warn about) a slow-path dispatch."""
    op_counters[site] += 1
    if config.warn_on_densify and site not in _warned_sites:
        _warned_sites.add(site)
        warnings.warn(
            f"symtensor_tpu_torch slow path '{site}' {detail} — performance "
            "warning emitted once per site; see utils.profiling.op_counters",
            stacklevel=3,
        )


def reset_counters() -> None:
    op_counters.clear()
    _warned_sites.clear()
