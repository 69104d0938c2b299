from . import combinatorics
from . import tables
from .combinatorics import (
    INDEX_LETTERS,
    binom,
    class_counts,
    class_label,
    class_multiplicity,
    class_of_index,
    class_representative,
    class_size,
    colex_rank,
    colex_unrank,
    distinct_permutations,
    gflat_layout,
    indep_size,
    multinom,
    multiset_count,
    perm_classes,
)
from .tables import Tables
from .tables import tables as get_tables

__all__ = [
    "INDEX_LETTERS",
    "binom",
    "class_counts",
    "class_label",
    "class_multiplicity",
    "class_of_index",
    "class_representative",
    "class_size",
    "colex_rank",
    "colex_unrank",
    "combinatorics",
    "distinct_permutations",
    "gflat_layout",
    "indep_size",
    "multinom",
    "multiset_count",
    "perm_classes",
    "Tables",
    "tables",
    "get_tables",
]
