"""The parallel layer: dp × tp sharded evaluation, sharded tensordot and
(through ``ops.basis_change.basis_change_packed(mesh=...)``) the sharded
basis change over a ``torch.distributed`` device mesh; ``launch`` starts
process worlds and ``dryrun`` drives them all (``dryrun_multichip``)."""

from .sharding import (
    make_mesh,
    tensordot_sharded,
    poly_eval_batched_sharded,
    poly_eval_batched_sharded_grouped,
    replicated,
    shard_flat,
    shard_group_views,
)

__all__ = [
    "make_mesh",
    "tensordot_sharded",
    "poly_eval_batched_sharded",
    "poly_eval_batched_sharded_grouped",
    "replicated",
    "shard_flat",
    "shard_group_views",
]
