"""The batched evaluation's device time against its bound: the least time
of a batch (``work.py``: 2·B·n operations at the storage type's
tensor-core peak, or the values read once, whichever is longer) over the
card's busy time per batch in the traced window (the per-group GEMMs of
the fold and the passes around them)."""


def read(ctx):
    return ctx.roofline_pct()
