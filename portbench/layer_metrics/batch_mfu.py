"""The whole batched call's share of the card's peak: the least time of a
batch (``work.py``, ``peaks.py``) over the traced window's wall time per
batch, host work and idle card included."""


def read(ctx):
    return ctx.mfu_pct()
