"""Inputs evaluated per second over the whole window: rows of every
completed batch, read back to the host."""


def read(ctx):
    return ctx.points / ctx.record.elapsed
