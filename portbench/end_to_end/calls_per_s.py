"""Calls completed per second over the whole window, every call's result
read back to the host."""


def read(ctx):
    return ctx.calls / ctx.record.elapsed
