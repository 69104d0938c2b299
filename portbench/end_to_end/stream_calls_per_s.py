"""Calls completed per second over the whole window, the calls enqueued
back to back and their results read back to the host a chunk at a time."""


def read(ctx):
    return ctx.calls / ctx.record.elapsed
