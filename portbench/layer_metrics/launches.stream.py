"""Kernel launches that ran on the card per call, from the traced window
(calls enqueued back to back)."""


def read(ctx):
    return ctx.launches_per_call()
