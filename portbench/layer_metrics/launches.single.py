"""Kernel launches that ran on the card per call, from the traced window
(closed loop)."""


def read(ctx):
    return ctx.launches_per_call()
