"""Kernel launches that ran on the card per batch, from the traced window."""


def read(ctx):
    return ctx.launches_per_call()
