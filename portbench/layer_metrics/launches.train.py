"""Kernel launches that ran on the card per training step, from the traced
window: forward, backward and the optimizer's step."""


def read(ctx):
    return ctx.launches_per_call()
