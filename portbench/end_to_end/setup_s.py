"""Seconds from the process's start to the window's: imports, the CUDA
context, inputs drawn on the card, the port's tables and warm-up calls (and
in a checkout's first run, the build of its CUDA library)."""


def read(ctx):
    return ctx.setup_s
