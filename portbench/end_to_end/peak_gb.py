"""The card's peak of allocated memory over set-up and window, GB (1e9)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
