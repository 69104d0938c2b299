"""Share of the traced window in which no operation ran on the card
(single inputs enqueued back to back)."""


def read(ctx):
    return ctx.idle_pct()
