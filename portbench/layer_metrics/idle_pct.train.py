"""Share of the traced window in which no operation ran on the card
(closed loop of training steps)."""


def read(ctx):
    return ctx.idle_pct()
