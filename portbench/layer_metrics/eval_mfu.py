"""The whole single-input call's share of the card's peak: the least time
of a call (``work.py``, ``peaks.py``) over the traced window's wall time
per call, host work and idle card included; closed loop."""


def read(ctx):
    return ctx.mfu_pct()
