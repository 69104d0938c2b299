"""The single-input op's device time against its bound: the least time of
a call (``work.py``: values, x and the result once, at ``peaks.py``'s
rates) over the card's busy time per call in the traced window, every
operation the call launches included (the group-pass kernel's evaluation
mode takes most of it); closed loop."""


def read(ctx):
    return ctx.roofline_pct()
