"""As ``group_eval_roofline``, the calls enqueued back to back."""


def read(ctx):
    return ctx.roofline_pct()
