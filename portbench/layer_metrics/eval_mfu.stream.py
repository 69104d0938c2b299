"""As ``eval_mfu``, the calls enqueued back to back."""


def read(ctx):
    return ctx.mfu_pct()
