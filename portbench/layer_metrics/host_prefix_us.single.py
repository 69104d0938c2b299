"""Host time of the port's single-input evaluation per call: the total of
its ``eval.single`` span (``symtensor_tpu_torch.utils.profiling``, on only
while the window is traced) over the window's calls, in µs; ``None`` where
the program records no such span."""


def read(ctx):
    from symtensor_tpu_torch.utils import profiling

    row = getattr(profiling, "span_totals", {}).get("eval.single")
    if row is None or not ctx.calls:
        return None
    return row.total_ns / ctx.calls / 1e3
