"""Host time of the batched fold per batch: the totals of the port's
``batched.fold.r<rank>`` spans (``symtensor_tpu_torch.utils.profiling``,
on only while the window is traced) over the window's batches, in ms;
``None`` where the program records no such span."""


def read(ctx):
    from symtensor_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", {})
    ns = [row.total_ns for name, row in totals.items() if name.startswith("batched.fold.r")]
    if not ns or not ctx.calls:
        return None
    return sum(ns) / ctx.calls / 1e6
