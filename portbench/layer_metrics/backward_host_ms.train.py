"""Wall time of the batched backward on the host per training step: the
totals of the port's ``batched.backward.r<rank>`` spans
(``symtensor_tpu_torch.utils.profiling``, on only while the window is
traced) over the window's steps, in ms; ``None`` where the program records
no such span. A span lasts from its first launch to its last return, so it
holds the host's own work and also its waits on a full launch queue while
the card works through the backward."""


def read(ctx):
    from symtensor_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", {})
    ns = [row.total_ns for name, row in totals.items() if name.startswith("batched.backward.r")]
    if not ns or not ctx.calls:
        return None
    return sum(ns) / ctx.calls / 1e6
