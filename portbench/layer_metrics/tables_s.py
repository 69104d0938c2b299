"""Host time the process spent building the port's static tables, set-up
included: the self times of its ``tables.<key>`` spans
(``symtensor_tpu_torch.utils.profiling``, timed whether or not a profiler
records), in s; ``None`` where the program records no such span."""


def read(ctx):
    from symtensor_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", {})
    ns = [row.self_ns for name, row in totals.items() if name.startswith("tables.")]
    return sum(ns) / 1e9 if ns else None
