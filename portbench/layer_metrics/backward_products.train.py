"""The coefficients' gradient products the batched backward ran per
training step: the port's counter ``batched_backward.products`` (one per
group of each rank ≥ 3, ``symtensor_tpu_torch.kernels.poly_eval``) over
every step of the process, warm-up and window; ``None`` where the program
has no such counter."""


def read(ctx):
    from symtensor_tpu_torch.kernels import poly_eval

    products = getattr(getattr(poly_eval, "batched_backward", None), "products", None)
    steps = ctx.calls + (sum(ctx.record.warmup.calls) if ctx.record.warmup else 0)
    if products is None or not steps:
        return None
    return products / steps
