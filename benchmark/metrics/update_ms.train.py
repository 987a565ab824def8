"""Device milliseconds of one optimizer update (the clip's norms and
scaling, AdamW, the zero gradients of unreached leaves): the device time
of the kernels enqueued between the marks around ``Optimizer.step``
(``harness/trace.py:mark``) over the traced window, over the updates that
fell in it."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace.get("marked") is None:
        return None
    updates = sum(ctx.updated)
    if not updates or len(ctx.trace["marked"]) != ctx.micro_batches:
        return None
    return 1e3 * sum(ctx.trace["marked"]) / updates
