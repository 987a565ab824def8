"""The share of the device calls' wall time spent packing rows on the host:
the span around the port's ``pack_rows`` over the span around the
micro-batcher's device call (which holds it), over the window."""


def read(ctx):
    if ctx.kind != "rerank":
        return None
    call = ctx.spans.total("device_call")
    if call <= 0:
        return None
    return 100.0 * ctx.spans.total("pack_rows") / call
