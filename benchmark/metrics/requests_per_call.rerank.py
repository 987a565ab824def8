"""Requests a device call of the micro-batcher coalesced over the window:
the difference of its own counters (``MicroBatcher.requests`` /
``device_batches``) across the window."""


def read(ctx):
    if ctx.kind != "rerank" or not ctx.device_calls:
        return None
    return ctx.requests / ctx.device_calls
