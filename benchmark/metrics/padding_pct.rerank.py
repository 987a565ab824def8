"""The share of the rows the reranker ran that were padding: over every
device call of the window, 1 - (the requests' candidates) / (B_pad x C_pad),
counted at the benchmark's span around the micro-batcher's device call."""


def read(ctx):
    if ctx.kind != "rerank" or not ctx.calls:
        return None
    run = sum(c[1] for c in ctx.calls)
    real = sum(c[2] for c in ctx.calls)
    return 100.0 * (1.0 - real / run)
