"""The share of the traced reranking window in which no kernel or copy ran
on the device: 1 - busy / window, from the profiler's trace."""


def read(ctx):
    if ctx.kind != "rerank" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
