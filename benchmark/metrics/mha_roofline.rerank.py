"""The attention operation's share of its roofline in reranking: the least
time its forward needs over the rows the device calls of the traced window
ran, padding included (the word tower at the packed length, the news tower
at 3 + hist_max_len), over the device time of the mha forward kernel in the
traced window."""
from harness import flops, trace

KERNELS = ("mha_fwd",)


def read(ctx):
    if ctx.kind != "rerank" or ctx.trace is None or not ctx.traced_calls:
        return None
    seconds = trace.kernel_seconds(ctx.trace["kernels"], KERNELS)
    if seconds <= 0:
        return None
    rows = sum(c[1] for c in ctx.traced_calls)
    cfg = ctx.cfg
    bound = sum(flops.bound_s(*flops.mha_work(cfg, rows, L)["forward"], "bfloat16")[0]
                for L in (cfg["seq_len"], 3 + cfg["hist_max_len"]))
    return 100.0 * bound / seconds
