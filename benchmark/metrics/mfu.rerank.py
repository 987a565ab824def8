"""The reranking step's share of the card's bf16 peak: the FLOPs of the real
candidate rows (``harness/flops.py:unbert_row_flops`` a row: word tower at
the packed length, news tower, head) over the summed wall time of the
device calls times the peak. The offered rate is fixed, so a share of the
whole window would not move with the step's speed. Only on the card: a
share of its peak means nothing of another device's time."""
from harness import flops


def read(ctx):
    if ctx.kind != "rerank" or not ctx.calls or not ctx.on_card:
        return None
    seconds = ctx.spans.total("device_call")
    if seconds <= 0:
        return None
    work = flops.unbert_row_flops(ctx.cfg) * sum(c[2] for c in ctx.calls)
    return 100.0 * work / (seconds * flops.peak_flops("bfloat16"))
