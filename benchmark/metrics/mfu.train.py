"""The training step's share of the card's bf16 peak: the model FLOPs of the
traced window's micro-batches (forward and twice it backward, no recompute:
``harness/flops.py:miner_micro_batch_flops``) over the traced window's
length times the peak (``peaks.json``)."""
from harness import flops


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    work = flops.miner_micro_batch_flops(ctx.cfg) * ctx.micro_batches
    return 100.0 * work / (ctx.trace["window_s"] * flops.peak_flops("bfloat16"))
