"""The attention operation's share of its roofline in training: the least
time its forward and its backward need over the traced window's sequences,
titles (L = max_title_length) and abstracts (L = max_sapo_length) apart
(``harness/flops.py:mha_work``), over the device time of the mha kernels."""
from harness import flops, trace

KERNELS = ("mha_fwd", "mha_bwd")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds = trace.kernel_seconds(ctx.trace["kernels"], KERNELS)
    if seconds <= 0:
        return None
    cfg = ctx.cfg
    news = cfg["train_batch_size"] * (1 + cfg["npratio"] + cfg["his_length"]) * ctx.micro_batches
    bound = sum(flops.bound_s(*work, "bfloat16")[0]
                for L in (cfg["max_title_length"], cfg["max_sapo_length"])
                for work in flops.mha_work(cfg, news, L).values())
    return 100.0 * bound / seconds
