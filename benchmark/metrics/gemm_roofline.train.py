"""The products' share of their roofline in training: the least time the
news encoder's products need at the configuration's flags, recompute
included (``harness/flops.py:miner_products``), over the device time of the
product kernels in the traced window."""
from harness import flops, trace

# cuBLAS's and CUTLASS's product kernels, by name; the port's own kernels
# are left out
KERNELS = ("nvjet", "gemm", "cutlass", "xmma", "cublas")
EXCLUDE = ("mha_", "add_ln", "poly_attention", "lookup_score", "fastformer_attn")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds = trace.kernel_seconds(ctx.trace["kernels"], KERNELS, EXCLUDE)
    if seconds <= 0:
        return None
    ops, nbytes = flops.miner_products(ctx.cfg)
    bound, _ = flops.bound_s(ops * ctx.micro_batches, nbytes * ctx.micro_batches, "bfloat16")
    return 100.0 * bound / seconds
