"""The port's kernels, each beside its plain PyTorch version.

Every wrapper keeps a plain integer ``launches`` that grows by one each time
it launches its kernel (never for the plain version), so a run can show
that its main path went through the kernels.
"""
from typing import Dict

from miner_tpu_torch.ops.add_ln import add_ln_backward, fused_dropout_add_ln
from miner_tpu_torch.ops.fastformer_attn import fastformer_attention_fused
from miner_tpu_torch.ops.lookup_score import lookup_score_fused
from miner_tpu_torch.ops.mha import fused_mha, mha_backward
from miner_tpu_torch.ops.poly_attention import poly_attention_fused

KERNEL_WRAPPERS = {
    "mha_fwd": fused_mha,
    "mha_bwd": mha_backward,
    "add_ln_fwd": fused_dropout_add_ln,
    "add_ln_bwd": add_ln_backward,
    "poly_attention_fwd": poly_attention_fused,
    "lookup_score_fwd": lookup_score_fused,
    "fastformer_attn_fwd": fastformer_attention_fused,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
