"""Fused multi-head self-attention, forward: CUDA kernel + plain version.

Counterpart of ``miner_tpu/ops/mha.py:fused_mha``. Per head,
softmax(QK^T/sqrt(Dh), masked keys filled with -1e9)·V, read straight from the
fused QKV projection (N, L, 3D), with fp32 logits. ``seqs > 1`` treats each
row as that many packed sub-sequences of length L/seqs that attend only
within themselves (block-diagonal), which keeps ``fused_mha``'s meaning; the
port's PLM calls it with ``seqs=1``, since the 128-row packing of short
fields was TPU layout work.

The kernel is ``csrc/mha_fwd.cu``. The softmax probabilities stay fp32 into
the PV product (the TPU kernel rounds them to the input type first); in
fp32 the two agree to rounding. Dropout is not ported yet: a rate above 0
raises, and the Philox dropout comes with the backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from miner_tpu_torch.ops import common

NEG_INF = -1e9
_HEAD_DIMS = (16, 32, 64)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def mha_reference(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  seqs: int = 1) -> torch.Tensor:
    """Plain PyTorch version. qkv (N, L, 3D), mask (N, L) -> (N, L, D)."""
    N, L, D3 = qkv.shape
    D = D3 // 3
    Dh = D // num_heads
    f = qkv.float()
    q = f[..., :D].reshape(N, L, num_heads, Dh)
    k = f[..., D:2 * D].reshape(N, L, num_heads, Dh)
    v = f[..., 2 * D:].reshape(N, L, num_heads, Dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / Dh ** 0.5)
    valid = mask.bool()[:, None, None, :]
    if seqs > 1:
        seg = torch.arange(L, device=qkv.device) // (L // seqs)
        valid = valid & (seg[:, None] == seg[None, :])
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(N, L, D).to(qkv.dtype)


def fused_mha(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
              dropout_rate: float = 0.0, seqs: int = 1) -> torch.Tensor:
    """Attention context (N, L, D) from qkv (N, L, 3D) and mask (N, L).

    A CPU tensor takes :func:`mha_reference`; a CUDA tensor launches the
    kernel (qkv float32 or bfloat16, mask int32, head dim 16, 32 or 64) or
    raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet: it comes with the backward "
            "kernel in the training slice (ROADMAP Queue 1, item 1)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (N, L, 3D), got {tuple(qkv.shape)}")
    N, L, D3 = qkv.shape
    D = D3 // 3
    if D % num_heads:
        raise ValueError(f"hidden size {D} is not divisible by {num_heads} heads")
    if seqs < 1 or L % seqs:
        raise ValueError(f"L={L} is not divisible by seqs={seqs}")
    if tuple(mask.shape) != (N, L):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected {(N, L)}")
    if qkv.device.type == "cpu":
        return mha_reference(qkv, mask, num_heads, seqs)
    common.require_cuda(qkv, "fused_mha")
    Dh = D // num_heads
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not supported by the kernel {_HEAD_DIMS}")
    common.check_tensor("qkv", qkv, qkv.device, tuple(common.DTYPE_CODES))
    common.check_tensor("mask", mask, qkv.device, (torch.int32,))
    out = torch.empty((N, L, D), dtype=qkv.dtype, device=qkv.device)
    fn = common.kernel_function("mha_fwd", "mha_fwd", _ARGTYPES)
    common.launch("mha_fwd", fn, qkv.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), N, L, num_heads, Dh, seqs,
                  common.DTYPE_CODES[qkv.dtype], qkv.device.index,
                  common.stream_of(qkv))
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
