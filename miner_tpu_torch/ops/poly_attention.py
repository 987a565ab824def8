"""Fused poly-attention (interest extraction), forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/poly_attention.py:poly_attention_fused``:

    proj    = tanh(emb @ W)              # (B, H, P), rounded to emb's type
    logits  = proj @ codes^T (+ bias)    # (B, K, H), fp32
    weights = softmax(mask(logits), H)   # masked slots -> -1e9
    out     = weights^T @ emb            # (B, K, D)

The kernel is ``csrc/poly_attention_fwd.cu``; it keeps every intermediate in
shared memory. W and codes must be in emb's type (the TPU kernel casts them
to it). The bias is the (B, H) mean over candidates, computed by the caller.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from miner_tpu_torch.ops import common

NEG_INF = -1e9
_MAX_SMEM = 227 * 1024
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def poly_attention_reference(emb: torch.Tensor, w: torch.Tensor,
                             codes: torch.Tensor, mask: torch.Tensor,
                             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version; emb (B, H, D), w (D, P), codes (K, P),
    mask (B, H), bias (B, H) or None -> (B, K, D)."""
    dt = emb.dtype
    proj = torch.tanh(emb.float() @ w.to(dt).float()).to(dt)
    logits = torch.einsum("bhp,kp->bkh", proj.float(), codes.to(dt).float())
    if bias is not None:
        logits = logits + bias.float()[:, None, :]
    logits = torch.where(mask.bool()[:, None, :], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bkh,bhd->bkd", weights.float(), emb.float()).to(dt)


def poly_attention_fused(emb: torch.Tensor, w: torch.Tensor, codes: torch.Tensor,
                         mask: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K, D) interests. A CPU tensor takes
    :func:`poly_attention_reference`; a CUDA tensor launches the kernel
    (emb, w, codes of one type, float32 or bfloat16; mask int32; bias
    float32) or raises."""
    if emb.dim() != 3 or w.dim() != 2 or codes.dim() != 2:
        raise ValueError("emb must be (B, H, D), w (D, P), codes (K, P)")
    B, H, D = emb.shape
    K, P = codes.shape
    if tuple(w.shape) != (D, P) or tuple(mask.shape) != (B, H):
        raise ValueError(f"shapes emb {tuple(emb.shape)}, w {tuple(w.shape)}, "
                         f"codes {tuple(codes.shape)}, mask {tuple(mask.shape)} "
                         "do not agree")
    if bias is not None and tuple(bias.shape) != (B, H):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected {(B, H)}")
    if emb.device.type == "cpu":
        return poly_attention_reference(emb, w, codes, mask, bias)
    common.require_cuda(emb, "poly_attention_fused")
    dev = emb.device
    common.check_tensor("emb", emb, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("w", w, dev, (emb.dtype,))
    common.check_tensor("codes", codes, dev, (emb.dtype,))
    common.check_tensor("mask", mask, dev, (torch.int32,))
    if bias is None:
        bias = torch.zeros((B, H), dtype=torch.float32, device=dev)
    common.check_tensor("bias", bias, dev, (torch.float32,))
    smem = 4 * (H * D + H * P + K * (P + 1) + H * K)
    if smem > _MAX_SMEM:
        raise ValueError(f"poly-attention shapes need {smem} bytes of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    out = torch.empty((B, K, D), dtype=emb.dtype, device=dev)
    fn = common.kernel_function("poly_attention_fwd", "poly_attention_fwd",
                                _ARGTYPES)
    common.launch("poly_attention_fwd", fn, emb.data_ptr(), w.data_ptr(),
                  codes.data_ptr(), mask.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), B, H, D, P, K, common.DTYPE_CODES[emb.dtype],
                  dev.index, common.stream_of(emb))
    poly_attention_fused.launches += 1
    return out


poly_attention_fused.launches = 0
