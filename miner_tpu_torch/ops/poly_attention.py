"""Fused poly-attention (interest extraction), forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/poly_attention.py:poly_attention_fused``:

    proj    = tanh(emb @ W)              # (B, H, P), rounded to emb's type
    logits  = proj @ codes^T (+ bias)    # (B, K, H), fp32
    weights = softmax(mask(logits), H)   # masked slots -> mask_fill
    out     = weights^T @ emb            # (B, K, D)

The kernel is ``csrc/poly_attention_fwd.cu``; it keeps every intermediate in
shared memory. In bf16 its three products run on the tensor cores, a
cluster of four blocks per batch row (D must be a multiple of 16 and P of
8, emb, W and codes 16-byte aligned); fp32 runs on the CUDA cores, any
shape. W and codes must be in emb's type (the TPU kernel casts them to it).
The bias is the (B, H) mean over candidates, computed by the caller. A
masked slot's logit is ``mask_fill`` in place of logits + bias: ``NEG_INF``
(-1e9, masking), or the reference's legacy ``LEGACY_FILL`` (1e-30,
``--legacy_poly_mask``; ``miner_tpu/models/poly_attention.py:54-55``), under
which pads keep a weight. The JAX package sends the legacy fill down its
XLA path; here the kernel takes the fill as a launch argument.

Under autograd (grad mode on and an input requiring grad) a CUDA tensor
goes through a ``torch.autograd.Function``: the forward is the kernel, the
backward recomputes through the plain version under ``enable_grad`` and
differentiates it, as the JAX package does (``miner_tpu/ops/
poly_attention.py:109-141``: the kernel forward, the XLA reference's VJP).
It returns the bias gradient too: the category embedding trains through
it. A CPU tensor takes the plain version, differentiable as it stands.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from miner_tpu_torch.ops import common

NEG_INF = -1e9
LEGACY_FILL = 1e-30
_MAX_SMEM = 227 * 1024
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p))


def poly_attention_reference(emb: torch.Tensor, w: torch.Tensor,
                             codes: torch.Tensor, mask: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             mask_fill: float = NEG_INF) -> torch.Tensor:
    """Plain PyTorch version; emb (B, H, D), w (D, P), codes (K, P),
    mask (B, H), bias (B, H) or None -> (B, K, D)."""
    dt = emb.dtype
    proj = torch.tanh(emb.float() @ w.to(dt).float()).to(dt)
    logits = torch.einsum("bhp,kp->bkh", proj.float(), codes.to(dt).float())
    if bias is not None:
        logits = logits + bias.float()[:, None, :]
    logits = torch.where(mask.bool()[:, None, :], logits, mask_fill)
    weights = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bkh,bhd->bkd", weights.float(), emb.float()).to(dt)


def poly_attention_fused(emb: torch.Tensor, w: torch.Tensor, codes: torch.Tensor,
                         mask: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mask_fill: float = NEG_INF) -> torch.Tensor:
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
        return poly_attention_reference(emb, w, codes, mask, bias, mask_fill)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (emb, w, codes, bias)):
        return _PolyAttention.apply(emb, w, codes, mask, bias, mask_fill)
    return _launch(emb, w, codes, mask, bias, mask_fill)


@functools.lru_cache(maxsize=None)
def _smem_bytes(H: int, D: int, P: int, K: int, code: int) -> int:
    """Shared memory a block of the kernel takes at these shapes."""
    return common.kernel_function("poly_attention_fwd", "poly_attention_smem_bytes",
                                  (ctypes.c_int,) * 5, ctypes.c_longlong)(H, D, P, K, code)


def _launch(emb, w, codes, mask, bias, mask_fill) -> torch.Tensor:
    common.require_cuda(emb, "poly_attention_fused")
    B, H, D = emb.shape
    K, P = codes.shape
    dev = emb.device
    common.check_tensor("emb", emb, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("w", w, dev, (emb.dtype,))
    common.check_tensor("codes", codes, dev, (emb.dtype,))
    common.check_tensor("mask", mask, dev, (torch.int32,))
    if bias is None:
        bias = torch.zeros((B, H), dtype=torch.float32, device=dev)
    common.check_tensor("bias", bias, dev, (torch.float32,))
    code = common.DTYPE_CODES[emb.dtype]
    if emb.dtype == torch.bfloat16:  # tensor-core tiles, 16-byte copies
        if D % 16 or P % 8:
            raise ValueError(f"poly-attention in bfloat16 takes D a multiple of 16 and "
                             f"P a multiple of 8, got D = {D}, P = {P}")
        for what, t in (("emb", emb), ("w", w), ("codes", codes)):
            common.check_aligned(what, t)
    smem = _smem_bytes(H, D, P, K, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"poly-attention shapes need {smem} bytes of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    out = torch.empty((B, K, D), dtype=emb.dtype, device=dev)
    fn = common.kernel_function("poly_attention_fwd", "poly_attention_fwd",
                                _ARGTYPES)
    common.launch("poly_attention_fwd", fn, emb.data_ptr(), w.data_ptr(),
                  codes.data_ptr(), mask.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), B, H, D, P, K, code, mask_fill, dev.index,
                  common.stream_of(emb))
    poly_attention_fused.launches += 1
    return out


class _PolyAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, w, codes, mask, bias, mask_fill):
        ctx.save_for_backward(emb, w, codes, mask, bias)
        ctx.mask_fill = mask_fill
        return _launch(emb, w, codes, mask, bias, mask_fill)

    @staticmethod
    def backward(ctx, grad):
        emb, w, codes, mask, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (emb, w, codes)]
        if bias is not None:
            inputs.append(bias.detach().requires_grad_())
        with torch.enable_grad():
            out = poly_attention_reference(*inputs[:3], mask,
                                           inputs[3] if bias is not None else None,
                                           ctx.mask_fill)
        grads = torch.autograd.grad(out, inputs, grad)
        return (*grads[:3], None, grads[3] if bias is not None else None, None)


poly_attention_fused.launches = 0
