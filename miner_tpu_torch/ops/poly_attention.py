"""Fused poly-attention (interest extraction), forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/poly_attention.py:poly_attention_fused``:

    proj    = tanh(emb @ W)              # (B, H, P), rounded to emb's type
    logits  = proj @ codes^T (+ bias)    # (B, K, H), fp32
    weights = softmax(mask(logits), H)   # masked slots -> mask_fill
    out     = weights^T @ emb            # (B, K, D)

The kernel is ``csrc/poly_attention_fwd.cu``; it keeps every intermediate in
shared memory and spreads a batch row over a cluster of CTAs (:func:`plan`),
its three products on the tensor cores. In bf16 the cluster is four CTAs,
or eight with D split across them where emb whole does not fit (D = 768,
a Miner without --apply_reduce_dim: the partial proj summed over the
cluster in rank order before tanh); D must be a multiple of 16 and P of 8,
emb, W and codes 16-byte aligned.
In fp32 the products run in split TF32 (three TF32 passes a product, about
fp32's accuracy) on three CTAs a row, eight where a CTA's third of W does
not fit in shared memory, and eight with D split across them where emb
whole does not fit (D = 768); the shapes alone choose, never the batch.
Any D and P, any alignment (4-byte copies off a 16-byte boundary). A
shape whose CTA does not fit is refused. W and codes must be in emb's type
(the TPU kernel casts them to it). The bias is the (B, H) mean over
candidates, computed by the caller. A masked slot's logit is
``mask_fill`` in place of logits + bias: ``NEG_INF`` (-1e9, masking), or
the reference's legacy ``LEGACY_FILL`` (1e-30, ``--legacy_poly_mask``;
``miner_tpu/models/poly_attention.py:54-55``), under which pads keep a
weight. The JAX package sends the legacy fill down its XLA path; here the
kernel takes the fill as a launch argument.

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
from typing import Optional, Tuple

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


# the kernel's (CTAs a batch row, D split across them), in the order it takes
# the first whose CTA fits (csrc/poly_attention_fwd.cu:BF16_PLANS, FP32_PLANS)
BF16_PLANS = ((4, False), (8, True))
FP32_PLANS = ((3, False), (8, False), (8, True))


@functools.lru_cache(maxsize=None)
def _layout_bytes(H: int, D: int, P: int, K: int, code: int, nc: int, split: bool) -> int:
    """Shared memory a CTA of the kernel takes at these shapes with ``nc``
    CTAs a row, D split or not, from the kernel's own layout."""
    return common.kernel_function("poly_attention_fwd", "poly_attention_layout_bytes",
                                  (ctypes.c_int,) * 7, ctypes.c_longlong)(
                                      H, D, P, K, code, nc, int(split))


def plan(H: int, D: int, P: int, K: int, dtype: torch.dtype) -> Tuple[int, bool, int]:
    """(CTAs a batch row, D split across them, bytes a CTA), from the
    shapes alone, as the kernel takes them: the first plan of the type
    whose CTA fits. bf16 (:data:`BF16_PLANS`): 4 CTAs (emb whole and a
    quarter of W's columns each), 8 with D split (an eighth of emb's
    columns and W's rows each, the partial proj summed over the cluster:
    D = 768); fp32 (:data:`FP32_PLANS`): 3 (a third of W's columns), 8 (an
    eighth), 8 with D split. Raises when none fits: no fallback."""
    code = common.DTYPE_CODES[dtype]
    plans = FP32_PLANS if dtype == torch.float32 else BF16_PLANS
    for nc, split in plans:
        smem = _layout_bytes(H, D, P, K, code, nc, split)
        if smem <= _MAX_SMEM:
            return nc, split, smem
    raise ValueError(f"poly-attention at H={H}, D={D}, P={P}, K={K} needs {smem} "
                     f"bytes of shared memory per CTA at {nc} CTAs a row, more "
                     f"than {_MAX_SMEM}")


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
    plan(H, D, P, K, emb.dtype)
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
