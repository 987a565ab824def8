"""Fastformer additive attention, forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/fastformer_attn.py:fastformer_attention_fused``,
the additive-attention inner loop of one Fastformer layer after its q/k
projections. Per batch row, with h heads of hd = D / h channels, scale
1/sqrt(hd) and a mask bias of 0 for valid positions and -10000 (``MASK_FILL``)
for masked ones:

    alpha    = softmax_L((q @ wqa + bqa) * scale + bias)     # (L, h)
    pooled_q = sum_l alpha[l, head(d)] q[l, d]               # (D,)
    u        = k * pooled_q
    beta     = softmax_L((u @ wka + bka) * scale + bias)
    pooled_k = sum_l beta[l, head(d)] u[l, d]
    out      = pooled_k * q                                  # (L, D)

Each head's score is a dot over the whole D, not over its own hd channels.
A fully masked row shifts every logit by the same -10000, so its softmax
runs over all positions as if nothing were masked: never NaN.

The kernel is ``csrc/fastformer_attn_fwd.cu``. It takes float32 and
bfloat16; the weights are cast to q's type, as the TPU kernel does, and the
intermediates are rounded to that type where the JAX reference rounds them
(scores, softmax weights, pooled vectors, u).

Under autograd (grad mode on and an input requiring grad) a CUDA tensor
goes through a ``torch.autograd.Function``: the forward is the kernel, the
backward recomputes the plain version under ``enable_grad`` and
differentiates it, as the JAX package does (``miner_tpu/ops/
fastformer_attn.py:134-156``: the kernel forward, the XLA reference's VJP).
q, k and the four attention weights get gradients; the mask gets none. A
CPU tensor takes the plain version, differentiable as it stands.
"""
from __future__ import annotations

import ctypes
import math

import torch

from miner_tpu_torch.ops import common

MASK_FILL = -10000.0
_MAX_SMEM = 227 * 1024
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def fastformer_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   wqa: torch.Tensor, bqa: torch.Tensor,
                                   wka: torch.Tensor, bka: torch.Tensor,
                                   mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version; q, k (B, L, D), wqa, wka (D, h), bqa, bka (h,),
    mask (B, L) -> (B, L, D) in q's type."""
    B, L, D = q.shape
    h = num_heads
    dt = q.dtype
    scale = 1.0 / math.sqrt(D // h)
    bias = torch.where(mask.bool(), 0.0, MASK_FILL)[:, :, None]  # (B, L, 1) fp32

    def pool(x, w, b):
        score = (x @ w.to(dt) + b.to(dt)).float()
        weights = torch.softmax(score * scale + bias, dim=1).to(dt)  # (B, L, h)
        pooled = torch.einsum("blh,blhd->bhd", weights.float(),
                              x.float().reshape(B, L, h, D // h))
        return pooled.reshape(B, 1, D).to(dt)

    u = k * pool(q, wqa, bqa)
    return pool(u, wka, bka) * q


def fastformer_attention_fused(q: torch.Tensor, k: torch.Tensor,
                               wqa: torch.Tensor, bqa: torch.Tensor,
                               wka: torch.Tensor, bka: torch.Tensor,
                               mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) mixed values. A CPU tensor takes
    :func:`fastformer_attention_reference`; a CUDA tensor launches the
    kernel (q, k of one type, float32 or bfloat16; mask int32) or raises."""
    if q.dim() != 3 or tuple(k.shape) != tuple(q.shape):
        raise ValueError(f"q and k must be one (B, L, D) shape, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, L, D = q.shape
    h = int(num_heads)
    if h <= 0 or D % h:
        raise ValueError(f"num_heads {h} does not divide D = {D}")
    for name, w, b in (("wqa", wqa, bqa), ("wka", wka, bka)):
        if tuple(w.shape) != (D, h) or tuple(b.shape) != (h,):
            raise ValueError(f"{name} has shape {tuple(w.shape)} and its bias "
                             f"{tuple(b.shape)}, expected {(D, h)} and {(h,)}")
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected {(B, L)}")
    if q.device.type == "cpu":
        return fastformer_attention_reference(q, k, wqa, bqa, wka, bka, mask, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, wqa, bqa, wka, bka)):
        return _FastformerAttention.apply(q, k, wqa, bqa, wka, bka, mask, h)
    return _launch(q, k, wqa, bqa, wka, bka, mask, h)


def _launch(q, k, wqa, bqa, wka, bka, mask, h) -> torch.Tensor:
    common.require_cuda(q, "fastformer_attention_fused")
    B, L, D = q.shape
    dev, dt = q.device, q.dtype
    common.check_tensor("q", q, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("k", k, dev, (dt,))
    common.check_tensor("mask", mask, dev, (torch.int32,))
    # the weights in q's type, as the TPU kernel casts them (a no-op copy
    # when they are already)
    weights = [w.to(dt).contiguous() for w in (wqa, bqa, wka, bka)]
    for name, w in zip(("wqa", "bqa", "wka", "bka"), weights):
        common.check_tensor(name, w, dev, (dt,))
    # one block's shared memory, as the kernel lays it out in fp32: both
    # weights and their biases, the (L, h) scores, both pooled vectors
    smem = 4 * (2 * h * D + 2 * h + L * h + 2 * D)
    if smem > _MAX_SMEM:
        raise ValueError(f"Fastformer attention at L={L}, D={D}, h={h} needs "
                         f"{smem} bytes of shared memory per block, more than "
                         f"{_MAX_SMEM}")
    out = torch.empty_like(q)
    fn = common.kernel_function("fastformer_attn_fwd", "fastformer_attn_fwd",
                                _ARGTYPES)
    common.launch("fastformer_attn_fwd", fn, q.data_ptr(), k.data_ptr(),
                  *(w.data_ptr() for w in weights), mask.data_ptr(),
                  out.data_ptr(), B, L, D, h, common.DTYPE_CODES[dt], dev.index,
                  common.stream_of(q))
    fastformer_attention_fused.launches += 1
    return out


class _FastformerAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, wqa, bqa, wka, bka, mask, num_heads):
        ctx.save_for_backward(q, k, wqa, bqa, wka, bka, mask)
        ctx.num_heads = num_heads
        return _launch(q, k, wqa, bqa, wka, bka, mask, num_heads)

    @staticmethod
    def backward(ctx, grad):
        *inputs, mask = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in inputs]
        with torch.enable_grad():
            out = fastformer_attention_reference(*leaves, mask, ctx.num_heads)
        return (*torch.autograd.grad(out, leaves, grad), None, None)


fastformer_attention_fused.launches = 0
