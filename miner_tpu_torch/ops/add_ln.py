"""Fused residual add + LayerNorm, forward: Triton kernel + plain version.

Counterpart of ``miner_tpu/ops/add_ln.py:fused_dropout_add_ln`` at dropout
rate 0: y = LayerNorm(x + h) over the last axis. As in the TPU kernel
(add_ln.py:58-61) x and h are added in fp32 and the mean and variance are
fp32; gamma and beta are fp32; y comes out in x's type. (The JAX package's
XLA path adds in the compute type first; the plain version here follows
the kernel.)

The kernel is Triton: one row-wise pass with two reductions, bounded by the
bytes it moves. Each program normalises a block of rows at once, the feature
axis padded to a power of two (768 -> 1024) under a mask; x, h, y cross
device memory once each and nothing else is stored. ``triton`` is imported
only when a kernel is launched, so the module imports without it.

Replaces: miner_tpu/ops/add_ln.py:_fwd_kernel (pallas_call at add_ln.py:122).
"""
from __future__ import annotations

import functools

import torch

from miner_tpu_torch.ops import common


def add_ln_reference(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version: LN(x + h) with an fp32 add and fp32 statistics."""
    s = x.float() + h.float()
    mu = s.mean(dim=-1, keepdim=True)
    var = torch.square(s - mu).mean(dim=-1, keepdim=True)
    y = (s - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def add_ln_fwd(x_ptr, h_ptr, g_ptr, b_ptr, y_ptr, T, D, eps,
                   BLOCK_T: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        m = (rows < T)[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        s = (tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
             + tl.load(h_ptr + offs, mask=m, other=0.0).to(tl.float32))
        mean = tl.sum(s, axis=1) / D
        diff = tl.where(m, s - mean[:, None], 0.0)
        var = tl.sum(diff * diff, axis=1) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = diff * rstd[:, None] * g[None, :] + b[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return add_ln_fwd, triton.next_power_of_2


def fused_dropout_add_ln(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, rate: float = 0.0,
                         eps: float = 1e-12) -> torch.Tensor:
    """y = LayerNorm(x + dropout(h)); x, h (T, D); scale, bias (D,) fp32.

    A CPU tensor takes :func:`add_ln_reference`; a CUDA tensor launches the
    kernel (x and h float32 or bfloat16, of one type) or raises."""
    if rate > 0.0:
        raise NotImplementedError(
            "residual dropout is not ported yet: it comes with the backward "
            "kernel in the training slice (ROADMAP Queue 1, item 1)")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    T, D = x.shape
    if tuple(h.shape) != (T, D) or tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"shapes x {tuple(x.shape)}, h {tuple(h.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)} do not agree")
    if x.device.type == "cpu":
        return add_ln_reference(x, h, scale, bias, eps)
    common.require_cuda(x, "fused_dropout_add_ln")
    common.check_tensor("x", x, x.device, tuple(common.DTYPE_CODES))
    common.check_tensor("h", h, x.device, (x.dtype,))
    common.check_tensor("scale", scale, x.device, (torch.float32,))
    common.check_tensor("bias", bias, x.device, (torch.float32,))
    kernel, next_power_of_2 = _triton_kernel()
    y = torch.empty_like(x)
    block_d = next_power_of_2(D)
    block_t = max(1, 4096 // block_d)
    with torch.cuda.device(x.device):
        kernel[(-(-T // block_t),)](x, h, scale, bias, y, T, D, eps,
                                    BLOCK_T=block_t, BLOCK_D=block_d,
                                    num_warps=4)
    fused_dropout_add_ln.launches += 1
    return y


fused_dropout_add_ln.launches = 0
