"""Fused dropout + residual add + LayerNorm: a Triton forward, a CUDA
backward, and the plain version of both.

Counterpart of ``miner_tpu/ops/add_ln.py:fused_dropout_add_ln``:
y = LayerNorm(x + dropout(h)) over the last axis. As in the TPU kernel
(add_ln.py:58-61) x and h are added in fp32 and the mean and variance are
fp32; gamma and beta are fp32; y comes out in x's type. (The JAX package's
XLA path adds in the compute type first; the plain version here follows
the kernel.) Dropout keeps element (row, column) by its Philox4x32-10 bits
(``ops/philox.py``), so the backward and a rematerialised forward
regenerate the mask from the seed and nothing random is stored. A call
over some rows of a batch (a rank's, over a mesh) passes their places in
the whole batch (``row_offset``) and draws their masks of the whole
batch; a ``row_offset`` of several pieces (``ops/philox.py:Offsets``)
launches each kernel once a piece.

Backward (as ``add_ln.py:_bwd_kernel``): recompute s, mu, rstd, xhat; with
g = dy * gamma, ds = rstd * (g - mean(g) - xhat * mean(g * xhat)),
dx = ds, dh = keep * ds / (1 - rate), dgamma = sum(dy * xhat),
dbeta = sum(dy).

The forward is a Triton kernel: one row-wise pass with two reductions,
bounded by the bytes it moves. Each program normalises a block of rows at
once, the feature axis padded to a power of two (768 -> 1024) under a mask;
it reads x, h and writes y once. The Philox rounds are written out below in
Triton with the counter layout of ``ops/philox.py``. ``triton`` is imported
only when the kernel is launched, so the module imports without it.

The backward is CUDA C++, ``csrc/add_ln_bwd.cu``: a warp per row, lanes
owning 16-byte vectors of it, dgamma and dbeta held in registers over
every row a warp visits and written as one partial per block to a
(2, blocks, D) fp32 buffer that is summed here (the TPU kernel's partials
are summed outside it too, add_ln.py:168): blocks run in no order on the
card, so there is no sum carried across the grid. Its Philox rounds are
``csrc/philox.cuh``'s, with the same counter layout (``add_ln_bits``) as
the Triton forward and the plain version, so the three draw one mask. It
takes D a multiple of 8 (bf16) or 4 (fp32) up to 1024, and rows that start
on 16-byte boundaries; the wrapper raises on anything else.

Under autograd (grad mode on and an input requiring grad) the op is a
``torch.autograd.Function`` whose backward is the backward kernel on the
card and the plain backward on the CPU.

Replaces: miner_tpu/ops/add_ln.py:_fwd_kernel (pallas_call at add_ln.py:122)
and _bwd_kernel (pallas_call at add_ln.py:144).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from miner_tpu_torch.ops import common, philox


def _dropped(h: torch.Tensor, rate: float, seed: int, row_offset: philox.Offsets = 0):
    """fp32 h after dropout; also returns the keep mask (None at rate 0)."""
    if rate <= 0.0:
        return h.float(), None
    T, D = h.shape
    keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, h.device, row_offset), rate)
    return torch.where(keep, h.float() * (1.0 / (1.0 - rate)), 0.0), keep


def _normalise(x, h, eps, rate, seed, row_offset=0):
    hd, keep = _dropped(h, rate, seed, row_offset)
    s = x.float() + hd
    mu = s.mean(dim=-1, keepdim=True)
    var = torch.square(s - mu).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (s - mu) * rstd, rstd, keep


def add_ln_reference(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float, rate: float = 0.0,
                     seed: int = 0, row_offset: philox.Offsets = 0) -> torch.Tensor:
    """Plain PyTorch version: LN(x + dropout(h)) with an fp32 add and fp32
    statistics."""
    xhat, _, _ = _normalise(x, h, eps, rate, seed, row_offset)
    return (xhat * scale.float() + bias.float()).to(x.dtype)


def add_ln_backward_reference(x: torch.Tensor, h: torch.Tensor,
                              scale: torch.Tensor, dy: torch.Tensor,
                              eps: float, rate: float = 0.0, seed: int = 0,
                              row_offset: philox.Offsets = 0) -> Tuple[torch.Tensor, ...]:
    """Plain backward, as formulas: (dx, dh) in x's type, (dscale, dbias)
    fp32."""
    xhat, rstd, keep = _normalise(x, h, eps, rate, seed, row_offset)
    dyf = dy.float()
    g = dyf * scale.float()
    ds = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dh = ds if keep is None else torch.where(keep, ds * (1.0 / (1.0 - rate)), 0.0)
    return (ds.to(x.dtype), dh.to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0))


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def philox_word(c0, c1, k0, k1, lane):
        # word `lane` of Philox4x32-10 at counter (c0, c1, 0, 0), key
        # (k0, k1); every operand uint32, as triton.language.random does it
        c2 = c0 * 0
        c3 = c2
        for _ in tl.static_range(10):
            _c0 = c0
            _c2 = c2
            c0 = tl.umulhi(0xCD9E8D57, _c2) ^ c1 ^ k0
            c2 = tl.umulhi(0xD2511F53, _c0) ^ c3 ^ k1
            c1 = 0xCD9E8D57 * _c2
            c3 = 0xD2511F53 * _c0
            k0 = k0 + 0x9E3779B9
            k1 = k1 + 0xBB67AE85
        return tl.where(lane == 0, c0, tl.where(lane == 1, c1,
                        tl.where(lane == 2, c2, c3)))

    @triton.jit
    def keep_mask(rows, cols, seed_lo, seed_hi, thresh, row_offset, OFFSET: tl.constexpr):
        # rows at their places in the whole batch (OFFSET: a launch over
        # part of it, compiled apart)
        zero = rows[:, None] * 0 + cols[None, :] * 0
        c0 = (cols[None, :] // 4 + zero).to(tl.uint32)
        if OFFSET:
            rows = rows + row_offset
        c1 = (rows[:, None] + zero).to(tl.uint32)
        bits = philox_word(c0, c1, seed_lo.to(tl.uint32), seed_hi.to(tl.uint32),
                           cols[None, :] % 4 + zero)
        return bits >= thresh.to(tl.uint32)

    @triton.jit(do_not_specialize=["seed_lo", "seed_hi", "thresh", "row_offset"])
    def add_ln_fwd(x_ptr, h_ptr, g_ptr, b_ptr, y_ptr, T, D, eps, seed_lo,
                   seed_hi, thresh, inv_keep, row_offset, DROPOUT: tl.constexpr,
                   OFFSET: tl.constexpr,
                   BLOCK_T: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        m = (rows < T)[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        h = tl.load(h_ptr + offs, mask=m, other=0.0).to(tl.float32)
        if DROPOUT:
            keep = keep_mask(rows, cols, seed_lo, seed_hi, thresh, row_offset, OFFSET)
            h = tl.where(keep, h * inv_keep, 0.0)
        s = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32) + h
        mean = tl.sum(s, axis=1) / D
        diff = tl.where(m, s - mean[:, None], 0.0)
        var = tl.sum(diff * diff, axis=1) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = diff * rstd[:, None] * g[None, :] + b[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return add_ln_fwd, triton.next_power_of_2


def _dropout_args(rate: float, seed: int):
    lo, hi = philox.split_seed(seed)
    if rate <= 0.0:
        return dict(seed_lo=lo, seed_hi=hi, thresh=0, inv_keep=1.0, DROPOUT=False)
    return dict(seed_lo=lo, seed_hi=hi, thresh=philox.threshold(rate),
                inv_keep=1.0 / (1.0 - rate), DROPOUT=True)


def _check(x, h, scale):
    common.check_tensor("x", x, x.device, tuple(common.DTYPE_CODES))
    common.check_tensor("h", h, x.device, (x.dtype,), tuple(x.shape))
    common.check_tensor("scale", scale, x.device, (torch.float32,), (x.shape[-1],))


def _launch_fwd(x, h, scale, bias, eps, rate, seed,
                row_offset: philox.Offsets = 0) -> torch.Tensor:
    common.require_cuda(x, "fused_dropout_add_ln")
    _check(x, h, scale)
    common.check_tensor("bias", bias, x.device, (torch.float32,))
    kernel, next_power_of_2 = _triton_kernels()
    T, D = x.shape
    y = torch.empty_like(x)
    block_d = next_power_of_2(D)
    block_t = max(1, 4096 // block_d)
    drop = _dropout_args(rate, seed)
    with torch.cuda.device(x.device):
        for lo, hi, off in philox.pieces(row_offset, T):  # one launch a piece
            at = lo + off if drop["DROPOUT"] else 0
            kernel[(-(-(hi - lo) // block_t),)](
                x[lo:hi], h[lo:hi], scale, bias, y[lo:hi], hi - lo, D, eps, **drop,
                row_offset=at, OFFSET=at != 0, BLOCK_T=block_t, BLOCK_D=block_d,
                num_warps=8 if drop["DROPOUT"] else 4)
            fused_dropout_add_ln.launches += 1
    return y


_MAX_BWD_D = 1024
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3
                 + (ctypes.c_float, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float)
                 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


@functools.lru_cache(maxsize=None)
def _bwd_blocks(T: int, D: int, code: int, device: int) -> int:
    """Blocks of the backward kernel's persistent grid: its partial rows."""
    blocks = ctypes.c_int(0)
    fn = common.kernel_function("add_ln_bwd", "add_ln_bwd_blocks",
                                (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    common.launch("add_ln_bwd", fn, T, D, code, device, ctypes.addressof(blocks))
    return blocks.value


def add_ln_backward(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                    dy: torch.Tensor, eps: float, rate: float = 0.0,
                    seed: int = 0, row_offset: philox.Offsets = 0
                    ) -> Tuple[torch.Tensor, ...]:
    """(dx, dh, dscale, dbias) of y = LN(x + dropout(h)) for the gradient
    dy. A CPU tensor takes :func:`add_ln_backward_reference`; a CUDA tensor
    launches the backward kernel (x, h, dy of one type, float32 or
    bfloat16, D a multiple of 8 or 4 up to 1024; scale float32) or raises."""
    if x.device.type == "cpu":
        return add_ln_backward_reference(x, h, scale, dy, eps, rate, seed, row_offset)
    common.require_cuda(x, "add_ln_backward")
    _check(x, h, scale)
    common.check_tensor("dy", dy, x.device, (x.dtype,), tuple(x.shape))
    T, D = x.shape
    vec = 16 // x.element_size()
    if D % vec or not 0 < D <= _MAX_BWD_D:
        raise ValueError(f"add_ln_backward: the kernel takes D a multiple of {vec} "
                         f"up to {_MAX_BWD_D} for {x.dtype}, got D = {D}")
    for what, t in (("x", x), ("h", h), ("dy", dy)):
        common.check_aligned(what, t)
    code, dev = common.DTYPE_CODES[x.dtype], x.device.index
    dx, dh = torch.empty_like(x), torch.empty_like(x)
    drop = _dropout_args(rate, seed)
    fn = common.kernel_function("add_ln_bwd", "add_ln_bwd", _BWD_ARGTYPES)
    sums = []
    for lo, hi, off in philox.pieces(row_offset, T):  # one launch a piece
        blocks = _bwd_blocks(hi - lo, D, code, dev)
        partial = torch.empty((2, blocks, D), dtype=torch.float32, device=x.device)
        common.launch("add_ln_bwd", fn, x[lo:hi].data_ptr(), h[lo:hi].data_ptr(),
                      scale.data_ptr(), dy[lo:hi].data_ptr(), dx[lo:hi].data_ptr(),
                      dh[lo:hi].data_ptr(), partial.data_ptr(), hi - lo, D, blocks, eps, seed,
                      drop["thresh"], drop["inv_keep"], int(drop["DROPOUT"]),
                      lo + off if drop["DROPOUT"] else 0, code, dev, common.stream_of(x))
        add_ln_backward.launches += 1
        sums.append(partial.sum(dim=1))
    dscale, dbias = sums[0] if len(sums) == 1 else torch.stack(sums).sum(0)
    return dx, dh, dscale, dbias


class _FusedAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, scale, bias, rate, eps, seed, row_offset):
        if x.device.type == "cpu":
            y = add_ln_reference(x, h, scale, bias, eps, rate, seed, row_offset)
        else:
            y = _launch_fwd(x, h, scale, bias, eps, rate, seed, row_offset)
        ctx.save_for_backward(x, h, scale)
        ctx.args = (eps, rate, seed, row_offset)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h, scale = ctx.saved_tensors
        eps, rate, seed, row_offset = ctx.args
        dx, dh, dscale, dbias = add_ln_backward(
            x, h, scale, dy.to(x.dtype).contiguous(), eps, rate, seed, row_offset)
        return dx, dh, dscale, dbias, None, None, None, None


def fused_dropout_add_ln(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, rate: float = 0.0,
                         eps: float = 1e-12, seed: int = 0,
                         row_offset: philox.Offsets = 0) -> torch.Tensor:
    """y = LayerNorm(x + dropout(h)); x, h (T, D); scale, bias (D,) fp32;
    dropout at ``rate`` from the 64-bit ``seed``, the masks of the rows at
    ``row_offset`` in the whole batch (0: the call is the whole batch).

    A CPU tensor takes :func:`add_ln_reference`; a CUDA tensor launches the
    kernel (x and h float32 or bfloat16, of one type) or raises. Under
    autograd the op goes through its Function (above)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    T, D = x.shape
    if tuple(h.shape) != (T, D) or tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"shapes x {tuple(x.shape)}, h {tuple(h.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)} do not agree")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")
    philox.split_seed(seed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h, scale, bias)):
        return _FusedAddLN.apply(x, h, scale, bias, rate, eps, seed, row_offset)
    if x.device.type == "cpu":
        return add_ln_reference(x, h, scale, bias, eps, rate, seed, row_offset)
    return _launch_fwd(x, h, scale, bias, eps, rate, seed, row_offset)


fused_dropout_add_ln.launches = 0
add_ln_backward.launches = 0
