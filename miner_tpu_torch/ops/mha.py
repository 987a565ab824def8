"""Fused multi-head self-attention: CUDA kernels (forward, backward) + plain.

Counterpart of ``miner_tpu/ops/mha.py:fused_mha``. Per head,
softmax(QK^T/sqrt(Dh), masked keys filled with -1e9), dropout on the
probabilities, times V, read straight from the fused QKV projection
(N, L, 3D), with fp32 logits. ``seqs > 1`` treats each row as that many
packed sub-sequences of length L/seqs that attend only within themselves
(block-diagonal), which keeps ``fused_mha``'s meaning; the port's PLM calls
it with ``seqs=1``, since the 128-row packing of short fields was TPU
layout work.

The kernels are ``csrc/mha_fwd.cu`` and ``csrc/mha_bwd.cu``. Dropout keeps
an element by its Philox4x32-10 bits (``ops/philox.py``: a function of the
seed and (n, head, query, key)), so the forward, the backward and a
rematerialised forward regenerate one mask and nothing random is stored.
A call over some of a batch's sequences or heads (a rank's, over a mesh)
passes their places in the whole batch (``seq_offset``, ``head_offset``)
and draws their masks of the whole batch; a ``seq_offset`` of several
pieces (``ops/philox.py:Offsets``) launches each kernel once a piece.
Both types run on the tensor cores. In bfloat16 the kernels round P (into
PV), Pd and dS (into the backward's products) to bf16, as the TPU kernels
round them to the input type; the plain versions here keep them fp32, and
the bf16 tolerance covers the difference. In float32 every product runs in
split TF32 (three TF32 passes, hi/lo halves of each operand: about fp32's
accuracy, where one TF32 pass would miss the 1e-4 tolerance) and the
probabilities stay fp32 into every product, so kernel and plain version
agree to rounding. A float32 qkv off a 16-byte boundary is taken (the
kernels copy it 4 bytes at a time); a bfloat16 one is refused.

Under autograd (grad mode on and ``qkv`` requiring grad) the op is a
``torch.autograd.Function``: on the card its forward kernel also saves each
row's softmax statistics and its backward is the backward kernel; on the CPU
both halves are the plain versions below, the backward written as formulas
(as the TPU kernel computes it), not as autograd of the forward. Under
``--remat`` it keeps its context and statistics for the layer's recompute
(``kept``), as JAX's remat saves the kernel's context by name
(``miner_tpu/models/plm.py:211-213, 430-446``): the recompute launches no
mha forward.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from miner_tpu_torch.ops import common, philox

NEG_INF = -1e9
_HEAD_DIMS = (16, 32, 64)
_DROPOUT_ARGTYPES = (ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int)
_FWD_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + _DROPOUT_ARGTYPES
                 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + _DROPOUT_ARGTYPES
                 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def _heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v as (N, heads, L, Dh) fp32."""
    N, L, D3 = qkv.shape
    D = D3 // 3
    f = qkv.float().reshape(N, L, 3, num_heads, D // num_heads)
    return (f[:, :, c].transpose(1, 2) for c in range(3))


def _probs(q, k, mask, seqs):
    """(N, heads, L, L) fp32 softmax of the masked, scaled logits."""
    L = q.shape[2]
    s = torch.einsum("nhqd,nhkd->nhqk", q, k) * (1.0 / q.shape[-1] ** 0.5)
    valid = mask.bool()[:, None, None, :]
    if seqs > 1:
        seg = torch.arange(L, device=q.device) // (L // seqs)
        valid = valid & (seg[:, None] == seg[None, :])
    return torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)


def _keep(N: int, H: int, L: int, rate: float, seed: int, device,
          seq_offset: philox.Offsets = 0, head_offset: int = 0):
    """The (N, H, L, L) keep mask, or None at rate 0."""
    if rate <= 0.0:
        return None
    return philox.keep_mask(philox.mha_bits(seed, N, H, L, device, seq_offset, head_offset),
                            rate)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(N, heads, L, Dh) -> (N, L, heads * Dh)."""
    N, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(N, L, H * Dh)


def mha_reference(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  seqs: int = 1, dropout_rate: float = 0.0,
                  seed: int = 0, seq_offset: philox.Offsets = 0,
                  head_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version. qkv (N, L, 3D), mask (N, L) -> (N, L, D)."""
    q, k, v = _heads(qkv, num_heads)
    p = _probs(q, k, mask, seqs)
    keep = _keep(*p.shape[:3], dropout_rate, seed, qkv.device, seq_offset, head_offset)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    return _merge(p @ v).to(qkv.dtype)


def mha_backward_reference(qkv: torch.Tensor, mask: torch.Tensor,
                           dout: torch.Tensor, num_heads: int, seqs: int = 1,
                           dropout_rate: float = 0.0, seed: int = 0,
                           seq_offset: philox.Offsets = 0, head_offset: int = 0
                           ) -> torch.Tensor:
    """Plain backward, as formulas (``miner_tpu/ops/mha.py:_bwd_kernel``):
    dV = Pd^T dO, dP = keep * dO V^T / (1 - rate),
    dS = P * (dP - rowsum(dP * P)) / sqrt(Dh), dQ = dS K, dK = dS^T Q.
    Returns dqkv (N, L, 3D) in qkv's type."""
    q, k, v = _heads(qkv, num_heads)
    N, H, L, Dh = q.shape
    do = dout.float().reshape(N, L, H, Dh).transpose(1, 2)
    p = _probs(q, k, mask, seqs)
    dp = do @ v.transpose(-1, -2)
    keep = _keep(N, H, L, dropout_rate, seed, qkv.device, seq_offset, head_offset)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.transpose(-1, -2) @ do
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * (1.0 / Dh ** 0.5)
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1).to(qkv.dtype)


def _dropout_args(rate: float, seed: int, seq_offset: int = 0, head_offset: int = 0):
    if rate <= 0.0:
        return 0, 0, 1.0, 0, 0, 0
    return seed, philox.threshold(rate), 1.0 / (1.0 - rate), 1, seq_offset, head_offset


def _check(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> int:
    """Raise on what the kernels do not take; returns the head dim."""
    Dh = qkv.shape[-1] // 3 // num_heads
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not supported by the kernel {_HEAD_DIMS}")
    common.check_tensor("qkv", qkv, qkv.device, tuple(common.DTYPE_CODES))
    common.check_tensor("mask", mask, qkv.device, (torch.int32,))
    if qkv.dtype == torch.bfloat16:  # the tensor-core kernels copy 16 bytes at a time
        common.check_aligned("qkv", qkv)
    return Dh


def _launch_fwd(qkv, mask, num_heads, seqs, rate, seed, with_stats,
                seq_offset: philox.Offsets = 0, head_offset: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    common.require_cuda(qkv, "fused_mha")
    Dh = _check(qkv, mask, num_heads)
    N, L, _ = qkv.shape
    out = torch.empty((N, L, num_heads * Dh), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((N, num_heads, L, 2), dtype=torch.float32,
                         device=qkv.device) if with_stats else None)
    fn = common.kernel_function("mha_fwd", "mha_fwd", _FWD_ARGTYPES)
    for lo, hi, off in philox.pieces(seq_offset, N):  # one launch a piece
        common.launch("mha_fwd", fn, qkv[lo:hi].data_ptr(), mask[lo:hi].data_ptr(),
                      out[lo:hi].data_ptr(), None if stats is None else stats[lo:hi].data_ptr(),
                      hi - lo, L, num_heads, Dh, seqs,
                      *_dropout_args(rate, seed, lo + off, head_offset),
                      common.DTYPE_CODES[qkv.dtype], qkv.device.index,
                      common.stream_of(qkv))
        fused_mha.launches += 1
    return out, stats


def mha_backward(qkv: torch.Tensor, mask: torch.Tensor, dout: torch.Tensor,
                 num_heads: int, dropout_rate: float = 0.0, seed: int = 0,
                 seqs: int = 1, out: Optional[torch.Tensor] = None,
                 stats: Optional[torch.Tensor] = None, seq_offset: philox.Offsets = 0,
                 head_offset: int = 0) -> torch.Tensor:
    """dqkv (N, L, 3D) from the forward's inputs and dout (N, L, D).

    A CPU tensor takes :func:`mha_backward_reference`; a CUDA tensor
    launches the backward kernel, which also needs the forward kernel's
    ``out`` and softmax ``stats`` (``_launch_fwd(..., with_stats=True)``),
    or raises."""
    if qkv.device.type == "cpu":
        return mha_backward_reference(qkv, mask, dout, num_heads, seqs,
                                      dropout_rate, seed, seq_offset, head_offset)
    common.require_cuda(qkv, "mha_backward")
    Dh = _check(qkv, mask, num_heads)
    N, L, D3 = qkv.shape
    if out is None or stats is None:
        raise ValueError("mha_backward on the card needs the forward kernel's "
                         "out and stats")
    common.check_tensor("out", out, qkv.device, (qkv.dtype,), (N, L, D3 // 3))
    common.check_tensor("dout", dout, qkv.device, (qkv.dtype,), (N, L, D3 // 3))
    common.check_tensor("stats", stats, qkv.device, (torch.float32,),
                        (N, num_heads, L, 2))
    if qkv.dtype == torch.bfloat16:
        common.check_aligned("out", out)
        common.check_aligned("dout", dout)
    code = common.DTYPE_CODES[qkv.dtype]
    floats = common.kernel_function("mha_bwd", "mha_bwd_scratch_floats",
                                    (ctypes.c_int,) * 5, ctypes.c_longlong)(
        N, L, num_heads, Dh, code)
    dqkv = torch.empty_like(qkv)
    # bf16 at L > 128: dQ sums over key tiles (fp32 sums in dqkv itself),
    # (N, H, L, Dh): a piece takes its sequences' rows of it
    scratch = (torch.empty((N, floats // N), dtype=torch.float32, device=qkv.device)
               if floats else None)
    fn = common.kernel_function("mha_bwd", "mha_bwd", _BWD_ARGTYPES)
    for lo, hi, off in philox.pieces(seq_offset, N):  # one launch a piece
        common.launch("mha_bwd", fn, qkv[lo:hi].data_ptr(), mask[lo:hi].data_ptr(),
                      out[lo:hi].data_ptr(), dout[lo:hi].data_ptr(), stats[lo:hi].data_ptr(),
                      dqkv[lo:hi].data_ptr(),
                      None if scratch is None else scratch[lo:hi].data_ptr(), hi - lo, L,
                      num_heads, Dh, seqs,
                      *_dropout_args(dropout_rate, seed, lo + off, head_offset),
                      code, qkv.device.index, common.stream_of(qkv))
        mha_backward.launches += 1
    return dqkv


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, num_heads, rate, seed, seqs, kept, seq_offset, head_offset):
        if kept:  # a rematerialised layer's recompute: the forward's own outputs
            out, stats = kept
        elif qkv.device.type == "cpu":
            out, stats = mha_reference(qkv, mask, num_heads, seqs, rate, seed, seq_offset,
                                       head_offset), None
        else:
            out, stats = _launch_fwd(qkv, mask, num_heads, seqs, rate, seed, True, seq_offset,
                                     head_offset)
        if kept is not None and not kept:
            kept.extend((out, stats))
        ctx.save_for_backward(qkv, mask, out, stats)
        ctx.args = (num_heads, rate, seed, seqs, seq_offset, head_offset)
        # kept: an alias, so that the kept tensor stays out of the graph
        return out if kept is None else out.detach()

    @staticmethod
    def backward(ctx, dout):
        qkv, mask, out, stats = ctx.saved_tensors
        num_heads, rate, seed, seqs, seq_offset, head_offset = ctx.args
        dqkv = mha_backward(qkv, mask, dout.to(qkv.dtype).contiguous(), num_heads,
                            rate, seed, seqs, out, stats, seq_offset, head_offset)
        return dqkv, None, None, None, None, None, None, None, None


def fused_mha(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
              dropout_rate: float = 0.0, seqs: int = 1,
              seed: int = 0, kept: Optional[list] = None,
              seq_offset: philox.Offsets = 0, head_offset: int = 0) -> torch.Tensor:
    """Attention context (N, L, D) from qkv (N, L, 3D) and mask (N, L),
    with dropout at ``dropout_rate`` from the 64-bit ``seed``; the masks of
    the sequences and heads at ``seq_offset`` and ``head_offset`` in the
    whole batch (0: the call is the whole batch).

    A CPU tensor takes :func:`mha_reference`; a CUDA tensor launches the
    kernel (qkv float32 or bfloat16, mask int32, head dim 16, 32 or 64) or
    raises. Under autograd the op goes through its Function (above).

    ``kept``, under autograd: a rematerialised layer's record of this call
    (``models/plm.py:Remat``). Empty, the call keeps its context and
    statistics in it; holding them, the call is the layer's recompute: it
    launches nothing, returns the kept context and saves for the backward
    what the first call saved."""
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
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} is not in [0, 1)")
    philox.split_seed(seed)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedMHA.apply(qkv, mask, num_heads, dropout_rate, seed, seqs, kept,
                               seq_offset, head_offset)
    if qkv.device.type == "cpu":
        return mha_reference(qkv, mask, num_heads, seqs, dropout_rate, seed, seq_offset,
                             head_offset)
    return _launch_fwd(qkv, mask, num_heads, seqs, dropout_rate, seed, False, seq_offset,
                       head_offset)[0]


fused_mha.launches = 0
mha_backward.launches = 0
