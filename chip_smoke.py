#!/usr/bin/env python3
"""The PyTorch port's training and serving paths on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. build: every CUDA kernel of ``miner_tpu_torch/csrc`` is compiled with
   ``nvcc`` (one process per source, all started together); the Triton
   kernels compile at their first launch.
2. kernels: each of the seven kernels runs at the shapes its paths give it
   (serving: the cache fill's chunks and request batches; training: a
   ``train_miner.txt`` micro-batch, with dropout on, and for mha also off,
   so that the dropout's share of the time shows, and in fp32; the add_ln
   backward also in fp32; poly-attention at the train, serve and eval
   batches, in fp32, and with a quarter of its rows fully masked;
   lookup+score at a slate (with candidates out of range: NaN), the
   whole-corpus top-k and an eval batch, in bf16 and fp32, and the top-k
   over a cache of MIND's size; Fastformer attention at the train, eval
   and serve batches, in fp32 as those paths give it, and in bf16)
   against its plain PyTorch version on the same inputs (the tolerance is
   printed beside the error; the mha backward's dq, dk and dv each at the
   scale of its (sequence, head)'s gradient; with dropout the kernel's
   mask must equal the plain version's bit for bit), and is timed with
   CUDA events beside the plain
   version, the one PyTorch call computing the same function where there
   is one (for lookup+score, which has none, the two calls index_select
   and bmm as a yardstick), and its bound on an H100 SXM (3.35 TB/s; 989
   TFLOP/s bf16, 67 TFLOP/s fp32). A kernel's time is its device time,
   from calls captured in a CUDA graph and replayed; the time of a call
   back to back, host included, is printed beside it.
3. train: the launch counts are set to 0 and ``Trainer.train()`` runs the
   full-width ``config/train_miner.txt`` (roberta-base towers, random
   weights from the seed, bf16 compute, dropout, --remat, accumulation 8)
   for one epoch of a synthetic MIND corpus: 16 micro-batches, 2 optimizer
   updates, the cached eval, the checkpoints. The micro-batches must have
   launched every Miner kernel but lookup+score, the eval every serving one.
4. serve: the counts are set to 0, ``config/serve_miner.txt`` restores the
   train phase's ``finalModel`` (``--saved_model_path``), encodes the corpus
   into the news-embedding cache, and the HTTP server answers concurrent
   slate and whole-corpus top-k requests. Every serving kernel must have
   launched.
5. Fastformer train: the same for ``config/train_fastformer.txt`` (the
   Fastformer user encoder over the same towers, frozen with
   ``--freeze_transformer``). The micro-batches and the eval must launch
   mha_fwd, add_ln_fwd and fastformer_attn_fwd, the backward kernels never
   (nothing differentiates through the frozen PLM), and every PLM parameter
   of the ``finalModel`` must equal its initial value bit for bit.
6. Fastformer serve: ``serve_miner.txt`` with ``--model_name fastformer``
   restores that ``finalModel`` and answers over HTTP, launching mha_fwd,
   add_ln_fwd (cache fill) and fastformer_attn_fwd.
7. parity: the full-width Miner in float32 over 64 news, on the card
   through the kernels and on the CPU through the plain versions; the cache
   rows and the scores of one request batch must agree.
8. train parity, Miner and Fastformer: one micro-batch of one impression in
   float32, dropout off, on the card and on the CPU: the loss and every
   trainable parameter's gradient must agree.

After the phases, every shape at which the main path launched
poly-attention or lookup+score (a census of their launches) is timed, and
each kernel's launch-weighted gap, launches x (time - bound) summed over
the shapes it was launched at, goes into its row.

Prints the card's name and power limit, one JSON line of kernel results,
and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels add_ln_bwd,poly_attention_fwd [--package DIR]

builds and runs only the kernel phase of the kernels named, from the
``miner_tpu_torch`` under DIR when given (an unpacked other commit, such as
the parent: ``git archive <commit> | tar -x -C DIR``), so that two versions
are timed on one card in one session.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: float32 differs by summation order only; a
# bfloat16 output may differ by rounding of the output and of the
# intermediates the kernels round (proj, softmax weights): a few ulps
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
HIDDEN, HEADS = 768, 12  # roberta-base
CHUNK = 512  # CacheFiller's chunk of news
HIS, DIM, CODES, CODE_DIM = 50, 256, 32, 200  # config/serve_miner.txt
MAX_BATCH = 32  # --serve_max_batch default
NUM_NEWS = 4096
# config/train_miner.txt: batch 16 of 1 positive + 4 negatives and 50 history
# news, 55 news per impression -> 880 sequences per field per micro-batch
TRAIN_N, TRAIN_TITLE, TRAIN_SAPO = 16 * 55, 32, 128
TRAIN_RATE = 0.1  # hidden_dropout and attention_dropout of the PLM
# the mha kernels' training cases (L, dropout rate, dtype): the sapo shape
# with dropout (the main path's), without it (Philox's share), in fp32
# (--compute_dtype float32, the CUDA-core kernels); the title shape
TRAIN_MHA_CASES = ((TRAIN_SAPO, TRAIN_RATE, torch.bfloat16), (TRAIN_SAPO, 0.0, torch.bfloat16),
                   (TRAIN_SAPO, TRAIN_RATE, torch.float32),
                   (TRAIN_TITLE, TRAIN_RATE, torch.bfloat16))
FF_HEADS = 16  # the Fastformer of word_embed_dim 256 (trainer: 16 if D % 16 == 0)
TRAIN_B, EVAL_B = 16, 64  # train_fastformer.txt's train and eval batches
# the kernels each phase of the main path must launch (and, for the frozen
# Fastformer training, must not)
MINER_KERNELS = ("mha_fwd", "add_ln_fwd", "poly_attention_fwd")
FF_KERNELS = ("mha_fwd", "add_ln_fwd", "fastformer_attn_fwd")
REQUIRED = {
    "train": MINER_KERNELS + ("mha_bwd", "add_ln_bwd"),
    "eval": MINER_KERNELS + ("lookup_score_fwd",),
    "serve": MINER_KERNELS + ("lookup_score_fwd",),
    "fastformer_train": FF_KERNELS,
    "fastformer_eval": FF_KERNELS,
    "fastformer_serve": FF_KERNELS,
}
FORBIDDEN = {"fastformer_train": ("mha_bwd", "add_ln_bwd")}
# the libraries whose ptxas report names each entry (kernels built in
# several variants)
ENTRY_REPORTS = ("mha_fwd", "mha_bwd", "add_ln_bwd", "poly_attention_fwd",
                 "lookup_score_fwd", "fastformer_attn_fwd")
# MIND (Wu et al., ACL 2020) counts 161,013 news: a cache of 161,014 rows
# (row 0 the padding), and the corpus top-k's candidate bucket over it
MIND_NEWS = 161013
# which phases' launches a kernel case stands for, in the launch-weighted
# gap (launches x (time - bound)): a phase's launches are split evenly over
# its cases (titles and sapos launch equally often; the cache fill's chunks
# are taken as full). Poly-attention and lookup+score are counted shape by
# shape instead (LaunchCensus).
TRAIN_PHASES = ("train", "fastformer_train")
FILL_PHASES = ("eval", "serve", "fastformer_eval", "fastformer_serve")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, target_s: float = 0.2) -> float:
    """Mean time of ``fn()`` on the card in ms, from CUDA events around a
    run of launches after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(200, int(target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` in ms: ``calls`` calls captured in a CUDA
    graph and replayed, so that no host time (the wrapper's checks, the
    ctypes call) sits between the launches. A kernel of a few microseconds
    is otherwise timed at the host's pace by :func:`device_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = device_ms(graph.replay) / calls
    del graph
    return ms


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- kernels
def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def output_errors(got, want, rel):
    """Per output: its largest error against ``rel`` of its own scale."""
    errs = []
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        errs.append(dict(err=err, tol=rel * max(1.0, b.float().abs().max().item()),
                         max_err=err))
    return errs


def _mha_inputs(dev, g, N, L, dtype):
    qkv = torch.randn(N, L, 3 * HIDDEN, device=dev, generator=g).to(dtype)
    lengths = torch.randint(1, L + 1, (N,), device=dev, generator=g)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).to(torch.int32)
    return qkv, mask


def _sdpa_leaves(qkv):
    """q, k, v (N, heads, L, Dh) as leaf tensors, for the SDPA yardstick."""
    N, L, _ = qkv.shape
    return [t.contiguous().requires_grad_()
            for t in qkv.view(N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)]


def mha_dropout_mask_check(qkv, mask, seed):
    """The forward kernel's dropout zeros against the plain Philox mask, bit
    for bit: with V set to one-hot rows (one launch per block of Dh keys)
    each output row is a row of dropped probabilities, zero exactly where
    the key is dropped or masked."""
    from miner_tpu_torch.ops import mha, philox

    N, L, _ = qkv.shape
    Dh = HIDDEN // HEADS
    keep = philox.keep_mask(philox.mha_bits(seed, N, HEADS, L, qkv.device), TRAIN_RATE)
    want_zero = ~(keep & mask.bool()[:, None, None, :])  # (N, heads, L, L)
    mismatches = 0
    for k0 in range(0, L, Dh):
        nb = min(Dh, L - k0)
        probe = qkv.clone().view(N, L, 3, HEADS, Dh)
        probe[:, :, 2] = 0
        j = torch.arange(nb, device=qkv.device)
        probe[:, k0 + j, 2, :, j] = 1
        out = mha.fused_mha(probe.view(N, L, -1), mask, HEADS, TRAIN_RATE, 1, seed)
        got_zero = out.view(N, L, HEADS, Dh)[..., :nb] == 0
        mismatches += int((got_zero != want_zero[..., k0:k0 + nb].permute(0, 2, 1, 3)).sum())
    return mismatches == 0, f"mask mismatches {mismatches}"


def mha_cases(dev, g):
    from miner_tpu_torch.ops import mha

    for dtype in (torch.bfloat16, torch.float32):
        for L in (32, 128):  # titles, sapo: the serving path's cache fill
            qkv, mask = _mha_inputs(dev, g, CHUNK, L, dtype)
            mask[0] = 0  # a fully masked row comes out as the mean of V
            q, k, v = qkv.view(CHUNK, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
            bool_mask = mask.bool()[:, None, None, :]
            out = torch.empty(CHUNK, L, HIDDEN, dtype=dtype, device=dev)
            flops = 4 * CHUNK * HEADS * L * L * (HIDDEN // HEADS)
            yield dict(
                case=f"{str(dtype)[6:]} N={CHUNK} L={L}", dtype=dtype,
                kernel=lambda: mha.fused_mha(qkv, mask, HEADS),
                plain=lambda: mha.mha_reference(qkv, mask, HEADS),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=bool_mask),
                bound=bound_ms(_nbytes(qkv, mask, out), flops, dtype),
                phases=FILL_PHASES if dtype == torch.bfloat16 else ())
    # the training path: dropout on (and, at the sapo shape, off, so that
    # Philox's share shows), bf16 and, as --compute_dtype float32 gives it,
    # fp32; under autograd the forward also writes the softmax statistics,
    # as here
    for L, rate, dtype in TRAIN_MHA_CASES:
        seed = 2 ** 40 + L
        qkv, mask = _mha_inputs(dev, g, TRAIN_N, L, dtype)
        q, k, v = qkv.view(TRAIN_N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(TRAIN_N, L, HIDDEN, dtype=dtype, device=dev)
        stats = torch.empty(TRAIN_N, HEADS, L, 2, device=dev)
        flops = 4 * TRAIN_N * HEADS * L * L * (HIDDEN // HEADS)
        yield dict(
            case=f"{str(dtype)[6:]} N={TRAIN_N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, True)[0],
            plain=lambda: mha.mha_reference(qkv, mask, HEADS, 1, rate, seed),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=rate),
            check=(lambda: mha_dropout_mask_check(qkv, mask, seed)) if rate else None,
            bound=bound_ms(_nbytes(qkv, mask, out, stats), flops, dtype),
            main=L == TRAIN_SAPO and rate > 0 and dtype == torch.bfloat16,
            phases=TRAIN_PHASES if rate > 0 and dtype == torch.bfloat16 else ())


def mha_grad_errors(got, want, rel):
    """The mha backward's dqkv as its dq, dk and dv parts, each element held
    at ``rel`` of the largest |dq|, |dk| or |dv| of its (sequence, head).

    The scale is per head, not one over the batch: lengths run from 1 to L,
    and the dv of a one-key sequence (the dO of all L rows sent to one key)
    is ~100x the typical gradient, so a batch-wide tolerance would pass a dq
    or dk of a long sequence that misses a key tile. Nor is it per part
    within a head: with one valid key, dq and dk are exactly 0 (dS =
    P (dP - D_i) cancels), and the kernel's D_i, taken from the bf16
    output, leaves rounding noise there on the scale of that head's dv.
    Returns, per part, err and tol at the (sequence, head) where err / tol
    is worst, the part's largest error and its RMS."""
    (a,), (b,) = got, want
    N, L, D3 = b.shape
    shape = (N, L, 3, HEADS, D3 // 3 // HEADS)
    err = (a.float() - b.float()).abs().view(shape).amax(dim=(1, 4))  # (N, 3, heads)
    w = b.float().view(shape)
    tol = rel * w.abs().amax(dim=(1, 2, 4)).clamp_min(1e-30)  # (N, heads)
    parts = []
    for c, part in enumerate(("dq", "dk", "dv")):
        worst = (err[:, c] / tol).flatten().argmax()
        parts.append(dict(part=part, err=err[:, c].flatten()[worst].item(),
                          tol=tol.flatten()[worst].item(), max_err=err[:, c].max().item(),
                          rms=w[:, :, c].pow(2).mean().sqrt().item()))
    return parts


def mha_bwd_cases(dev, g):
    from miner_tpu_torch.ops import mha

    for L, rate, dtype in TRAIN_MHA_CASES:
        seed = 2 ** 41 + L
        qkv, mask = _mha_inputs(dev, g, TRAIN_N, L, dtype)
        dout = torch.randn(TRAIN_N, L, HIDDEN, device=dev, generator=g).to(dtype)
        out, stats = mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, True)
        leaves = _sdpa_leaves(qkv)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask.bool()[:, None, None, :], dropout_p=rate)
        sdpa_dout = dout.view(TRAIN_N, L, HEADS, -1).transpose(1, 2)
        flops = 5 * 2 * TRAIN_N * HEADS * L * L * (HIDDEN // HEADS)
        yield dict(
            case=f"{str(dtype)[6:]} N={TRAIN_N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha.mha_backward(qkv, mask, dout, HEADS, rate, seed, 1,
                                            out, stats),
            plain=lambda: mha.mha_backward_reference(qkv, mask, dout, HEADS, 1,
                                                     rate, seed),
            library=lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                retain_graph=True),
            errors=mha_grad_errors,
            # reads qkv, out, dout, stats and mask; writes dqkv
            bound=bound_ms(_nbytes(qkv, out, dout, stats, mask, qkv), flops, dtype),
            main=L == TRAIN_SAPO and rate > 0 and dtype == torch.bfloat16,
            phases=("train",) if rate > 0 and dtype == torch.bfloat16 else ())


def _ln_inputs(dev, g, T, dtype):
    x = torch.randn(T, HIDDEN, device=dev, generator=g).to(dtype)
    h = torch.randn(T, HIDDEN, device=dev, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(HIDDEN, device=dev, generator=g)
    bias = 0.1 * torch.randn(HIDDEN, device=dev, generator=g)
    return x, h, scale, bias


def add_ln_cases(dev, g):
    from miner_tpu_torch.ops import add_ln

    for dtype in (torch.bfloat16, torch.float32):
        for L in (32, 128):
            T = CHUNK * L
            x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
            scale_t, bias_t = scale.to(dtype), bias.to(dtype)
            yield dict(
                case=f"{str(dtype)[6:]} T={T}", dtype=dtype,
                kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, 0.0, 1e-5),
                plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-5),
                library=lambda: torch.nn.functional.layer_norm(
                    x + h, (HIDDEN,), scale_t, bias_t, 1e-5),
                bound=bound_ms(_nbytes(x, h, scale, bias, x), 8 * T * HIDDEN,
                               torch.float32),
                phases=FILL_PHASES if dtype == torch.bfloat16 else ())
    for L in (TRAIN_SAPO, TRAIN_TITLE):
        T, dtype, seed = TRAIN_N * L, torch.bfloat16, 2 ** 42 + L
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        yield dict(
            case=f"bf16 T={T} dropout {TRAIN_RATE}", dtype=dtype,
            kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, TRAIN_RATE,
                                                       1e-5, seed),
            plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-5,
                                                  TRAIN_RATE, seed),
            library=lambda: torch.nn.functional.layer_norm(
                x + torch.nn.functional.dropout(h, TRAIN_RATE), (HIDDEN,), scale_t,
                bias_t, 1e-5),
            bound=bound_ms(_nbytes(x, h, scale, bias, x), 9 * T * HIDDEN,
                           torch.float32),
            main=L == TRAIN_SAPO, phases=TRAIN_PHASES)


def add_ln_bwd_cases(dev, g):
    from miner_tpu_torch.ops import add_ln, philox

    for L, dtype in ((TRAIN_SAPO, torch.bfloat16), (TRAIN_TITLE, torch.bfloat16),
                     (TRAIN_SAPO, torch.float32)):
        T, seed = TRAIN_N * L, 2 ** 43 + L
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        dy = torch.randn(T, HIDDEN, device=dev, generator=g).to(dtype)
        leaves = [t.detach().clone().requires_grad_() for t in (x, h, scale, bias)]
        y = torch.nn.functional.layer_norm(leaves[0] + leaves[1], (HIDDEN,),
                                           leaves[2].to(dtype), leaves[3].to(dtype),
                                           1e-5)

        def mask_check():
            keep = philox.keep_mask(philox.add_ln_bits(seed, T, HIDDEN, dev), TRAIN_RATE)
            dh = add_ln.add_ln_backward(x, h, scale, dy, 1e-5, TRAIN_RATE, seed)[1]
            mismatches = int(((dh != 0) != keep).sum())
            return mismatches == 0, f"mask mismatches {mismatches}"

        yield dict(
            case=f"{str(dtype)[6:]} T={T} dropout {TRAIN_RATE}", dtype=dtype,
            kernel=lambda: add_ln.add_ln_backward(x, h, scale, dy, 1e-5, TRAIN_RATE,
                                                  seed),
            plain=lambda: add_ln.add_ln_backward_reference(x, h, scale, dy, 1e-5,
                                                           TRAIN_RATE, seed),
            library=lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
            check=mask_check,
            bound=bound_ms(_nbytes(x, h, dy, x, h), 20 * T * HIDDEN, torch.float32),
            main=L == TRAIN_SAPO and dtype == torch.bfloat16,
            phases=("train",) if dtype == torch.bfloat16 else ())


def _poly_inputs(dev, g, B, dtype, masked_rows=0, H=HIS, D=DIM, P=CODE_DIM, K=CODES):
    emb = torch.randn(B, H, D, device=dev, generator=g).to(dtype)
    w = (torch.randn(D, P, device=dev, generator=g) / 16).to(dtype)
    codes = (torch.randn(K, P, device=dev, generator=g) / 4).to(dtype)
    lengths = torch.randint(1, H + 1, (B,), device=dev, generator=g)
    lengths[:masked_rows] = 0
    mask = (torch.arange(H, device=dev)[None] < lengths[:, None]).to(torch.int32)
    bias = torch.randn(B, H, device=dev, generator=g)
    return emb, w, codes, mask, bias


def _poly_bound(inputs):
    emb, w, codes = inputs[:3]
    (B, H, D), (K, P) = emb.shape, codes.shape
    out_bytes = B * K * D * emb.element_size()
    flops = 2 * B * H * (D * P + P * K + K * D)
    return bound_ms(_nbytes(*inputs) + out_bytes, flops, emb.dtype)


def poly_cases(dev, g):
    """Poly-attention at the batches its paths give it (16: a training
    micro-batch; 32: a full serving request batch; 64: an eval batch), in
    bf16 and, at 32, in fp32 and with a quarter of the rows fully masked
    (users with no clicks: the mean of the 50 real history rows)."""
    from miner_tpu_torch.ops import poly_attention

    for B, dtype, masked in ((TRAIN_B, torch.bfloat16, 0), (MAX_BATCH, torch.bfloat16, 0),
                             (EVAL_B, torch.bfloat16, 0), (MAX_BATCH, torch.float32, 0),
                             (MAX_BATCH, torch.bfloat16, MAX_BATCH // 4)):
        args = _poly_inputs(dev, g, B, dtype, masked)
        yield dict(
            case=f"{str(dtype)[6:]} B={B}" + (f", {masked} rows fully masked" if masked else ""),
            dtype=dtype,
            kernel=lambda: poly_attention.poly_attention_fused(*args),
            plain=lambda: poly_attention.poly_attention_reference(*args),
            library=None,
            bound=_poly_bound(args),
            main=dtype == torch.bfloat16 and B == MAX_BATCH and not masked)


def _lookup_inputs(dev, g, N, B, C, K, D, dtype):
    """A cache of N rows, (B, C) candidate rows (a whole-corpus request takes
    every row in order, as ``serve_topk`` builds it; others draw them at
    random) and (B, K, D) interests; and the bytes the gather must read."""
    cache = torch.randn(N, D, device=dev, generator=g).to(dtype)
    interests = torch.randn(B, K, D, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, N, (B, C), device=dev, generator=g, dtype=torch.int32)
    if C >= N - 1:
        idx[:] = torch.arange(1, C + 1, device=dev, dtype=torch.int32) % N
    rows = torch.unique(idx).numel()
    out_bytes = B * C * K * cache.element_size()
    nbytes = rows * D * cache.element_size() + _nbytes(idx, interests) + out_bytes
    return (cache, idx, interests), nbytes


def lookup_nan_check(cache, idx, interests):
    """Candidates whose index lies outside [0, N) (negative, N, far past
    it) score NaN, and every other score equals the plain version's on the
    same rows."""
    from miner_tpu_torch.ops import lookup_score

    N = cache.shape[0]
    bad_idx = idx.clone()
    bad = torch.zeros_like(idx, dtype=torch.bool)
    for b, c, v in ((0, 0, -1), (1, idx.shape[1] - 1, N), (2, idx.shape[1] // 2, N + 10 ** 6)):
        bad_idx[b, c] = v
        bad[b, c] = True
    got = lookup_score.lookup_score_fused(cache, bad_idx, interests)
    want = lookup_score.lookup_score_reference(cache, bad_idx.clamp(0, N - 1), interests)
    nan_ok = bool(torch.isnan(got[bad]).all())
    err = (got[~bad].float() - want[~bad].float()).abs().max().item()
    ok = nan_ok and err <= REL_TOL[interests.dtype] * max(1.0, want[~bad].float().abs().max().item())
    return ok, f"out-of-range rows NaN {nan_ok}, the others' err {err:.3g}"


def lookup_cases(dev, g):
    """lookup+score at a full serving request batch: a slate (C = 16), the
    whole-corpus top-k (C = 4,096), and an eval batch (B = 64 rows of one
    candidate each); in bf16 (the tensor cores) and fp32 (the CUDA cores);
    and the top-k over a cache of MIND's size (161,014 rows, 82 MB in bf16,
    more than the 50 MB L2) at B = 8. Beside each bf16 case the yardstick
    of two PyTorch calls, ``index_select`` then ``torch.bmm``."""
    from miner_tpu_torch.ops import lookup_score
    from miner_tpu_torch.utils import candidate_bucket

    cases = [(dtype, NUM_NEWS + 1, B, C)
             for dtype in (torch.bfloat16, torch.float32)
             for B, C in ((MAX_BATCH, 16), (MAX_BATCH, candidate_bucket(NUM_NEWS)), (EVAL_B, 1))]
    cases.append((torch.bfloat16, MIND_NEWS + 1, 8, candidate_bucket(MIND_NEWS)))
    for dtype, N, B, C in cases:
        args, nbytes = _lookup_inputs(dev, g, N, B, C, CODES, DIM, dtype)
        cache, idx, interests = args
        yield dict(
            case=f"{str(dtype)[6:]} N={N} B={B} C={C}", dtype=dtype,
            kernel=lambda: lookup_score.lookup_score_fused(*args),
            plain=lambda: lookup_score.lookup_score_reference(*args),
            library=None,
            yardstick=(lambda: torch.bmm(
                cache.index_select(0, idx.view(-1)).view(B, C, DIM),
                interests.transpose(1, 2))) if dtype == torch.bfloat16 else None,
            check=(lambda: lookup_nan_check(*args)) if C == 16 else None,
            bound=bound_ms(nbytes, 2 * B * C * CODES * DIM, dtype),
            main=dtype == torch.bfloat16 and C == candidate_bucket(NUM_NEWS))


def ff_cases(dev, g):
    """Fastformer attention at the shapes its paths give it: q, k (B, 50,
    256), 16 heads, float32 (the user encoder computes in fp32 whatever
    --compute_dtype says), B = 16 (a training micro-batch), 64 (an eval
    batch), 32 (a full serving request batch); the training shape in bf16;
    and one with a quarter of its rows fully masked (users with no clicks)."""
    from miner_tpu_torch.ops import fastformer_attn

    h = FF_HEADS
    for B, dtype, what in ((TRAIN_B, torch.float32, "train"),
                           (EVAL_B, torch.float32, "eval"),
                           (MAX_BATCH, torch.float32, "serve"),
                           (TRAIN_B, torch.bfloat16, "train"),
                           (TRAIN_B, torch.float32, "train, 4 rows fully masked")):
        q, k = (torch.randn(B, HIS, DIM, device=dev, generator=g).to(dtype)
                for _ in range(2))
        wqa, wka = (torch.randn(DIM, h, device=dev, generator=g) * 0.1
                    for _ in range(2))
        bqa, bka = (torch.randn(h, device=dev, generator=g) * 0.1 for _ in range(2))
        lengths = torch.randint(1, HIS + 1, (B,), device=dev, generator=g)
        if "masked" in what:
            lengths[:4] = 0
        mask = (torch.arange(HIS, device=dev)[None] < lengths[:, None]).to(torch.int32)
        args = (q, k, wqa, bqa, wka, bka, mask, h)
        # two score passes (2 L D h each), two poolings, u, the output gate
        # and two softmaxes over (L, h)
        flops = B * (4 * HIS * DIM * h + 4 * HIS * DIM + 2 * HIS * DIM + 10 * HIS * h)
        nbytes = _nbytes(q, k, q, mask) + 2 * (DIM + 1) * h * q.element_size()
        yield dict(
            case=f"{str(dtype)[6:]} B={B} L={HIS} D={DIM} h={h} {what}", dtype=dtype,
            kernel=lambda: fastformer_attn.fastformer_attention_fused(*args),
            plain=lambda: fastformer_attn.fastformer_attention_reference(*args),
            library=None,
            bound=bound_ms(nbytes, flops, dtype),
            main=dtype == torch.float32 and what == "train",
            phases=(f"fastformer_{what}",) if dtype == torch.float32 and " " not in what
            else ())


KERNELS = [
    # name, route, source, replaces, cases
    ("mha_fwd", "cuda", "miner_tpu_torch/csrc/mha_fwd.cu",
     "miner_tpu/ops/mha.py:208", mha_cases),
    ("mha_bwd", "cuda", "miner_tpu_torch/csrc/mha_bwd.cu",
     "miner_tpu/ops/mha.py:232", mha_bwd_cases),
    ("add_ln_fwd", "triton", "miner_tpu_torch/ops/add_ln.py",
     "miner_tpu/ops/add_ln.py:122", add_ln_cases),
    ("add_ln_bwd", "cuda", "miner_tpu_torch/csrc/add_ln_bwd.cu",
     "miner_tpu/ops/add_ln.py:144", add_ln_bwd_cases),
    ("poly_attention_fwd", "cuda", "miner_tpu_torch/csrc/poly_attention_fwd.cu",
     "miner_tpu/ops/poly_attention.py:91", poly_cases),
    ("lookup_score_fwd", "cuda", "miner_tpu_torch/csrc/lookup_score_fwd.cu",
     "miner_tpu/ops/lookup_score.py:134", lookup_cases),
    ("fastformer_attn_fwd", "cuda", "miner_tpu_torch/csrc/fastformer_attn_fwd.cu",
     "miner_tpu/ops/fastformer_attn.py:114", ff_cases),
]


def kernel_phase(dev, names=None):
    """Every kernel (of ``names``, default all) against its plain version,
    and timed. Returns the rows of the ``kernels`` line (launches are filled
    in by the main paths) and, per kernel, each case's phases, time and
    bound."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, timed, failures = [], {}, []
    for name, route, source, replaces, cases in KERNELS:
        if names is not None and name not in names:
            continue
        row = None
        timed[name] = []
        for c in cases(dev, g):
            got, want = _outputs(c["kernel"]()), _outputs(c["plain"]())
            torch.cuda.synchronize()
            errs = c.get("errors", output_errors)(got, want, REL_TOL[c["dtype"]])
            worst = max(errs, key=lambda e: e["err"] / e["tol"])
            err, tol = worst["err"], worst["tol"]
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            ok = finite and all(e["err"] <= e["tol"] for e in errs)
            note = ""
            if c.get("check"):
                passed, note = c["check"]()
                ok = ok and passed
                note = f"  {note}"
            call_ms = device_ms(c["kernel"])
            ms = graph_ms(c["kernel"])
            plain_ms = device_ms(c["plain"])
            library_ms = device_ms(c["library"]) if c["library"] else None
            b_ms, b_by = c["bound"]
            timed[name].append(dict(phases=c.get("phases", ()), ms=ms, bound_ms=b_ms))
            log(f"  {name:18s} {c['case']:30s} err {err:.3g} (tol {tol:.3g}) "
                f"{'ok' if ok else 'FAIL'}{note}  kernel {ms:.4f} ms ({call_ms:.4f} "
                f"a call back to back)  plain "
                f"{plain_ms:.4f} ms  library "
                f"{'-' if library_ms is None else f'{library_ms:.4f} ms'}  "
                f"bound {b_ms:.4f} ms ({b_by})")
            yard_ms = graph_ms(c["yardstick"]) if c.get("yardstick") else None
            if yard_ms is not None:
                log(f"    yardstick (index_select + bmm, two calls) {yard_ms:.4f} ms")
            for e in errs:
                if "part" in e:
                    log(f"    {e['part']}: err {e['err']:.3g} (tol {e['tol']:.3g}) at its "
                        f"worst (sequence, head); largest err {e['max_err']:.3g}, "
                        f"RMS {e['rms']:.3g}")
            if not ok:
                failures.append(f"{name} {c['case']}: err {err} tol {tol} "
                                f"finite {finite}{note}")
            if c.get("main"):
                row = {"name": name, "route": route, "source": source,
                       "replaces": replaces, "case": c["case"], "launches": 0,
                       "max_abs_err": max(e["max_err"] for e in errs),
                       "worst_err_over_tol": err / tol, "ms": ms, "call_ms": call_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms}
                if yard_ms is not None:
                    row["yardstick_ms"] = yard_ms
            del got, want
            torch.cuda.empty_cache()
        rows.append(row)
    if failures:
        raise SystemExit("kernel phase failed:\n  " + "\n  ".join(failures))
    return rows, timed


class LaunchCensus:
    """The main path's launches of poly-attention and lookup+score by
    shape and phase: their batch (and candidate count) follows the phase
    and the serving batcher, and their time follows the shape. It reads the
    C arguments each launch passes through ``common.launch`` while
    ``phase`` is set, and launches and counts nothing itself."""

    SHAPE = {"poly_attention_fwd": slice(6, 12),  # B, H, D, P, K, dtype code
             "lookup_score_fwd": slice(4, 11)}  # N, B, C, K, D, cache, interests codes

    def __init__(self):
        import collections

        self.phase = None
        self.counts = collections.Counter()

    def install(self) -> None:
        from miner_tpu_torch.ops import common

        launch = common.launch

        def counted(name, fn, *args):
            if self.phase is not None and name in self.SHAPE:
                self.counts[(name, self.phase, tuple(args[self.SHAPE[name]]))] += 1
            return launch(name, fn, *args)

        common.launch = counted


CENSUS = LaunchCensus()


def census_sweep(dev) -> dict:
    """Every shape the census saw, timed on fresh inputs of that shape:
    per kernel a list of (shape, launches by phase, ms, bound ms)."""
    from miner_tpu_torch.ops import common, lookup_score, poly_attention

    dtypes = {code: dt for dt, code in common.DTYPE_CODES.items()}
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    shapes = {}
    for (name, phase, shape), n in CENSUS.counts.items():
        shapes.setdefault((name, shape), {})[phase] = n
    out = {}
    for (name, shape), by_phase in sorted(shapes.items()):
        if name == "poly_attention_fwd":
            B, H, D, P, K, code = shape
            args = _poly_inputs(dev, g, B, dtypes[code], 0, H, D, P, K)
            fn = lambda: poly_attention.poly_attention_fused(*args)
            (b_ms, _), what = _poly_bound(args), f"{str(dtypes[code])[6:]} B={B}"
        else:
            N, B, C, K, D, code, _ = shape
            args, nbytes = _lookup_inputs(dev, g, N, B, C, K, D, dtypes[code])
            fn = lambda: lookup_score.lookup_score_fused(*args)
            b_ms, _ = bound_ms(nbytes, 2 * B * C * K * D, dtypes[code])
            what = f"{str(dtypes[code])[6:]} B={B} C={C}"
        ms, call_ms = graph_ms(fn), device_ms(fn, 0.05)
        out.setdefault(name, []).append(dict(shape=what, launches_by_phase=by_phase,
                                             ms=ms, call_ms=call_ms, bound_ms=b_ms))
        log(f"  {name:18s} {what:18s} launches {by_phase}  kernel {ms:.4f} ms "
            f"({call_ms:.4f} a call back to back)  bound {b_ms:.4f} ms")
    return out


def launch_weighted_gaps(rows, timed, sweep) -> None:
    """Each row's launches x (time - bound), summed over the shapes its
    launches took: the census's shapes for poly-attention and lookup+score;
    for the others each phase's launches at the cases standing for it."""
    for row in rows:
        name = row["name"]
        if name in sweep:
            row["shapes"] = sweep[name]
            gap = sum(n * (s["ms"] - s["bound_ms"]) for s in sweep[name]
                      for n in s["launches_by_phase"].values())
        else:
            gap = 0.0
            for phase, n in row["launches_by_phase"].items():
                cases = [c for c in timed[name] if phase in c["phases"]]
                if n and not cases:
                    raise SystemExit(f"{name}: no timed case stands for phase {phase}")
                if n:
                    gap += n * sum(c["ms"] - c["bound_ms"] for c in cases) / len(cases)
        row["launch_weighted_gap_ms"] = gap
        log(f"  {name:18s} {row['launches']} launches, launch-weighted gap "
            f"{gap:.3f} ms")


# ------------------------------------------------------------------ serve
CATEGORIES = ["news", "sports", "finance", "lifestyle", "health", "travel",
              "foodanddrink", "weather", "autos", "video", "tv", "music",
              "movies", "entertainment", "kids", "middleeast", "northamerica"]


def write_corpus(root: str, num_news: int, seed: int) -> None:
    """A MIND-format corpus from a seed: titles of 40 words and abstracts of
    160, so the title (32) and sapo (128) token windows are full."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20000)])
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "news.tsv"), "w", encoding="utf-8") as f:
        for i in range(num_news):
            title = " ".join(words[rng.integers(0, len(words), 40)])
            sapo = " ".join(words[rng.integers(0, len(words), 160)])
            f.write(f"N{i}\t{title}\t{CATEGORIES[i % len(CATEGORIES)]}\t{sapo}\n")
    with open(os.path.join(root, "category2id.json"), "w") as f:
        json.dump({"pad": 0, "unk": 1,
                   **{c: i + 2 for i, c in enumerate(CATEGORIES)}}, f)
    with open(os.path.join(root, "user2id.json"), "w") as f:
        json.dump({"unk": 0}, f)


def serve_args(corpus: str, *extra: str):
    """``config/serve_miner.txt`` as it stands, on the synthetic corpus, with
    the hash tokenizer over roberta-base's vocabulary size (no tokenizer
    files here). Its checkpoint and persisted cache are dropped: the caller
    names a checkpoint of the train phase in ``extra``, or none for random
    weights from the seed (the cache persistence is not ported yet)."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", "serve_miner.txt")) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag in ("--saved_model_path", "--serve_cache_path"):
        i = words.index(flag)
        del words[i:i + 2]
    return make_parser().parse_args([
        "serve", *words, "--pretrained_tokenizer", "hash:50265",
        "--user2id_path", os.path.join(corpus, "user2id.json"),
        "--category2id_path", os.path.join(corpus, "category2id.json"),
        "--eval_news_path", os.path.join(corpus, "news.tsv"),
        "--port", "0", *extra])


def _post(url: str, payload: dict):
    import urllib.request

    req = urllib.request.Request(url + "/score", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def _check_launches(phase: str, counts: dict) -> None:
    """Fail the phase unless it launched every kernel it must (and none it
    must not)."""
    missing = [k for k in REQUIRED[phase] if counts[k] == 0]
    extra = [k for k in FORBIDDEN.get(phase, ()) if counts[k] != 0]
    if missing or extra:
        raise SystemExit(f"{phase} phase: the path never launched {missing}; "
                         f"launched what it must not {extra}")


def serve_phase(corpus: str, checkpoint: str, phase: str = "serve",
                n_slate: int = 64, n_topk: int = 8) -> dict:
    """The serving path: ``serve``'s own pieces (service with its corpus
    cache, warm-up, HTTP server) on a train phase's ``finalModel``
    (``--saved_model_path``, loaded strictly), answering concurrent slate and
    top-k requests; ``phase`` "fastformer_serve" serves the Fastformer
    (``--model_name fastformer``). Returns the launch counts of the run."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.parallel.news_cache import CacheFiller
    from miner_tpu_torch.serving import ScoringService, make_http_server
    from miner_tpu_torch.training.trainer import Trainer

    family = ("--model_name", "fastformer") if phase == "fastformer_serve" else ()
    args = serve_args(corpus, "--saved_model_path", checkpoint, *family)
    reset_launch_counts()
    CENSUS.phase = phase
    t0 = time.perf_counter()
    service = ScoringService(Trainer(args))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = service.warmup(args.serve_warmup_slates, topk=args.serve_warmup_topk)
    warmup_s = time.perf_counter() - t0
    server = make_http_server(service, args.host, args.port, args.serve_http_impl)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{server.server_address[1]}"
    rng = np.random.default_rng(1)
    ids = [f"N{i}" for i in range(NUM_NEWS)]
    reqs = []
    for i in range(n_slate + n_topk):
        history = list(rng.choice(ids, int(rng.integers(5, 61)), replace=False))
        if i < n_slate:
            reqs.append({"history": history,
                         "candidates": list(rng.choice(ids, 10, replace=False))})
        else:
            reqs.append({"history": history, "candidates": None, "topk": 10})
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            replies = list(pool.map(lambda r: _post(url, r), reqs))
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        CENSUS.phase = None
        server.shutdown()
        service.close()
        thread.join(timeout=10)
    for req, (status, body, _) in zip(reqs, replies):
        scores = [s for _, s in body["results"]]
        want = len(req["candidates"]) if req["candidates"] else req["topk"]
        if (status != 200 or len(scores) != want or not all(map(math.isfinite, scores))
                or scores != sorted(scores, reverse=True)):
            raise SystemExit(f"{phase} phase: bad reply {status} {body}")
    lat = sorted(t for _, _, t in replies)
    t0 = time.perf_counter()
    ctx = service.ctx
    CacheFiller(ctx.model.encode_news).fill(ctx.table)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    distinct = torch.unique(ctx.cache.embeddings.float(), dim=0).shape[0]
    log(f"{phase}: {args.model_name}, {ctx.store.num_news - 1} news, "
        f"{args.plm_preset} towers restored from "
        f"{os.path.relpath(checkpoint, corpus)}, {ctx.cache.embeddings.dtype} "
        f"cache of {distinct} distinct rows; startup {startup_s:.2f} s (tokenize, "
        f"init, corpus cache), warm cache refill {fill_s:.2f} s; {warmed} warm-up "
        f"calls {warmup_s:.2f} s")
    log(f"{phase}: {len(reqs)} requests ({n_slate} slates of 10, {n_topk} corpus "
        f"top-10), 16 clients: {len(reqs) / wall_s:.1f} req/s, p50 "
        f"{1e3 * lat[len(lat) // 2]:.1f} ms, max {1e3 * lat[-1]:.1f} ms "
        f"({len(lat)} samples, too few for a p99), "
        f"{service.batcher.stats()['mean_batch']} requests per device call "
        f"on {torch.cuda.get_device_name(0)}")
    log(f"{phase}: kernel launches on the path {counts}")
    _check_launches(phase, counts)
    return counts


# ------------------------------------------------------------------ train
TRAIN_IMPRESSIONS, EVAL_IMPRESSIONS, IMPRESSION_SIZE = 256, 128, 20


def write_behaviors(root: str, num_news: int, seed: int) -> None:
    """MIND-format behaviors over the corpus of ``write_corpus``: 256 train
    impressions of 50 clicks and 20 entries with one positive (so one epoch
    of ``train_miner.txt`` is 16 micro-batches of 16), and 128 eval
    impressions of 50 clicks and 20 entries with two positives."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for split, n, positives in (("train", TRAIN_IMPRESSIONS, 1),
                                ("valid", EVAL_IMPRESSIONS, 2)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "behaviors.tsv"), "w") as f:
            for line in range(n):
                news = rng.choice(num_news, HIS + IMPRESSION_SIZE, replace=False)
                his = " ".join(f"N{i}" for i in news[:HIS])
                beh = " ".join(f"N{i}-{int(j < positives)}"
                               for j, i in enumerate(news[HIS:]))
                f.write(f"{line}\tU{line % 97}\t11/11/2019 9:05:58 AM\t{his}\t{beh}\n")


# the training configurations as their files name their subcommands
TRAIN_CONFIGS = {"miner": ("train", "train_miner.txt"),
                 "fastformer": ("train_fastformer", "train_fastformer.txt")}


def train_args(corpus: str, out: str, *extra: str, family: str = "miner"):
    """``config/train_miner.txt`` (or, for ``family`` "fastformer",
    ``config/train_fastformer.txt`` under ``train_fastformer``) as it
    stands, on the synthetic corpus and behaviors, with the hash tokenizer
    over roberta-base's vocabulary (no tokenizer files here), random init,
    and one epoch."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    mode, config = TRAIN_CONFIGS[family]
    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", config)) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag, value in (
            ("--pretrained_tokenizer", "hash:50265"),
            ("--user2id_path", os.path.join(corpus, "user2id.json")),
            ("--category2id_path", os.path.join(corpus, "category2id.json")),
            ("--train_behaviors_path", os.path.join(corpus, "train", "behaviors.tsv")),
            ("--train_news_path", os.path.join(corpus, "news.tsv")),
            ("--eval_behaviors_path", os.path.join(corpus, "valid", "behaviors.tsv")),
            ("--eval_news_path", os.path.join(corpus, "news.tsv")),
            ("--num_train_epochs", "1")):
        words[words.index(flag) + 1] = value
    return make_parser().parse_args([mode, *words, "--train_path",
                                     os.path.join(out, family), *extra])


def train_phase(corpus: str, out: str, family: str = "miner"):
    """The training path: ``Trainer(args).train()`` of a full-width
    configuration for one epoch of 16 micro-batches, i.e. 2 optimizer
    updates, then its end-of-epoch cached eval and checkpoints.
    ``train_miner.txt``: roberta-base towers, bf16 compute, fp32 masters,
    dropout 0.1 in the PLM and 0.2 elsewhere, --remat, accumulation 8.
    ``train_fastformer.txt``: the same towers frozen (--freeze_transformer)
    under a 2-layer Fastformer user encoder in fp32; its PLM parameters must
    come out bit-identical. Returns the launch counts of the micro-batches
    and of the eval, and the finalModel checkpoint."""
    import csv

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training import checkpoint
    from miner_tpu_torch.training.trainer import Trainer

    phase = "train" if family == "miner" else f"{family}_train"
    eval_phase = phase.replace("train", "eval")
    args = train_args(corpus, out, family=family)
    trainer = Trainer(args)
    step_s, step_loss, eval_s, before_eval = [], [], [], {}
    held, after_fwd = [], []  # GiB allocated at each micro-batch's start, after its forward
    train_step, run_eval = trainer.train_step, trainer._run_eval
    apply_and_loss = trainer._apply_and_loss

    def measured_forward(*a, **k):
        out = apply_and_loss(*a, **k)
        after_fwd.append(torch.cuda.memory_allocated() / 2 ** 30)
        return out

    def timed_step(*a, **k):
        held.append(torch.cuda.memory_allocated() / 2 ** 30)
        t0 = time.perf_counter()
        loss = train_step(*a, **k)
        step_loss.append(float(loss))  # synchronises
        step_s.append(time.perf_counter() - t0)
        return loss

    def timed_eval(*a, **k):
        before_eval.update(launch_counts())
        CENSUS.phase = eval_phase
        t0 = time.perf_counter()
        out = run_eval(*a, **k)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
        CENSUS.phase = phase
        return out

    trainer.train_step, trainer._run_eval = timed_step, timed_eval
    trainer._apply_and_loss = measured_forward
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    CENSUS.phase = phase
    t0 = time.perf_counter()
    try:
        run = trainer.train()
        torch.cuda.synchronize()
    finally:
        CENSUS.phase = None
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    eval_counts = {k: counts[k] - before_eval[k] for k in counts}
    with open(os.path.join(run.run_dir, "eval.csv")) as f:
        evals = list(csv.DictReader(f))
    # the loss column is empty under train_miner.txt's --evaluation_info metrics
    metrics = {k: float(v) for k, v in evals[-1].items()
               if k not in ("epoch", "step") and v != ""}
    steady = sorted(step_s[1:])
    mid = steady[len(steady) // 2]
    log(f"{phase}: {args.model_name}, {len(step_s)} micro-batches of "
        f"{args.train_batch_size} "
        f"({args.train_batch_size * (args.npratio + 1 + args.his_length)} news "
        f"per micro-batch), {run.optimizer.updates} optimizer updates at "
        f"accumulation {args.gradient_accumulation_steps}, {args.compute_dtype}, "
        f"--remat {args.remat}, --freeze_transformer {args.freeze_transformer}, "
        f"dropout {args.dropout} / {TRAIN_RATE}")
    log(f"{phase}: micro-batch {1e3 * mid:.1f} ms median of {len(steady)} "
        f"(first {1e3 * step_s[0]:.1f} ms, with kernel compiles), "
        f"{args.train_batch_size / mid:.2f} examples/s, "
        f"{1 / (mid * args.gradient_accumulation_steps):.3f} updates/s; "
        f"eval {eval_s[0]:.2f} s; whole train() {wall_s:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
        f"{torch.cuda.get_device_name(0)}")
    log(f"{phase}: device memory of the last micro-batch: {held[-1]:.2f} GiB held "
        f"at its start (weights, optimizer state, gradient sums), "
        f"{after_fwd[len(held) - 1]:.2f} GiB after its forward (the forwards "
        f"of the eval, if any, come later)")
    log(f"{phase}: losses {[round(x, 4) for x in step_loss]}")
    log(f"{phase}: eval {metrics}")
    per_batch = {k: before_eval[k] / len(step_s) for k in before_eval}
    log(f"{phase}: kernel launches per micro-batch {per_batch}; in the eval "
        f"{eval_counts}")
    bad = [x for x in step_loss + list(metrics.values()) if not math.isfinite(x)]
    if bad or run.optimizer.updates != 2 or len(step_s) != 16:
        raise SystemExit(f"{phase} phase: non-finite {bad}, {run.optimizer.updates} "
                         f"updates, {len(step_s)} micro-batches")
    _check_launches(phase, before_eval)
    _check_launches(eval_phase, eval_counts)
    final = os.path.join(run.run_dir, "ckpt", "finalModel")
    if args.freeze_transformer:
        initial = trainer.build_model().state_dict()
        saved = checkpoint.load(final)["params"]
        plm = [k for k in initial if k.startswith("news_encoder.plm.")]
        moved = [k for k in plm if not torch.equal(saved[k].cpu(), initial[k])]
        log(f"{phase}: {len(plm) - len(moved)} of {len(plm)} PLM tensors of the "
            "finalModel bit-identical to their initial values (frozen)")
        if moved or not plm:
            raise SystemExit(f"{phase} phase: frozen PLM parameters moved: {moved[:5]}")
    return {phase: before_eval, eval_phase: eval_counts}, final


def train_parity_phase(corpus: str, out: str, family: str = "miner") -> None:
    """One micro-batch of one impression (55 news) through the full-width
    model in float32 with dropout off, on the card (kernels, their autograd
    Functions) and on the CPU (plain versions), same weights from the seed:
    the loss and every trainable parameter's gradient must agree (the
    Fastformer's PLM is frozen, as ``--freeze_transformer`` makes it in
    training). Tolerance: 1e-3 of each gradient's largest magnitude plus
    1e-5 of the largest over all gradients, since float32 sums through 12
    layers forward and back are taken in other orders by the kernels and
    cuBLAS than by the plain versions and the CPU's BLAS, and a gradient
    that is a small difference of large terms (the target-aware
    projection's, 1e-7 at random init) carries the absolute rounding of
    those terms."""
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.training.trainer import Trainer

    result = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(train_args(corpus, out, "--compute_dtype", "float32",
                                     "--device", device, family=family))
        a = trainer.args
        store = trainer._load_store(a.train_news_path)
        block = OnlineSampler(trainer._load_log(a.train_behaviors_path, store),
                              store, a.npratio, seed=a.seed).sample_epoch(0)
        batch = {"cand_idx": block.cand[:1], "his_idx": block.his[:1],
                 "label": block.label[:1]}
        model = trainer.build_model().to(trainer.device).eval()
        if a.freeze_transformer:
            model.news_encoder.plm.requires_grad_(False)
        loss, _ = trainer._apply_and_loss(model, trainer._make_table(store), batch, True)
        loss.backward()
        result[device] = (float(loss.detach()), {n: p.grad.float().cpu()
                                        for n, p in model.named_parameters()
                                        if p.requires_grad})
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = result["cuda"], result["cpu"]
    overall = max(g.abs().max().item() for g in grads_cpu.values())
    worst, failed = (0.0, ""), []
    for name, want in grads_cpu.items():
        err = (grads_gpu[name] - want).abs().max().item()
        tol = 1e-3 * want.abs().max().item() + 1e-5 * overall
        if err > tol:
            failed.append(f"{name}: err {err:.3g} tol {tol:.3g}")
        if err / tol > worst[0]:
            worst = (err / tol, name)
    log(f"train parity ({family}): loss card {loss_gpu:.6f} CPU {loss_cpu:.6f}; "
        f"largest gradient magnitude {overall:.3g}; worst err / tol "
        f"{worst[0]:.3g} ({worst[1]}) over {len(grads_cpu)} tensors")
    if failed or abs(loss_gpu - loss_cpu) > 1e-4 * max(1.0, abs(loss_cpu)):
        raise SystemExit(f"train parity phase ({family}) failed:\n  "
                         + "\n  ".join(failed))


# ----------------------------------------------------------------- parity
def parity_phase(corpus: str) -> None:
    """The full-width model in float32 on the card (kernels) and on the CPU
    (plain versions), same weights from the seed: cache rows and one request
    batch's scores must agree. Tolerance 1e-3 of the values' scale: float32
    through 12 layers, summed in other orders by the kernels and cuBLAS than
    by the plain versions and the CPU's BLAS."""
    import numpy as np

    from miner_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(2)
    cand = np.zeros((4, 16), np.int32)
    cand[:, :10] = rng.integers(1, 65, (4, 10))
    his = rng.integers(0, 65, (4, HIS)).astype(np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(serve_args(corpus, "--compute_dtype", "float32",
                                     "--device", device))
        ctx = trainer.serving_context()
        out[device] = (ctx.cache.embeddings.float().cpu().numpy(),
                       trainer.serve_scores(ctx.model, ctx.cache, cand, his))
    for what, i in (("cache rows", 0), ("scores", 1)):
        got, want = out["cuda"][i], out["cpu"][i]
        err = float(np.abs(got - want).max())
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        log(f"parity: {what} {got.shape} card vs CPU max abs err {err:.3g} "
            f"(tol {tol:.3g})")
        if not (np.isfinite(got).all() and err <= tol):
            raise SystemExit(f"parity phase: {what} disagree ({err} > {tol})")


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", help="comma-separated kernel names: build and run "
                        "only their kernel phase, print their rows and stop")
    parser.add_argument("--package", help="with --kernels: import miner_tpu_torch from "
                        "this directory (an unpacked other commit), to time its kernels "
                        "on the same card in the same session")
    opts = parser.parse_args(argv)
    if opts.package and not opts.kernels:
        parser.error("--package needs --kernels")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    if opts.package:
        sys.path.insert(0, os.path.abspath(opts.package))
    import miner_tpu_torch
    from miner_tpu_torch.ops import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; package {os.path.dirname(miner_tpu_torch.__file__)}")

    names = opts.kernels.split(",") if opts.kernels else None
    t0 = time.perf_counter()
    reports = common.build(common.CUDA_SOURCES if names is None
                           else [n for n in common.CUDA_SOURCES if n in names])
    log(f"build: {len(reports)} CUDA libraries in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        # each kernel's registers, spills and shared memory; for the kernels
        # built in several variants also the entry each line belongs to
        keys = ("registers", "spill") + (("Compiling entry",) if name in ENTRY_REPORTS else ())
        for line in report.splitlines():
            if any(k in line for k in keys):
                log(f"  {name}: {line.strip()}")

    log("kernels (kernel vs plain version on the same inputs):")
    rows, timed = kernel_phase(dev, names)
    # cuBLAS keeps a workspace for each stream it ran on: the yardstick's bmm
    # on graph_ms's capture streams left one each, which would count in the
    # train phases' peaks
    torch._C._cuda_clearCublasWorkspaces()
    log(f"device memory still allocated after the kernel phase: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    if names:
        print(smi)
        print(json.dumps({"kernels": rows}))
        return 0

    import tempfile

    CENSUS.install()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        write_corpus(corpus, NUM_NEWS, seed=0)
        write_behaviors(corpus, NUM_NEWS, seed=3)
        counts, final_model = train_phase(corpus, tmp)
        counts["serve"] = serve_phase(corpus, final_model)
        ff_counts, ff_model = train_phase(corpus, tmp, "fastformer")
        counts.update(ff_counts)
        counts["fastformer_serve"] = serve_phase(corpus, ff_model, "fastformer_serve")
        write_corpus(os.path.join(tmp, "parity"), 64, seed=1)
        parity_phase(os.path.join(tmp, "parity"))
        for family in TRAIN_CONFIGS:
            train_parity_phase(corpus, tmp, family)
    for row in rows:
        row["launches_by_phase"] = {phase: c[row["name"]] for phase, c in counts.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
    log("the main path's shapes of poly-attention and lookup+score, timed:")
    sweep = census_sweep(dev)
    log("launch-weighted gaps, launches x (time - bound) over the shapes launched:")
    launch_weighted_gaps(rows, timed, sweep)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
