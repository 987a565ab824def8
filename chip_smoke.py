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
   so that the dropout's share of the time shows, and in fp32, and a
   ``pretrain_miner.txt`` micro-batch; the add_ln backward also in fp32;
   poly-attention at the train, serve and eval batches, in fp32, and with a
   quarter of its rows fully masked; lookup+score at a slate (with
   candidates in [-N, 0): wrapped, and outside [-N, N): NaN), the
   whole-corpus top-k and an eval batch, in bf16 and fp32, and the top-k
   over a cache of MIND's size, then its int8 route at the same shapes with
   bf16 and fp32 interests; Fastformer attention at the train, eval and
   serve batches, in fp32 as those paths give it, and in bf16; mha and
   add_ln at UnBERT's shapes: 300-token rows and 23-sentence news
   sequences of a micro-batch (16), an eval batch (64) and the largest
   serving call (512); mha and add_ln at UniSRec's pre-concatenated titles
   of 159 tokens: a micro-batch's 880 with dropout (the backward kernels
   too), a cache-fill chunk's 512 and an eval batch's 64 without)
   against its plain PyTorch version on the same inputs (the tolerance is
   printed beside the error; the mha backward's dq, dk and dv each at the
   scale of its (sequence, head)'s gradient; with dropout the kernel's
   mask must equal the plain version's bit for bit), and is timed with
   CUDA events beside the plain
   version, the one PyTorch call computing the same function where there
   is one (for lookup+score, which has none, the calls index_select and
   bmm, for int8 rows with the cast and the scales' product, as a
   yardstick), and its bound on an H100 SXM (3.35 TB/s; 989
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
   serve cache: ``serve_miner.txt`` with its ``--serve_cache_path`` (in
   the temporary directory) started twice on that ``finalModel``: the
   first start encodes the corpus and persists it, the second loads the
   file, launches no PLM kernel, holds the same cache bit for bit and
   answers the same requests (one at a time) with the same replies bit for
   bit; then the same with ``--serve_cache_int8`` (the int8 route of
   lookup+score), its bytes against bf16's and both start-up times printed.
   pretrain: ``config/pretrain_miner.txt`` at full width (the news encoder
   alone over the positive, its 3 augmented variants and 4 negatives:
   128 news a micro-batch; bf16, --remat, dropout) for one epoch of 16
   updates and its eval, the contrastive loss summed: mha and add_ln
   forward and backward launched, no poly-attention, lookup+score or
   Fastformer kernel; finite losses; ``bestLossModel`` and ``finalModel``
   written.
   warm start: ``config/train_miner_hard.txt`` (hard augmentation mode)
   with ``--pretrained_model_path`` set to that ``finalModel`` and
   ``--learning_rate 0`` for one epoch: every Miner kernel launched, and
   the ``finalModel``'s news encoder equal to the pretrained one bit for
   bit.
5. Fastformer train: the same for ``config/train_fastformer.txt`` (the
   Fastformer user encoder over the same towers, frozen with
   ``--freeze_transformer``). The micro-batches and the eval must launch
   mha_fwd, add_ln_fwd and fastformer_attn_fwd, the backward kernels never
   (nothing differentiates through the frozen PLM), and every PLM parameter
   of the ``finalModel`` must equal its initial value bit for bit.
6. Fastformer serve: ``serve_miner.txt`` with ``--model_name fastformer``
   restores that ``finalModel`` and answers over HTTP, launching mha_fwd,
   add_ln_fwd (cache fill) and fastformer_attn_fwd.
7. UnBERT train: ``config/train_unbert.txt`` (under ``train_fastformer``;
   bert-base word and news towers, the hash tokenizer over bert-base's
   vocabulary, bf16, dropout, accumulation 8) for one epoch: 1,280 packed
   rows of 300 tokens (5 visits of each of the 256 impressions), 80
   micro-batches, 10 updates, and its end-of-epoch eval over 2,560 packed
   eval rows. mha and add_ln forward and backward launched, never
   poly-attention, lookup+score or Fastformer attention. The host's
   packing time is printed.
   UnBERT eval: standalone ``eval_fastformer`` of its ``bestAucModel`` at
   the train config's geometry must give the train run's auc bit for bit;
   ``config/eval_unbert.txt`` as shipped must give finite metrics.
   UnBERT serve: ``config/serve_unbert.txt`` on its ``finalModel``: the
   warm-up reaches 32 slates of bucket 16, 512 packed rows a call; 64
   slates of 10 from 16 clients over HTTP; a whole-corpus request and a
   slate above ``--serve_max_slate`` are refused (400).
8. UniSRec train: ``config/train_unisrec.txt`` (under ``train_fastformer``;
   bert-base over pre-concatenated titles of 159 tokens, the MoE adaptor
   alone trains, bf16, --remat) for one epoch: 16 micro-batches of one
   tower call over 880 news, 12 mha_fwd and 24 add_ln_fwd launches each,
   no backward kernel, every non-MoE tensor of the ``finalModel``
   bit-identical to its initial value; its cached eval.
   UniSRec serve: ``serve_miner.txt`` with ``SERVE_FLAGS["unisrec_serve"]``
   on that ``finalModel`` over HTTP, then started twice from a persisted
   cache, bf16 and int8, as the Miner's (the loaded starts launch nothing).
   UniSRec train_all: the same config with ``--unisrec_train_all`` and
   accumulation 8 (2 updates): both backward kernels at L = 159.
   hf_import: the config with ``--hf_checkpoint`` (a bert-base
   ``pytorch_model.bin`` of HF key names) and ``--unisrec_pretrained_path``
   (a RecBole-layout ``.pth``), both written from a seed: every grafted
   tensor on the card equal to the file's, one micro-batch finite.
9. parity: the full-width Miner in float32 over 64 news, on the card
   through the kernels and on the CPU through the plain versions; the cache
   rows and the scores of one request batch must agree.
10. train parity, Miner, Fastformer, UnBERT and UniSRec: one micro-batch of
   one impression (UnBERT: two packed rows) in float32, dropout off, on the
   card and on the CPU: the loss and every trainable parameter's gradient
   must agree (UniSRec with ``--unisrec_train_all``, so the tower's too);
   for UnBERT also the serving scores of two slates.

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
# config/pretrain_miner.txt: batch 16 of the positive, its 3 augmented
# variants and 4 negatives: 128 sequences per field per micro-batch
PRETRAIN_N = 16 * 8
TRAIN_RATE = 0.1  # hidden_dropout and attention_dropout of the PLM
# which phases' launches a kernel case stands for, in the launch-weighted
# gap (launches x (time - bound)): a phase's launches are split evenly over
# its cases (titles and sapos launch equally often; the cache fill's chunks
# are taken as full, and the pretrain eval's 256 sequences a call as a
# chunk of 512). Poly-attention and lookup+score are counted shape by
# shape instead (LaunchCensus).
TRAIN_PHASES = ("train", "fastformer_train", "warm_start")  # 880 sequences a micro-batch
BWD_PHASES = ("train", "warm_start", "pretrain")  # the phases that differentiate the PLM
FILL_PHASES = ("eval", "serve", "fastformer_eval", "fastformer_serve", "warm_start_eval",
               "pretrain_eval", "serve_cache", "serve_int8")
# the mha kernels' training cases (N, L, dropout rate, dtype, phases): the
# sapo shape with dropout (the main path's), without it (Philox's share), in
# fp32 (--compute_dtype float32, the CUDA-core kernels); the title shape;
# the pretrain micro-batch's two shapes
TRAIN_MHA_CASES = ((TRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.bfloat16, TRAIN_PHASES),
                   (TRAIN_N, TRAIN_SAPO, 0.0, torch.bfloat16, ()),
                   (TRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.float32, ()),
                   (TRAIN_N, TRAIN_TITLE, TRAIN_RATE, torch.bfloat16, TRAIN_PHASES),
                   (PRETRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.bfloat16, ("pretrain",)),
                   (PRETRAIN_N, TRAIN_TITLE, TRAIN_RATE, torch.bfloat16, ("pretrain",)))
# UnBERT (config/train_unbert.txt, eval_unbert.txt, serve_unbert.txt): packed
# rows of 300 tokens at the word level, 3 + 20 sentences at the news level;
# 16 rows a micro-batch, 64 an eval batch, up to 32 x 16 = 512 a serving call
UNBERT_WORD, UNBERT_NEWS = 300, 23
UNBERT_TRAIN_B, UNBERT_EVAL_B, UNBERT_SERVE_B = 16, 64, 512
UNBERT_INFER_PHASES = ("unbert_eval", "unbert_eval_standalone", "unbert_serve")
# the mha cases at UnBERT's shapes (N, L, dropout rate, dtype, phases): the
# micro-batch's two levels with dropout, an eval batch (taken for the
# serving calls too, whose batch follows the traffic) and the warm-up's
# largest serving call
UNBERT_MHA_CASES = tuple(
    (N, L, rate, torch.bfloat16, phases)
    for N, rate, phases in ((UNBERT_TRAIN_B, TRAIN_RATE, ("unbert_train",)),
                            (UNBERT_EVAL_B, 0.0, UNBERT_INFER_PHASES),
                            (UNBERT_SERVE_B, 0.0, ()))
    for L in (UNBERT_WORD, UNBERT_NEWS))
# UniSRec (config/train_unisrec.txt): bert-base over pre-concatenated titles,
# title + sapo[1:] = 32 + 128 - 1 = 159 tokens, the train micro-batch's 880
# news at once (one tower call); the cache fill's chunks of 512 at serving
# and eval, and an eval batch's 64
UNISREC_L = TRAIN_TITLE + TRAIN_SAPO - 1
UNISREC_TRAIN_PHASES = ("unisrec_train", "unisrec_train_all")
UNISREC_FILL_PHASES = ("unisrec_eval", "unisrec_train_all_eval", "unisrec_serve",
                       "unisrec_serve_cache", "unisrec_serve_int8")
UNISREC_MHA_CASES = ((TRAIN_N, UNISREC_L, TRAIN_RATE, torch.bfloat16, UNISREC_TRAIN_PHASES),
                     (CHUNK, UNISREC_L, 0.0, torch.bfloat16, UNISREC_FILL_PHASES),
                     (64, UNISREC_L, 0.0, torch.bfloat16, ()))
FF_HEADS = 16  # the Fastformer of word_embed_dim 256 (trainer: 16 if D % 16 == 0)
TRAIN_B, EVAL_B = 16, 64  # train_fastformer.txt's train and eval batches
# the kernels each phase of the main path must launch (and, for the frozen
# Fastformer training, must not)
MINER_KERNELS = ("mha_fwd", "add_ln_fwd", "poly_attention_fwd")
FF_KERNELS = ("mha_fwd", "add_ln_fwd", "fastformer_attn_fwd")
PLM_FWD, PLM_BWD = ("mha_fwd", "add_ln_fwd"), ("mha_bwd", "add_ln_bwd")
TAIL_KERNELS = ("poly_attention_fwd", "lookup_score_fwd", "fastformer_attn_fwd")
SERVE_KERNELS = MINER_KERNELS + ("lookup_score_fwd",)
REQUIRED = {
    "train": MINER_KERNELS + PLM_BWD,
    "eval": SERVE_KERNELS,
    "serve": SERVE_KERNELS,
    "serve_cache": SERVE_KERNELS,  # fills the cache and persists it
    "serve_cache_loaded": ("poly_attention_fwd", "lookup_score_fwd"),
    "serve_int8": SERVE_KERNELS,
    "serve_int8_loaded": ("poly_attention_fwd", "lookup_score_fwd"),
    "pretrain": PLM_FWD + PLM_BWD,
    "pretrain_eval": PLM_FWD,
    "warm_start": MINER_KERNELS + PLM_BWD,
    "warm_start_eval": SERVE_KERNELS,
    "fastformer_train": FF_KERNELS,
    "fastformer_eval": FF_KERNELS,
    "fastformer_serve": FF_KERNELS,
    "unbert_train": PLM_FWD + PLM_BWD,
    "unbert_eval": PLM_FWD,
    "unbert_eval_standalone": PLM_FWD,
    "unbert_serve": PLM_FWD,
    # UniSRec: the MoE-only freeze runs the PLM forward alone; the tail is
    # plain products, so a loaded cache launches nothing
    "unisrec_train": PLM_FWD,
    "unisrec_eval": PLM_FWD,
    "unisrec_train_all": PLM_FWD + PLM_BWD,
    "unisrec_train_all_eval": PLM_FWD,
    "unisrec_serve": PLM_FWD,
    "unisrec_serve_cache": PLM_FWD,
    "unisrec_serve_cache_loaded": (),
    "unisrec_serve_int8": PLM_FWD,
    "unisrec_serve_int8_loaded": (),
}
FORBIDDEN = {"fastformer_train": PLM_BWD,
             "serve_cache_loaded": PLM_FWD,  # the cache comes from the file
             "serve_int8_loaded": PLM_FWD,
             "pretrain": TAIL_KERNELS,  # the news encoder alone
             "pretrain_eval": TAIL_KERNELS + PLM_BWD,
             # the cross-encoder: the PLM kernels alone
             "unbert_train": TAIL_KERNELS,
             **{phase: TAIL_KERNELS + PLM_BWD for phase in UNBERT_INFER_PHASES},
             "unisrec_train": TAIL_KERNELS + PLM_BWD,  # no backward through the PLM
             "unisrec_train_all": TAIL_KERNELS,
             **{phase: TAIL_KERNELS + PLM_BWD for phase in UNISREC_FILL_PHASES},
             **{f"unisrec_serve_{c}_loaded": TAIL_KERNELS + PLM_FWD + PLM_BWD
                for c in ("cache", "int8")}}
# the libraries whose ptxas report names each entry (kernels built in
# several variants)
ENTRY_REPORTS = ("mha_fwd", "mha_bwd", "add_ln_bwd", "poly_attention_fwd",
                 "lookup_score_fwd", "fastformer_attn_fwd")
# MIND (Wu et al., ACL 2020) counts 161,013 news: a cache of 161,014 rows
# (row 0 the padding), and the corpus top-k's candidate bucket over it
MIND_NEWS = 161013
# the augmented news variants config/pretrain_miner.txt loads (the other
# training configs take a subset of them)
AUGMENTATIONS = ("changed_topic_text", "enhanced_text", "semi_enhanced_text")


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
    for N, L, rate, dtype, phases in TRAIN_MHA_CASES:
        seed = 2 ** 40 + L
        qkv, mask = _mha_inputs(dev, g, N, L, dtype)
        q, k, v = qkv.view(N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(N, L, HIDDEN, dtype=dtype, device=dev)
        stats = torch.empty(N, HEADS, L, 2, device=dev)
        flops = 4 * N * HEADS * L * L * (HIDDEN // HEADS)
        yield dict(
            case=f"{str(dtype)[6:]} N={N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, True)[0],
            plain=lambda: mha.mha_reference(qkv, mask, HEADS, 1, rate, seed),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=rate),
            check=(lambda: mha_dropout_mask_check(qkv, mask, seed)) if rate else None,
            bound=bound_ms(_nbytes(qkv, mask, out, stats), flops, dtype),
            main=N == TRAIN_N and L == TRAIN_SAPO and rate > 0 and dtype == torch.bfloat16,
            phases=phases)
    # UnBERT's shapes: training writes the softmax statistics for its
    # backward; eval and serving (inference mode) do not
    for N, L, rate, dtype, phases in UNBERT_MHA_CASES:
        seed, train = 2 ** 44 + L, rate > 0
        qkv, mask = _mha_inputs(dev, g, N, L, dtype)
        q, k, v = qkv.view(N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(N, L, HIDDEN, dtype=dtype, device=dev)
        stats = torch.empty(N, HEADS, L, 2, device=dev) if train else out[:0]
        yield dict(
            case=f"unbert bf16 N={N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, train)[0],
            plain=lambda: mha.mha_reference(qkv, mask, HEADS, 1, rate, seed),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=rate),
            check=(lambda: mha_dropout_mask_check(qkv, mask, seed)) if rate else None,
            bound=bound_ms(_nbytes(qkv, mask, out, stats),
                           4 * N * HEADS * L * L * (HIDDEN // HEADS), dtype),
            phases=phases)
    # UniSRec's pre-concatenated titles, L = 159: a second query tile of 31
    # rows and a third key tile of 31 keys; the micro-batch with dropout (and
    # the statistics), the cache fill's chunk and an eval batch without
    for N, L, rate, dtype, phases in UNISREC_MHA_CASES:
        seed, train = 2 ** 46 + N, rate > 0
        qkv, mask = _mha_inputs(dev, g, N, L, dtype)
        q, k, v = qkv.view(N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(N, L, HIDDEN, dtype=dtype, device=dev)
        stats = torch.empty(N, HEADS, L, 2, device=dev) if train else out[:0]
        yield dict(
            case=f"unisrec bf16 N={N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, train)[0],
            plain=lambda: mha.mha_reference(qkv, mask, HEADS, 1, rate, seed),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=rate),
            check=(lambda: mha_dropout_mask_check(qkv, mask, seed)) if rate else None,
            bound=bound_ms(_nbytes(qkv, mask, out, stats),
                           4 * N * HEADS * L * L * (HIDDEN // HEADS), dtype),
            phases=phases)


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

    for N, L, rate, dtype, phases in TRAIN_MHA_CASES + tuple(
            c for c in UNBERT_MHA_CASES + UNISREC_MHA_CASES if c[2] > 0):
        seed = 2 ** 41 + L
        qkv, mask = _mha_inputs(dev, g, N, L, dtype)
        dout = torch.randn(N, L, HIDDEN, device=dev, generator=g).to(dtype)
        out, stats = mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, True)
        leaves = _sdpa_leaves(qkv)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask.bool()[:, None, None, :], dropout_p=rate)
        sdpa_dout = dout.view(N, L, HEADS, -1).transpose(1, 2)
        flops = 5 * 2 * N * HEADS * L * L * (HIDDEN // HEADS)
        yield dict(
            case=f"{str(dtype)[6:]} N={N} L={L} dropout {rate}", dtype=dtype,
            kernel=lambda: mha.mha_backward(qkv, mask, dout, HEADS, rate, seed, 1,
                                            out, stats),
            plain=lambda: mha.mha_backward_reference(qkv, mask, dout, HEADS, 1,
                                                     rate, seed),
            library=lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                retain_graph=True),
            errors=mha_grad_errors,
            # reads qkv, out, dout, stats and mask; writes dqkv
            bound=bound_ms(_nbytes(qkv, out, dout, stats, mask, qkv), flops, dtype),
            main=N == TRAIN_N and L == TRAIN_SAPO and rate > 0 and dtype == torch.bfloat16,
            phases=tuple(p for p in phases
                         if p in BWD_PHASES + ("unbert_train", "unisrec_train_all")))


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
    for N, L in ((TRAIN_N, TRAIN_SAPO), (TRAIN_N, TRAIN_TITLE), (PRETRAIN_N, TRAIN_SAPO),
                 (PRETRAIN_N, TRAIN_TITLE)):
        T, dtype, seed = N * L, torch.bfloat16, 2 ** 42 + L
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
            main=N == TRAIN_N and L == TRAIN_SAPO,
            phases=TRAIN_PHASES if N == TRAIN_N else ("pretrain",))
    # UnBERT's rows: a micro-batch's two levels with dropout, an eval batch's
    # (standing for the serving calls too) and the largest serving call's
    for N, L, rate, dtype, phases in UNBERT_MHA_CASES:
        T, seed = N * L, 2 ** 45 + L
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        yield dict(
            case=f"unbert bf16 T={T} dropout {rate}", dtype=dtype,
            kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, rate, 1e-12,
                                                       seed),
            plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-12, rate, seed),
            library=lambda: torch.nn.functional.layer_norm(
                x + torch.nn.functional.dropout(h, rate), (HIDDEN,), scale_t, bias_t, 1e-12),
            bound=bound_ms(_nbytes(x, h, scale, bias, x), (9 if rate else 8) * T * HIDDEN,
                           torch.float32),
            phases=phases)
    # UniSRec's rows: a micro-batch's 880 x 159 with dropout, a fill chunk's
    # 512 x 159 without
    for N, L, rate, dtype, phases in UNISREC_MHA_CASES[:2]:
        T, seed = N * L, 2 ** 47 + N
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        yield dict(
            case=f"unisrec bf16 T={T} dropout {rate}", dtype=dtype,
            kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, rate, 1e-12,
                                                       seed),
            plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-12, rate, seed),
            library=lambda: torch.nn.functional.layer_norm(
                x + torch.nn.functional.dropout(h, rate), (HIDDEN,), scale_t, bias_t, 1e-12),
            bound=bound_ms(_nbytes(x, h, scale, bias, x), (9 if rate else 8) * T * HIDDEN,
                           torch.float32),
            phases=phases)


def add_ln_bwd_cases(dev, g):
    from miner_tpu_torch.ops import add_ln, philox

    for N, L, dtype in ((TRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (TRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (TRAIN_N, TRAIN_SAPO, torch.float32),
                        (PRETRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (PRETRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (UNBERT_TRAIN_B, UNBERT_WORD, torch.bfloat16),
                        (UNBERT_TRAIN_B, UNBERT_NEWS, torch.bfloat16),
                        (TRAIN_N, UNISREC_L, torch.bfloat16)):
        T, seed = N * L, 2 ** 43 + L
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
            main=N == TRAIN_N and L == TRAIN_SAPO and dtype == torch.bfloat16,
            phases=(() if dtype != torch.bfloat16 else ("pretrain",) if N == PRETRAIN_N
                    else ("unbert_train",) if N == UNBERT_TRAIN_B
                    else ("unisrec_train_all",) if L == UNISREC_L
                    else tuple(p for p in TRAIN_PHASES if p in BWD_PHASES)))


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


def _lookup_inputs(dev, g, N, B, C, K, D, cache_dt, int_dt):
    """A cache of N rows (int8: an ``Int8Rows`` quantized from bf16 rows, as
    ``--serve_cache_int8`` makes it), (B, C) candidate rows (a whole-corpus
    request takes every row in order, as ``serve_topk`` builds it; others
    draw them at random) and (B, K, D) interests; and the bytes the call
    must move: each distinct row gathered (with its scale) and the indices
    and interests read once, the scores written once."""
    from miner_tpu_torch.parallel.news_cache import quantize_rows

    cache = torch.randn(N, D, device=dev, generator=g)
    cache = quantize_rows(cache.to(torch.bfloat16)) if cache_dt == torch.int8 else cache.to(cache_dt)
    interests = torch.randn(B, K, D, device=dev, generator=g).to(int_dt)
    idx = torch.randint(0, N, (B, C), device=dev, generator=g, dtype=torch.int32)
    if C >= N - 1:
        idx[:] = torch.arange(1, C + 1, device=dev, dtype=torch.int32) % N
    rows = torch.unique(idx).numel()
    row_bytes = D + 4 if cache_dt == torch.int8 else D * cache.element_size()
    nbytes = rows * row_bytes + _nbytes(idx, interests) + B * C * K * interests.element_size()
    return (cache, idx, interests), nbytes


def lookup_nan_check(cache, idx, interests):
    """Candidates whose index lies in [-N, 0) score row N + index, as the
    JAX package's ``jnp.take`` wraps it; those outside [-N, N) (below -N, N,
    far past it) score NaN; every other score equals the plain version's on
    the same rows."""
    from miner_tpu_torch.ops import lookup_score

    N = cache.shape[0]
    bad_idx, rows = idx.clone(), idx.clone()
    bad = torch.zeros_like(idx, dtype=torch.bool)
    for b, c, v in ((0, 0, -N - 1), (1, idx.shape[1] - 1, N), (2, idx.shape[1] // 2, N + 10 ** 6)):
        bad_idx[b, c] = v
        bad[b, c] = True
    for b, c, v in ((3, 1, -1), (4, 2, -N)):
        bad_idx[b, c], rows[b, c] = v, v + N
    got = lookup_score.lookup_score_fused(cache, bad_idx, interests)
    want = lookup_score.lookup_score_reference(cache, rows.clamp(0, N - 1), interests)
    nan_ok = bool(torch.isnan(got[bad]).all())
    err = (got[~bad].float() - want[~bad].float()).abs().max().item()
    ok = nan_ok and err <= REL_TOL[interests.dtype] * max(1.0, want[~bad].float().abs().max().item())
    return ok, (f"outside [-N, N) NaN {nan_ok}, the others (rows -1 and -N wrapped) "
                f"err {err:.3g}")


def _lookup_yardstick(cache, idx, interests):
    """The PyTorch calls that compute lookup+score: ``index_select`` then
    ``bmm`` (int8 rows: ``index_select``, ``.to`` the interests' type,
    ``bmm``, times the gathered scales)."""
    B, C = idx.shape
    flat = idx.view(-1)
    if isinstance(cache, torch.Tensor):
        return lambda: torch.bmm(cache.index_select(0, flat).view(B, C, -1),
                                 interests.transpose(1, 2))
    return lambda: torch.bmm(
        cache.values.index_select(0, flat).view(B, C, -1).to(interests.dtype),
        interests.transpose(1, 2)) * cache.scales.index_select(0, flat).view(B, C, 1).to(
            interests.dtype)


def lookup_cases(dev, g):
    """lookup+score at a full serving request batch: a slate (C = 16), the
    whole-corpus top-k (C = 4,096), and an eval batch (B = 64 rows of one
    candidate each); in bf16 (the tensor cores) and fp32 (the CUDA cores);
    and the top-k over a cache of MIND's size (161,014 rows, 82 MB in bf16,
    more than the 50 MB L2) at B = 8. Then the int8 route
    (``--serve_cache_int8``) at the same shapes, with bf16 interests (the
    tensor cores) and fp32 (the CUDA cores). Beside each bf16 and int8 case
    the yardstick of the PyTorch calls computing the same function."""
    from miner_tpu_torch.ops import lookup_score
    from miner_tpu_torch.utils import candidate_bucket

    shapes = ((MAX_BATCH, 16), (MAX_BATCH, candidate_bucket(NUM_NEWS)), (EVAL_B, 1))
    cases = [(dtype, dtype, NUM_NEWS + 1, B, C)
             for dtype in (torch.bfloat16, torch.float32) for B, C in shapes]
    cases.append((torch.bfloat16, torch.bfloat16, MIND_NEWS + 1, 8, candidate_bucket(MIND_NEWS)))
    cases += [(torch.int8, int_dt, NUM_NEWS + 1, B, C)
              for int_dt in (torch.bfloat16, torch.float32) for B, C in shapes]
    cases.append((torch.int8, torch.bfloat16, MIND_NEWS + 1, 8, candidate_bucket(MIND_NEWS)))
    for cache_dt, int_dt, N, B, C in cases:
        args, nbytes = _lookup_inputs(dev, g, N, B, C, CODES, DIM, cache_dt, int_dt)
        topk = N == NUM_NEWS + 1 and C == candidate_bucket(NUM_NEWS)
        yield dict(
            case=f"{str(cache_dt)[6:]}/{str(int_dt)[6:]} N={N} B={B} C={C}", dtype=int_dt,
            kernel=lambda: lookup_score.lookup_score_fused(*args),
            plain=lambda: lookup_score.lookup_score_reference(*args),
            library=None,
            yardstick=(_lookup_yardstick(*args)
                       if cache_dt in (torch.bfloat16, torch.int8) else None),
            check=(lambda: lookup_nan_check(*args)) if C == 16 else None,
            bound=bound_ms(nbytes, 2 * B * C * CODES * DIM, int_dt),
            main=cache_dt == torch.bfloat16 and topk,
            route="int8" if cache_dt == torch.int8 and int_dt == torch.bfloat16 and topk
            else None)


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
        row, routes = None, {}
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
                log(f"    yardstick (index_select, bmm; for int8 rows also the cast and "
                    f"the scales' product) {yard_ms:.4f} ms")
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
            if c.get("route"):  # another route's numbers at its main shape, in the row
                routes[c["route"]] = {"case": c["case"], "launches": 0,
                                      "max_abs_err": max(e["max_err"] for e in errs),
                                      "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                                      "bound_ms": b_ms, "bound_by": b_by,
                                      "yardstick_ms": yard_ms}
            del got, want
            torch.cuda.empty_cache()
        row.update(routes)
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
             "lookup_score_fwd": slice(5, 12)}  # N, B, C, K, D, cache, interests codes

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
            N, B, C, K, D, code, int_code = shape
            cache_dt = torch.int8 if code == common.INT8_CODE else dtypes[code]
            args, nbytes = _lookup_inputs(dev, g, N, B, C, K, D, cache_dt, dtypes[int_code])
            fn = lambda: lookup_score.lookup_score_fused(*args)
            b_ms, _ = bound_ms(nbytes, 2 * B * C * K * D, dtypes[int_code])
            what = f"{str(cache_dt)[6:]} B={B} C={C}"
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
    160, so the title (32) and sapo (128) token windows are full; and each
    augmented variant of it (``<aug>_news.tsv``: the same ids and
    categories, other words)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20000)])
    os.makedirs(root, exist_ok=True)
    for variant in ("",) + tuple(f"{aug}_" for aug in AUGMENTATIONS):
        with open(os.path.join(root, f"{variant}news.tsv"), "w", encoding="utf-8") as f:
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
    weights from the seed, and a cache file in the temporary directory, or
    none to encode the corpus at every start."""
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


# UniSRec's one tower call a micro-batch: 12 layers of two add_ln sites;
# its backward (--unisrec_train_all) the same in reverse
PER_BATCH = {"unisrec_train": {"mha_fwd": 12, "add_ln_fwd": 24},
             "unisrec_train_all": {"mha_bwd": 12, "add_ln_bwd": 24}}


def _check_per_batch(phase: str, per_batch: dict) -> None:
    want = PER_BATCH.get(phase, {})
    if any(per_batch[k] != n for k, n in want.items()):
        raise SystemExit(f"{phase} phase: launches per micro-batch {per_batch}, want {want}")


def _requests(rng, n_slate: int, n_topk: int):
    """``n_slate`` slates of 10 and ``n_topk`` whole-corpus top-10 requests,
    each with a history of 5-60 clicks."""
    ids = [f"N{i}" for i in range(NUM_NEWS)]
    reqs = []
    for i in range(n_slate + n_topk):
        history = list(rng.choice(ids, int(rng.integers(5, 61)), replace=False))
        if i < n_slate:
            reqs.append({"history": history,
                         "candidates": list(rng.choice(ids, 10, replace=False))})
        else:
            reqs.append({"history": history, "candidates": None, "topk": 10})
    return reqs


def _serve_requests(service, args, reqs, clients: int, phase: str):
    """The requests over HTTP from ``clients`` concurrent clients: (the
    replies (status, body, seconds), the wall time). Fails the phase unless
    every reply is 200 with finite scores ranked best first."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from miner_tpu_torch.serving import make_http_server

    server = make_http_server(service, args.host, args.port, args.serve_http_impl)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            replies = list(pool.map(lambda r: _post(url, r), reqs))
        wall_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        thread.join(timeout=10)
    for req, (status, body, _) in zip(reqs, replies):
        scores = [s for _, s in body["results"]]
        want = len(req["candidates"]) if req["candidates"] else req["topk"]
        if (status != 200 or len(scores) != want or not all(map(math.isfinite, scores))
                or scores != sorted(scores, reverse=True)):
            raise SystemExit(f"{phase} phase: bad reply {status} {body}")
    return replies, wall_s


def serve_phase(corpus: str, checkpoint: str, phase: str = "serve",
                n_slate: int = 64, n_topk: int = 8) -> dict:
    """The serving path: ``serve``'s own pieces (service with its corpus
    cache, warm-up, HTTP server) on a train phase's ``finalModel``
    (``--saved_model_path``, loaded strictly), answering concurrent slate and
    top-k requests; ``phase`` "fastformer_serve" serves the Fastformer
    (``--model_name fastformer``), "unisrec_serve" UniSRec (``SERVE_FLAGS``).
    Returns the launch counts of the run."""
    import numpy as np

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.parallel.news_cache import CacheFiller
    from miner_tpu_torch.serving import ScoringService
    from miner_tpu_torch.training.trainer import Trainer

    args = serve_args(corpus, "--saved_model_path", checkpoint, *SERVE_FLAGS.get(phase, ()))
    reset_launch_counts()
    CENSUS.phase = phase
    t0 = time.perf_counter()
    service = ScoringService(Trainer(args))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = service.warmup(args.serve_warmup_slates, topk=args.serve_warmup_topk)
    warmup_s = time.perf_counter() - t0
    reqs = _requests(np.random.default_rng(1), n_slate, n_topk)
    try:
        replies, wall_s = _serve_requests(service, args, reqs, 16, phase)
        counts = launch_counts()
    finally:
        CENSUS.phase = None
        service.close()
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
    # the spread of a slate's scores: whether the model ranks, or ties
    slates = [[sc for _, sc in body["results"]] for req, (_, body, _) in zip(reqs, replies)
              if req["candidates"]]
    spread = sorted(max(sc) - min(sc) for sc in slates)
    log(f"{phase}: slate scores up to {max(abs(x) for sc in slates for x in sc):.4g} in "
        f"magnitude; spread (max - min) within a slate: median {spread[len(spread) // 2]:.4g}, "
        f"smallest {spread[0]:.4g}; {sum(len(set(sc)) < len(sc) for sc in slates)} of "
        f"{len(slates)} slates hold tied scores")
    log(f"{phase}: kernel launches on the path {counts}")
    _check_launches(phase, counts)
    return counts


def _cache_arrays(cache):
    """The tensors a news-embedding cache holds (int8 rows: values and
    scales)."""
    from miner_tpu_torch.parallel.news_cache import Int8Rows

    emb = cache.embeddings
    rows = (emb.values, emb.scales) if isinstance(emb, Int8Rows) else (emb,)
    return rows + (cache.category,)


def serve_cache_phase(corpus: str, checkpoint: str, tmp: str, family: str = "") -> dict:
    """The persisted serving cache: ``serve @config/serve_miner.txt`` started
    twice on the train phase's ``finalModel`` with ``--serve_cache_path`` in
    the temporary directory, then twice more with ``--serve_cache_int8``
    (another file); ``family`` "unisrec" does the same for UniSRec's
    ``finalModel`` (``SERVE_FLAGS``), its phases named ``unisrec_serve_*``. The first start of each encodes the corpus and persists
    it; the second loads the file: its start-up must launch no PLM kernel,
    its cache must equal the first's bit for bit, and the same requests,
    sent one at a time (so each device call has the same shape in both
    starts), must get the same replies bit for bit. Returns the launch
    counts of each start, requests included."""
    import numpy as np

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.serving import ScoringService
    from miner_tpu_torch.training.trainer import Trainer

    reqs = _requests(np.random.default_rng(4), 16, 4)
    counts, arrays = {}, {}
    prefix = f"{family}_" if family else ""
    for int8 in (False, True):
        path = os.path.join(tmp, f"{prefix}serve_cache{'_int8' if int8 else ''}.npz")
        starts = []
        for phase in ((f"{prefix}serve_int8", f"{prefix}serve_int8_loaded") if int8
                      else (f"{prefix}serve_cache", f"{prefix}serve_cache_loaded")):
            existed = os.path.exists(path)
            args = serve_args(corpus, "--saved_model_path", checkpoint, "--serve_cache_path",
                              path, *(("--serve_cache_int8",) if int8 else ()),
                              *SERVE_FLAGS.get(f"{prefix}serve", ()))
            reset_launch_counts()
            CENSUS.phase = phase
            trainer = Trainer(args)
            cache_s = []
            build_cache = trainer._load_or_build_serving_cache

            def timed_cache(*a):
                t0 = time.perf_counter()
                out = build_cache(*a)
                torch.cuda.synchronize()
                cache_s.append(time.perf_counter() - t0)
                return out

            trainer._load_or_build_serving_cache = timed_cache
            t0 = time.perf_counter()
            service = ScoringService(trainer)
            torch.cuda.synchronize()
            startup_s = time.perf_counter() - t0
            at_startup = launch_counts()
            try:
                replies, _ = _serve_requests(service, args, reqs, 1, phase)
                counts[phase] = launch_counts()
            finally:
                CENSUS.phase = None
                service.close()
            starts.append((existed, startup_s, at_startup, [body for _, body, _ in replies],
                           _cache_arrays(service.ctx.cache)))
            log(f"{phase}: start-up {startup_s:.2f} s, of which the cache "
                f"{cache_s[0]:.3f} s ({'loaded from the file' if existed else 'encoded, persisted'}"
                f"); launches at start-up {at_startup}; {len(reqs)} requests one at a time")
            _check_launches(phase, counts[phase])
        (existed0, fresh_s, _, bodies0, arrays0), (existed1, loaded_s, launched, bodies1,
                                                   arrays1) = starts
        same_cache = all(torch.equal(a, b) for a, b in zip(arrays0, arrays1))
        if existed0 or not existed1 or launched["mha_fwd"] or not same_cache or bodies0 != bodies1:
            raise SystemExit(f"{phase} phase: file there before the first start {existed0}, "
                             f"after it {existed1}; mha_fwd launches loading it "
                             f"{launched['mha_fwd']}; caches equal {same_cache}; replies "
                             f"equal {bodies0 == bodies1}")
        arrays[int8] = arrays0
        log(f"{phase}: start-up fresh {fresh_s:.2f} s, loaded {loaded_s:.2f} s; the loaded "
            f"cache and its {len(reqs)} replies equal the fresh ones bit for bit")
    nbytes = {k: sum(_nbytes(a) for a in v[:-1]) for k, v in arrays.items()}
    log(f"{prefix}serve_cache: cache bytes (rows and scales) int8 {nbytes[True]}, "
        f"{arrays[False][0].dtype} {nbytes[False]} ({nbytes[True] / nbytes[False]:.3f}x)")
    return counts


# ------------------------------------------------------------------ UnBERT
class PackTimer:
    """Host time of UnBERT's packing (``unbert_packing.pack_rows``, numpy,
    one row at a time): each call's rows and seconds while ``phase`` is
    set. It wraps the function where the batcher's blocks and the serving
    path look it up, and changes nothing of what it returns."""

    def __init__(self):
        self.phase = None
        self.calls = {}

    def install(self) -> None:
        from miner_tpu_torch.data import unbert_packing
        from miner_tpu_torch.training import trainer

        pack = unbert_packing.pack_rows

        def timed(packer, cand, hist):
            t0 = time.perf_counter()
            out = pack(packer, cand, hist)
            if self.phase is not None:
                self.calls.setdefault(self.phase, []).append(
                    (len(cand), time.perf_counter() - t0))
            return out

        unbert_packing.pack_rows = trainer.pack_rows = timed

    def report(self, phase: str) -> str:
        calls = self.calls.get(phase, [])
        if not calls:
            return f"{phase}: no packing calls"
        ms = sorted(1e3 * t for _, t in calls)
        rows = sorted(n for n, _ in calls)
        return (f"{phase}: host packing {len(calls)} calls of {rows[0]}-{rows[-1]} rows, "
                f"median {ms[len(ms) // 2]:.2f} ms, max {ms[-1]:.2f} ms, "
                f"{1e3 * sum(t for _, t in calls) / sum(rows):.4f} ms a row")


PACK_TIMER = PackTimer()


def unbert_eval_args(corpus: str, out: str, checkpoint: str, *extra: str):
    """``config/eval_unbert.txt`` as it stands on the synthetic corpus and
    its eval behaviors, the hash tokenizer over bert-base's vocabulary,
    ``--saved_model_path`` the given checkpoint; ``extra`` flags appended
    (the last of a repeated flag wins)."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", "eval_unbert.txt")) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag, value in (
            ("--pretrained_tokenizer", TOKENIZERS["unbert"]),
            ("--user2id_path", os.path.join(corpus, "user2id.json")),
            ("--category2id_path", os.path.join(corpus, "category2id.json")),
            ("--eval_behaviors_path", os.path.join(corpus, "valid", "behaviors.tsv")),
            ("--eval_news_path", os.path.join(corpus, "news.tsv")),
            ("--saved_model_path", checkpoint)):
        words[words.index(flag) + 1] = value
    return make_parser().parse_args(["eval_fastformer", *words, "--eval_path",
                                     os.path.join(out, "unbert_eval"), *extra])


def unbert_eval_phase(corpus: str, out: str, final_model: str) -> dict:
    """Standalone ``eval_fastformer`` of the UnBERT train phase's
    ``bestAucModel``: first at the train config's geometry
    (``train_unbert.txt``: titles of 32, 50 history news, bf16), whose auc
    must equal the train run's end-of-epoch eval bit for bit; then
    ``config/eval_unbert.txt`` as shipped (titles of 20, 20 history news),
    whose metrics must be finite. Returns the launch counts of both."""
    import csv

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training.trainer import Trainer

    run_dir = os.path.dirname(os.path.dirname(final_model))
    with open(os.path.join(run_dir, "eval.csv")) as f:
        train_auc = max(float(r["auc"]) for r in csv.DictReader(f))
    best = os.path.join(run_dir, "ckpt", "bestAucModel")
    phase = "unbert_eval_standalone"
    reset_launch_counts()
    PACK_TIMER.phase = phase
    results = []
    try:
        for geometry in (("--max_title_length", "32", "--max_sapo_length", "128",
                          "--his_length", "50"), ()):
            t0 = time.perf_counter()
            scores = Trainer(unbert_eval_args(corpus, out, best, *geometry)).eval()
            torch.cuda.synchronize()
            results.append((scores, time.perf_counter() - t0))
    finally:
        PACK_TIMER.phase = None
    counts = launch_counts()
    (at_train, train_s), (shipped, shipped_s) = results
    log(f"{phase}: bestAucModel at train_unbert.txt's geometry {train_s:.2f} s, auc "
        f"{at_train['auc']!r} against the train run's {train_auc!r}; eval_unbert.txt as "
        f"shipped {shipped_s:.2f} s: {shipped}")
    log(PACK_TIMER.report(phase))
    log(f"{phase}: kernel launches {counts}")
    bad = [v for v in list(at_train.values()) + list(shipped.values())
           if not math.isfinite(v)]
    if at_train["auc"] != train_auc or bad:
        raise SystemExit(f"{phase} phase: auc {at_train['auc']!r} against the train "
                         f"run's {train_auc!r}; non-finite {bad}")
    _check_launches(phase, counts)
    return counts


def unbert_serve_args(corpus: str, checkpoint: str):
    """``config/serve_unbert.txt`` as it stands on the synthetic corpus, the
    hash tokenizer over bert-base's vocabulary, ``--saved_model_path`` the
    given checkpoint, any free port."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", "serve_unbert.txt")) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag, value in (
            ("--pretrained_tokenizer", TOKENIZERS["unbert"]),
            ("--user2id_path", os.path.join(corpus, "user2id.json")),
            ("--category2id_path", os.path.join(corpus, "category2id.json")),
            ("--eval_news_path", os.path.join(corpus, "news.tsv")),
            ("--saved_model_path", checkpoint),
            ("--port", "0")):
        words[words.index(flag) + 1] = value
    return make_parser().parse_args(["serve", *words])


def _refusals(service, args, payloads):
    """(status, error) of each request, over HTTP: what a refused request
    gets back."""
    import threading
    import urllib.error

    from miner_tpu_torch.serving import make_http_server

    server = make_http_server(service, args.host, args.port, args.serve_http_impl)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{server.server_address[1]}"
    replies = []
    try:
        for payload in payloads:
            try:
                status, body, _ = _post(url, payload)
            except urllib.error.HTTPError as e:
                status, body = e.code, json.loads(e.read())
            replies.append((status, body.get("error", "")))
    finally:
        server.shutdown()
        thread.join(timeout=10)
    return replies


def unbert_serve_phase(corpus: str, checkpoint: str) -> dict:
    """The UnBERT reranker: ``serve @config/serve_unbert.txt`` on the train
    phase's ``finalModel``. The warm-up runs slates of 10 (bucket 16) at
    every batch bucket up to 32, so up to 512 packed rows a call; 64
    slates of 10 from 16 clients must get 200, finite and ranked replies;
    a whole-corpus request and a slate of ``--serve_max_slate`` + 1 must be
    refused (400). Returns the launch counts."""
    import numpy as np

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.serving import ScoringService
    from miner_tpu_torch.training.trainer import Trainer

    phase = "unbert_serve"
    args = unbert_serve_args(corpus, checkpoint)
    reset_launch_counts()
    PACK_TIMER.phase = phase
    trainer = Trainer(args)
    score_unbert, device_calls = trainer.serve_scores_unbert, []

    def timed_scores(model, packer, cand_idx, his_idx):
        t0 = time.perf_counter()
        scores = score_unbert(model, packer, cand_idx, his_idx)  # synchronises (.cpu())
        device_calls.append((cand_idx.size, time.perf_counter() - t0))
        return scores

    trainer.serve_scores_unbert = timed_scores
    t0 = time.perf_counter()
    service = ScoringService(trainer)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        warmed = service.warmup(args.serve_warmup_slates, topk=args.serve_warmup_topk or None)
        warmup_s = time.perf_counter() - t0
        warm_calls, device_calls[:] = list(device_calls), []
        reqs = _requests(np.random.default_rng(5), 64, 0)
        replies, wall_s = _serve_requests(service, args, reqs, 16, phase)
        ids = [f"N{i}" for i in range(args.serve_max_slate + 1)]
        refused = _refusals(service, args, [
            {"history": ids[:5], "candidates": None, "topk": 10},
            {"history": ids[:5], "candidates": ids}])
        counts = launch_counts()
    finally:
        PACK_TIMER.phase = None
        service.close()
    lat = sorted(t for _, _, t in replies)
    rows = [n for n, _ in device_calls]
    log(f"{phase}: unbert reranker restored from {os.path.relpath(checkpoint, corpus)}, "
        f"startup {startup_s:.2f} s; {warmed} warm-up calls {warmup_s:.2f} s "
        f"({', '.join(f'{n} rows {1e3 * t:.1f} ms' for n, t in warm_calls)})")
    log(f"{phase}: {len(reqs)} slates of 10, 16 clients: {len(reqs) / wall_s:.1f} req/s, "
        f"p50 {1e3 * lat[len(lat) // 2]:.1f} ms, max {1e3 * lat[-1]:.1f} ms "
        f"({len(lat)} samples, too few for a p99), {len(rows)} device calls of "
        f"{min(rows)}-{max(rows)} rows (mean {sum(rows) / len(rows):.1f}, padding "
        f"included), {service.batcher.stats()['mean_batch']} requests per device call "
        f"on {torch.cuda.get_device_name(0)}")
    log(PACK_TIMER.report(phase))
    log(f"{phase}: refusals {refused}")
    log(f"{phase}: kernel launches on the path {counts}")
    want = (service.batcher.max_batch.bit_length()) * len(args.serve_warmup_slates)
    if (warmed != want or max(n for n, _ in warm_calls) != UNBERT_SERVE_B
            or [s for s, _ in refused] != [400, 400] or "cross-encoder" not in refused[0][1]
            or "serve_max_slate" not in refused[1][1]):
        raise SystemExit(f"{phase} phase: {warmed} warm-up calls (want {want}) of at most "
                         f"{max(n for n, _ in warm_calls)} rows; refusals {refused}")
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


# the training configurations: the subcommand each runs under, and the
# phases of its micro-batches and of its eval
TRAIN_CONFIGS = {"miner": ("train", "train_miner.txt", "train", "eval"),
                 "fastformer": ("train_fastformer", "train_fastformer.txt",
                                "fastformer_train", "fastformer_eval"),
                 "pretrain": ("pretrain", "pretrain_miner.txt", "pretrain", "pretrain_eval"),
                 "hard": ("train", "train_miner_hard.txt", "warm_start", "warm_start_eval"),
                 "unbert": ("train_fastformer", "train_unbert.txt", "unbert_train",
                            "unbert_eval"),
                 "unisrec": ("train_fastformer", "train_unisrec.txt", "unisrec_train",
                             "unisrec_eval"),
                 "unisrec_all": ("train_fastformer", "train_unisrec.txt", "unisrec_train_all",
                                 "unisrec_train_all_eval")}
PARITY_FAMILIES = ("miner", "fastformer", "unbert", "unisrec")
# the flags each family's parity phase adds: UniSRec trains its PLM too, so
# that every tower gradient is compared
PARITY_FLAGS = {"unisrec": ("--unisrec_train_all",)}
# the hash tokenizer over each family's vocabulary size: roberta-base's, and
# bert-base's for UnBERT and UniSRec (bert_base preset); no tokenizer files here
TOKENIZERS = {"unbert": "hash:30522", "unisrec": "hash:30522", "unisrec_all": "hash:30522"}
# serve_miner.txt's flags overridden for a family's checkpoint
SERVE_FLAGS = {"fastformer_serve": ("--model_name", "fastformer"),
               "unisrec_serve": ("--model_name", "unisrec", "--plm_preset", "bert_base",
                                 "--pretrained_tokenizer", TOKENIZERS["unisrec"],
                                 "--combine_type", "pre-concat")}


def micro_batches(family: str) -> int:
    """One epoch's micro-batches of 16 over the 256 train impressions: one
    a impression, or for UnBERT five packed rows an impression (one
    candidate drawn per visit, five visits)."""
    return TRAIN_IMPRESSIONS * (5 if family == "unbert" else 1) // 16


def train_args(corpus: str, out: str, *extra: str, family: str = "miner"):
    """``config/train_miner.txt`` (or for ``family`` "fastformer"
    ``config/train_fastformer.txt`` under ``train_fastformer``, "pretrain"
    ``config/pretrain_miner.txt`` under ``pretrain``, "hard"
    ``config/train_miner_hard.txt``, "unbert" ``config/train_unbert.txt``
    and "unisrec" / "unisrec_all" ``config/train_unisrec.txt`` under
    ``train_fastformer``) as it stands, on the synthetic corpus and
    behaviors, with the hash tokenizer over the PLM's vocabulary
    (``TOKENIZERS``), random init, and one epoch."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    mode, config = TRAIN_CONFIGS[family][:2]
    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", config)) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag, value in (
            ("--pretrained_tokenizer", TOKENIZERS.get(family, "hash:50265")),
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


def train_phase(corpus: str, out: str, family: str = "miner", *extra: str):
    """The training path: ``Trainer(args).train()`` of a full-width
    configuration (``train_args``; ``extra`` flags appended) for one epoch
    of 16 micro-batches, then its end-of-epoch eval and checkpoints.
    ``train_miner.txt``: roberta-base towers, bf16 compute, fp32 masters,
    dropout 0.1 in the PLM and 0.2 elsewhere, --remat, accumulation 8 (2
    updates). ``train_fastformer.txt``: the same towers frozen
    (--freeze_transformer) under a 2-layer Fastformer user encoder in fp32;
    its PLM parameters must come out bit-identical. ``pretrain_miner.txt``:
    the news encoder alone on the contrastive loss over the positive, its 3
    augmented variants and 4 negatives, no accumulation (16 updates), its
    eval the summed loss (``bestLossModel``, never ``bestAucModel``).
    ``train_miner_hard.txt`` with ``--pretrained_model_path``: the news
    encoder of ``finalModel`` must equal that checkpoint's bit for bit when
    ``--learning_rate 0``. Returns the launch counts of the micro-batches
    and of the eval, and the finalModel checkpoint."""
    import csv
    import gc

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training import checkpoint
    from miner_tpu_torch.training.trainer import Trainer

    phase, eval_phase = TRAIN_CONFIGS[family][2:]
    args = train_args(corpus, out, *extra, family=family)
    trainer = Trainer(args)
    unisrec = trainer.model_name == "unisrec"
    step_s, step_loss, eval_s, before_eval = [], [], [], {}
    update_s = []  # each optimizer update (clip, AdamW), the card synchronised around it
    held, after_fwd = [], []  # GiB allocated at each micro-batch's start, after its forward
    eval_name = "_run_pretrain_eval" if trainer.kind == "pretrain" else "_run_eval"
    train_step, run_eval = trainer.train_step, getattr(trainer, eval_name)
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

    make_optimizer = trainer.make_optimizer

    def timed_optimizer(*a, **k):
        optimizer = make_optimizer(*a, **k)
        step = optimizer.step

        def timed_update():
            torch.cuda.synchronize()  # the backward's kernels done
            t0 = time.perf_counter()
            applied = step()
            torch.cuda.synchronize()
            if applied:
                update_s.append(time.perf_counter() - t0)
            return applied

        optimizer.step = timed_update
        return optimizer

    trainer.make_optimizer = timed_optimizer
    trainer.train_step = timed_step
    setattr(trainer, eval_name, timed_eval)
    trainer._apply_and_loss = measured_forward
    # what earlier phases left in reference cycles (their models and
    # optimizer states among them) is freed first, so the peak is this run's
    gc.collect()
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
    accum = args.gradient_accumulation_steps
    if trainer.kind == "pretrain":  # the positive, its variants, the negatives
        what = f"{args.train_batch_size * (1 + len(args.augmentations or ()) + args.npratio)} news"
    elif trainer.kind == "unbert":
        what = f"packed rows of {UNBERT_WORD} tokens and {UNBERT_NEWS} sentences"
    else:
        what = f"{args.train_batch_size * (args.npratio + 1 + args.his_length)} news"
    log(f"{phase}: {args.model_name if trainer.kind != 'pretrain' else 'pretrain'}, "
        f"{len(step_s)} micro-batches of {args.train_batch_size} ({what} per "
        f"micro-batch), {run.optimizer.updates} optimizer updates at accumulation "
        f"{accum}, {args.compute_dtype}, --remat {args.remat}, --freeze_transformer "
        f"{args.freeze_transformer}, dropout {args.dropout} / {TRAIN_RATE}"
        + (f", --combine_type {args.combine_type} ({UNISREC_L} tokens a news), "
           f"--unisrec_train_all {args.unisrec_train_all}" if unisrec else ""))
    log(f"{phase}: micro-batch {1e3 * mid:.1f} ms median of {len(steady)} "
        f"(first {1e3 * step_s[0]:.1f} ms, with kernel compiles), "
        f"{args.train_batch_size / mid:.2f} examples/s, "
        f"{1 / (mid * accum):.3f} updates/s; "
        f"eval {eval_s[0]:.2f} s; whole train() {wall_s:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
        f"{torch.cuda.get_device_name(0)}")
    log(f"{phase}: optimizer updates (clip, AdamW; in the micro-batch times above) "
        f"{[round(1e3 * t, 1) for t in update_s]} ms")
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
    if (bad or run.optimizer.updates != len(step_s) // accum
            or len(step_s) != micro_batches(family)):
        raise SystemExit(f"{phase} phase: non-finite {bad}, {run.optimizer.updates} "
                         f"updates, {len(step_s)} micro-batches")
    _check_launches(phase, before_eval)
    _check_launches(eval_phase, eval_counts)
    _check_per_batch(phase, per_batch)
    ckpt = os.path.join(run.run_dir, "ckpt")
    final = os.path.join(ckpt, "finalModel")
    if trainer.kind == "pretrain" and sorted(os.listdir(ckpt)) != ["bestLossModel", "finalModel"]:
        raise SystemExit(f"{phase} phase: checkpoints {sorted(os.listdir(ckpt))}, expected "
                         "bestLossModel and finalModel alone")
    if args.freeze_transformer:
        initial = trainer.build_model().state_dict()
        saved = checkpoint.load(final)["params"]
        plm = [k for k in initial if k.startswith("news_encoder.plm.")]
        moved = [k for k in plm if not torch.equal(saved[k].cpu(), initial[k])]
        log(f"{phase}: {len(plm) - len(moved)} of {len(plm)} PLM tensors of the "
            "finalModel bit-identical to their initial values (frozen)")
        if moved or not plm:
            raise SystemExit(f"{phase} phase: frozen PLM parameters moved: {moved[:5]}")
    if unisrec and not args.unisrec_train_all:
        initial = trainer.build_model().state_dict()
        saved = checkpoint.load(final)["params"]
        moved = {k for k in initial if not torch.equal(saved[k].cpu(), initial[k])}
        moe = {k for k in initial if "moe" in k}
        log(f"{phase}: {len(initial) - len(moved)} of {len(initial)} tensors of the "
            f"finalModel bit-identical to their initial values; moved: {sorted(moved)}")
        if moved != moe:
            raise SystemExit(f"{phase} phase: the MoE-only freeze moved {sorted(moved - moe)[:5]}"
                             f" and left {sorted(moe - moved)[:5]}")
    if args.pretrained_model_path and args.learning_rate == 0:
        warm = checkpoint.load(args.pretrained_model_path)["params"]
        saved = checkpoint.load(final)["params"]
        moved = [k for k in warm if not torch.equal(saved[f"news_encoder.{k}"], warm[k])]
        log(f"{phase}: {len(warm) - len(moved)} of {len(warm)} news-encoder tensors of the "
            f"finalModel bit-identical to {os.path.relpath(args.pretrained_model_path, out)} "
            "(--learning_rate 0)")
        if moved or not warm:
            raise SystemExit(f"{phase} phase: the warm-started encoder moved at learning "
                             f"rate 0: {moved[:5]}")
    return {phase: before_eval, eval_phase: eval_counts}, final


def train_parity_phase(corpus: str, out: str, family: str = "miner") -> None:
    """One micro-batch of one impression (55 news; for UnBERT two packed
    rows of 300 tokens, both towers at full depth) through the full-width
    model in float32 with dropout off, on the card (kernels, their autograd
    Functions) and on the CPU (plain versions), same weights from the seed:
    the loss and every trainable parameter's gradient must agree (the
    Fastformer's PLM is frozen, as ``--freeze_transformer`` makes it in
    training; UniSRec runs with ``--unisrec_train_all``, so its tower's
    gradients are compared too, and its ``w_noise``, which only the
    training mode's gating noise reaches, has none on either device); for
    UnBERT also the serving scores of two slates of 4, within 1e-3 of their
    scale. Tolerance: 1e-3 of each gradient's largest magnitude plus
    1e-5 of the largest over all gradients, since float32 sums through 12
    layers forward and back are taken in other orders by the kernels and
    cuBLAS than by the plain versions and the CPU's BLAS, and a gradient
    that is a small difference of large terms (the target-aware
    projection's, 1e-7 at random init) carries the absolute rounding of
    those terms."""
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.training.trainer import Trainer

    import numpy as np

    result, scores = {}, {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(train_args(corpus, out, "--compute_dtype", "float32",
                                     "--device", device, *PARITY_FLAGS.get(family, ()),
                                     family=family))
        a = trainer.args
        store = trainer._load_store(a.train_news_path)
        log_ = trainer._load_log(a.train_behaviors_path, store)
        if trainer.kind == "unbert":
            batch = trainer._train_sampler(log_, store).sample_epoch(0).materialize(
                np.arange(2))
        else:
            block = OnlineSampler(log_, store, a.npratio, seed=a.seed).sample_epoch(0)
            batch = {"cand_idx": block.cand[:1], "his_idx": block.his[:1],
                     "label": block.label[:1]}
        model = trainer.build_model().to(trainer.device).eval()
        if a.freeze_transformer:
            model.news_encoder.plm.requires_grad_(False)
        loss, _ = trainer._apply_and_loss(model, trainer._make_table(store), batch, True)
        loss.backward()
        # a tensor the loss does not reach has no gradient on either
        # device (UniSRec's w_noise: no gating noise in eval mode)
        result[device] = (float(loss.detach()), {n: p.grad.float().cpu()
                                                 for n, p in model.named_parameters()
                                                 if p.grad is not None})
        if trainer.kind == "unbert":
            cand = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
            his = np.stack([log_.history[0], log_.history[1]])
            scores[device] = trainer.serve_scores_unbert(
                model, trainer._unbert_packer(store), cand, his)
    if scores:
        got, want = scores["cuda"], scores["cpu"]
        err = float(np.abs(got - want).max())
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        log(f"train parity ({family}): serving scores {got.shape} card vs CPU max abs "
            f"err {err:.3g} (tol {tol:.3g})")
        if not (np.isfinite(got).all() and err <= tol):
            raise SystemExit(f"train parity phase ({family}): serving scores disagree "
                             f"({err} > {tol})")
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = result["cuda"], result["cpu"]
    if set(grads_gpu) != set(grads_cpu):
        raise SystemExit(f"train parity phase ({family}): gradients of "
                         f"{sorted(set(grads_gpu) ^ set(grads_cpu))[:5]} on one device only")
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


# ------------------------------------------------------------- HF import
def _hf_bert_state(cfg, g) -> dict:
    """Random tensors under HF BERT's key names at ``cfg``'s shapes, as a
    ``BertForSequenceClassification`` saves them (``bert.`` prefix, a pooler
    the import ignores): keys and tensors, no ``transformers``."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    r = lambda *shape: 0.02 * torch.randn(*shape, generator=g)
    sd = {"embeddings.word_embeddings.weight": r(cfg.vocab_size, D),
          "embeddings.position_embeddings.weight": r(cfg.max_position_embeddings, D),
          "embeddings.token_type_embeddings.weight": r(cfg.type_vocab_size, D),
          "embeddings.LayerNorm.weight": 1 + r(D), "embeddings.LayerNorm.bias": r(D),
          "pooler.dense.weight": r(D, D)}
    dense = {"attention.self.query": (D, D), "attention.self.key": (D, D),
             "attention.self.value": (D, D), "attention.output.dense": (D, D),
             "intermediate.dense": (F, D), "output.dense": (D, F)}
    for i in range(cfg.num_layers):
        for name, (rows, cols) in dense.items():
            sd[f"encoder.layer.{i}.{name}.weight"] = r(rows, cols)
            sd[f"encoder.layer.{i}.{name}.bias"] = r(rows)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"encoder.layer.{i}.{name}.weight"] = 1 + r(D)
            sd[f"encoder.layer.{i}.{name}.bias"] = r(D)
    return {f"bert.{k}": v for k, v in sd.items()}


def _recbole_state(g, d_in: int, D=300, experts=8, inner=256) -> dict:
    """Random tensors under a RecBole UniSRec's key names: the sequential
    encoder of 2 layers, its position table and LayerNorm, the MoE adaptor
    of ``experts`` experts from the tower's width ``d_in`` to ``D``."""
    r = lambda *shape: 0.02 * torch.randn(*shape, generator=g)
    sd = {"position_embedding.weight": r(HIS, D), "LayerNorm.weight": 1 + r(D),
          "LayerNorm.bias": r(D), "moe_adaptor.w_gate": r(d_in, experts),
          "moe_adaptor.w_noise": r(d_in, experts)}
    dense = {"multi_head_attention.query": (D, D), "multi_head_attention.key": (D, D),
             "multi_head_attention.value": (D, D), "multi_head_attention.dense": (D, D),
             "feed_forward.dense_1": (inner, D), "feed_forward.dense_2": (D, inner)}
    for i in range(2):
        for name, (rows, cols) in dense.items():
            sd[f"trm_encoder.layer.{i}.{name}.weight"] = r(rows, cols)
            sd[f"trm_encoder.layer.{i}.{name}.bias"] = r(rows)
        for name in ("multi_head_attention.LayerNorm", "feed_forward.LayerNorm"):
            sd[f"trm_encoder.layer.{i}.{name}.weight"] = 1 + r(D)
            sd[f"trm_encoder.layer.{i}.{name}.bias"] = r(D)
    for e in range(experts):
        sd[f"moe_adaptor.experts.{e}.bias"] = r(d_in)
        sd[f"moe_adaptor.experts.{e}.lin.weight"] = r(D, d_in)
    return sd


def _grafted(hf: dict, rec: dict, num_layers: int) -> dict:
    """Where each file's tensor must land in the UniSRec: the tower's
    layers with Q, K and V stacked on the weight's rows in that order, the
    sequential encoder's likewise, each expert's ``lin.weight`` transposed
    into the (E, D_in, D_out) kernel."""
    want = {f"news_encoder.plm.embeddings.{n}.weight": hf[f"bert.embeddings.{n}.weight"]
            for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    want["news_encoder.plm.embeddings.ln.weight"] = hf["bert.embeddings.LayerNorm.weight"]
    want["news_encoder.plm.embeddings.ln.bias"] = hf["bert.embeddings.LayerNorm.bias"]
    layers = [(hf, f"bert.encoder.layer.{i}.", f"news_encoder.plm.layers.{i}.",
               ("attention.self", "attention.output.dense", "attention.output.LayerNorm",
                "intermediate.dense", "output.dense", "output.LayerNorm"))
              for i in range(num_layers)]
    layers += [(rec, f"trm_encoder.layer.{i}.", f"trm_layers.{i}.",
                ("multi_head_attention", "multi_head_attention.dense",
                 "multi_head_attention.LayerNorm", "feed_forward.dense_1",
                 "feed_forward.dense_2", "feed_forward.LayerNorm")) for i in range(2)]
    for sd, src, dst, (attn, *rest) in layers:
        for suffix in ("weight", "bias"):
            want[f"{dst}attention.qkv.{suffix}"] = torch.cat(
                [sd[f"{src}{attn}.{n}.{suffix}"] for n in ("query", "key", "value")])
            for name, s in zip(("attention.out", "attention_ln", "ffn_in", "ffn_out",
                                "ffn_ln"), rest):
                want[f"{dst}{name}.{suffix}"] = sd[f"{src}{s}.{suffix}"]
    experts = sum(1 for k in rec if k.endswith(".lin.weight"))
    moe = "news_encoder.moe_adaptor."
    want.update({"position_embedding.weight": rec["position_embedding.weight"],
                 "ln.weight": rec["LayerNorm.weight"], "ln.bias": rec["LayerNorm.bias"],
                 moe + "w_gate": rec["moe_adaptor.w_gate"],
                 moe + "w_noise": rec["moe_adaptor.w_noise"],
                 moe + "experts.bias": torch.stack(
                     [rec[f"moe_adaptor.experts.{e}.bias"] for e in range(experts)]),
                 moe + "experts.kernel": torch.stack(
                     [rec[f"moe_adaptor.experts.{e}.lin.weight"].T for e in range(experts)])})
    return want


def hf_import_phase(corpus: str, out: str, tmp: str) -> None:
    """``config/train_unisrec.txt`` with ``--hf_checkpoint`` (a
    ``pytorch_model.bin`` of HF BERT key names at bert-base's shapes) and
    ``--unisrec_pretrained_path`` (a RecBole-layout ``.pth``), both written
    here from a seed: every tensor of the model on the card must equal the
    file's it was grafted from, bit for bit, and one micro-batch must train
    with a finite loss through the kernels."""
    import numpy as np

    from miner_tpu_torch.config import plm_config
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training.trainer import Trainer

    g = torch.Generator().manual_seed(5)
    hf_dir, pth = os.path.join(tmp, "hf_bert"), os.path.join(tmp, "unisrec_recbole.pth")
    os.makedirs(hf_dir, exist_ok=True)
    trainer = Trainer(train_args(corpus, out, "--hf_checkpoint", hf_dir,
                                 "--unisrec_pretrained_path", pth, family="unisrec"))
    cfg = plm_config(trainer.args.plm_preset, vocab_size=trainer.tokenizer.vocab_size)
    hf, rec = _hf_bert_state(cfg, g), _recbole_state(g, cfg.hidden_size)
    torch.save(hf, os.path.join(hf_dir, "pytorch_model.bin"))
    torch.save(rec, pth)
    t0 = time.perf_counter()
    model = trainer.initial_model().to(trainer.device)
    torch.cuda.synchronize()
    graft_s = time.perf_counter() - t0
    got = model.state_dict()
    want = _grafted(hf, rec, cfg.num_layers)
    bad = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    a = trainer.args
    store = trainer._load_store(a.train_news_path)
    block = OnlineSampler(trainer._load_log(a.train_behaviors_path, store), store, a.npratio,
                          seed=a.seed).sample_epoch(0)
    batch = {"cand_idx": block.cand[:16], "his_idx": block.his[:16], "label": block.label[:16]}
    reset_launch_counts()
    optimizer = trainer.make_optimizer(model.train(), 1, 0)
    loss = float(trainer.train_step(model, trainer._make_table(store), batch, optimizer, 0))
    counts = launch_counts()
    log(f"hf_import: {len(want) - len(bad)} of {len(want)} tensors on the card equal to the "
        f"files' ({len(hf)} HF BERT tensors, {len(rec)} RecBole ones; the pooler ignored), "
        f"import and graft {graft_s:.2f} s; one micro-batch loss {loss:.5f}, launches "
        f"{counts}")
    if bad or not np.isfinite(loss) or counts["mha_fwd"] != cfg.num_layers:
        raise SystemExit(f"hf_import phase: grafted tensors differing from the files "
                         f"{bad[:5]}; loss {loss}; launches {counts}")


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
        counts.update(serve_cache_phase(corpus, final_model, tmp))
        pre_counts, pre_model = train_phase(corpus, tmp, "pretrain")
        counts.update(pre_counts)
        warm_counts, _ = train_phase(corpus, tmp, "hard", "--pretrained_model_path", pre_model,
                                     "--learning_rate", "0")
        counts.update(warm_counts)
        ff_counts, ff_model = train_phase(corpus, tmp, "fastformer")
        counts.update(ff_counts)
        counts["fastformer_serve"] = serve_phase(corpus, ff_model, "fastformer_serve")
        PACK_TIMER.install()
        PACK_TIMER.phase = "unbert_train"
        try:
            ub_counts, ub_model = train_phase(corpus, tmp, "unbert")
        finally:
            PACK_TIMER.phase = None
        log(PACK_TIMER.report("unbert_train"))
        counts.update(ub_counts)
        counts["unbert_eval_standalone"] = unbert_eval_phase(corpus, tmp, ub_model)
        counts["unbert_serve"] = unbert_serve_phase(corpus, ub_model)
        us_counts, us_model = train_phase(corpus, tmp, "unisrec")
        counts.update(us_counts)
        counts["unisrec_serve"] = serve_phase(corpus, us_model, "unisrec_serve")
        counts.update(serve_cache_phase(corpus, us_model, tmp, "unisrec"))
        all_counts, _ = train_phase(corpus, tmp, "unisrec_all", "--unisrec_train_all",
                                    "--gradient_accumulation_steps", "8")
        counts.update(all_counts)
        hf_import_phase(corpus, tmp, tmp)
        write_corpus(os.path.join(tmp, "parity"), 64, seed=1)
        parity_phase(os.path.join(tmp, "parity"))
        for family in PARITY_FAMILIES:
            train_parity_phase(corpus, tmp, family)
    for row in rows:
        row["launches_by_phase"] = {phase: c[row["name"]] for phase, c in counts.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
    for row in rows:
        if "int8" in row:  # the int8 route's share of lookup+score's launches
            row["int8"]["launches"] = sum(
                n for (name, _, shape), n in CENSUS.counts.items()
                if name == row["name"] and shape[5] == common.INT8_CODE)
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
