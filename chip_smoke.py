#!/usr/bin/env python3
"""The PyTorch port's training and serving paths on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

0. native_sampler (host): the native data plane (``data/native.py``, the
   port's copy of the JAX package's C++ sampler and UnBERT packer) is built
   by g++ and loaded, or the run fails; an epoch's ``sample_epoch`` of a
   200,000-event log of MIND-small's size, made from a seed, is timed in
   modes base and hard natively and on numpy over the slice numpy samples
   in about 1 s; ``pack_rows`` at UnBERT's train micro-batch (16 rows) and
   largest serving call (512), native against numpy, outputs equal. Every
   later train, UnBERT and parity phase (and every rank of a mesh train
   phase) counts its native calls and fails if its sampler or packer never
   went native (the pretrain kind's sampler is numpy only, as in JAX).
1. build: every CUDA kernel of ``miner_tpu_torch/csrc`` is compiled with
   ``nvcc`` (one process per source, all started together); the Triton
   kernels compile at their first launch.
2. kernels: each of the seven kernels runs at the shapes its paths give it
   (serving: the cache fill's chunks and request batches; training: a
   ``train_miner.txt`` micro-batch, with dropout on, and for mha also off,
   so that the dropout's share of the time shows, and in fp32, and a
   ``pretrain_miner.txt`` micro-batch; the add_ln backward also in fp32;
   poly-attention at the train, serve and eval batches in bf16 and fp32
   (and fp32 at a single user and at the PLM's D = 768), and with a
   quarter of its rows fully masked; lookup+score at a slate (with candidates in [-N, 0): wrapped,
   and outside [-N, N): NaN), the
   whole-corpus top-k and an eval batch, in bf16 and fp32, and the top-k
   over a cache of MIND's size, then its int8 route at the same shapes with
   bf16 and fp32 interests; Fastformer attention at the train, eval and
   serve batches, in fp32 as those paths give it, and in bf16; mha and
   add_ln at UnBERT's shapes: 300-token rows and 23-sentence news
   sequences of a micro-batch (16), an eval batch (64) and the largest
   serving call (512); mha and add_ln at UniSRec's pre-concatenated titles
   of 159 tokens: a micro-batch's 880 with dropout (the backward kernels
   too), a cache-fill chunk's 512 and an eval batch's 64 without; mha and
   add_ln, forward and backward, at a cached-history micro-batch's 80
   candidates, L = 128 and 32, with dropout; poly-attention under the
   legacy 1e-30 fill, bf16 and fp32, with masked and no-click rows; the
   fp32 mha kernels (split TF32) at the sapo shape with and without
   dropout, the title shape, 80 candidates and 159 tokens, forward and
   backward; bf16 poly-attention at the PLM's D = 768 (8 CTAs a row, D
   split) at 1, 16, 32 and 64 under both fills, and lookup+score with bf16
   and int8 rows at D = 768, and with fp32 rows there (32-candidate
   tiles); a rank's shapes over a mesh of two (row entries ``w2``): mha
   and add_ln, forward and backward, at 440 sequences, poly-attention at
   B = 8 (and 32, the serving case), lookup+score at a data rank's half
   eval batch and on a table rank's half of the cache; and over a model
   axis of two (``w2_model``): mha forward and backward at a tp_train
   micro-batch's 220 sequences and 6 of the 12 heads, add_ln over their
   rows)
   against its plain PyTorch version on the same inputs (the tolerance is
   printed beside the error; the mha backward's dq, dk and dv each at the
   scale of its (sequence, head)'s gradient; with dropout the kernel's
   mask must equal the plain version's bit for bit; and a rank's launches
   of mha and add_ln, forward and backward, at their Philox offsets, over
   data rank 1's two runs of sequences and model rank 1's heads, must
   equal their slice of the whole batch's launch bit for bit), and is
   timed with
   CUDA events beside the plain
   version, the one PyTorch call computing the same function where there
   is one (for lookup+score, which has none, the calls index_select and
   bmm, for int8 rows with the cast and the scales' product, as a
   yardstick), and its bound on an H100 SXM (3.35 TB/s; 989
   TFLOP/s bf16, 165 TFLOP/s fp32: the TF32 rate over three passes). A
   kernel's time is its device time,
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
   vocabulary, bf16, dropout, accumulation 8) for one epoch of its first
   96 impressions (cut for time): 480 packed rows of 300 tokens (5 visits
   of each), 30 micro-batches, 3 updates, and its end-of-epoch eval over
   2,560 packed
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
   reference_roundtrip: the train, Fastformer and UnBERT ``finalModel``s
   exported to the reference's format by ``python -m
   miner_tpu_torch.tools.export_to_reference`` and imported back by
   ``import_reference_checkpoint``: every parameter bit-equal; the
   re-imported Miner served (``roundtrip_serve``) answers the serve cache
   phase's requests, one at a time, with its fresh start's replies bit
   for bit.
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
9. cached-history training: ``train_miner.txt`` and ``train_fastformer.txt``
   with ``--his_cache_refresh 2 --his_cache_warmup_steps 1
   --gradient_accumulation_steps 2`` for one epoch: 2 full-history
   micro-batches (``*_warmup``), then 14 that send the 80 candidates alone
   through the towers and gather the history rows from the news-embedding
   cache of the train corpus, refilled from the live weights
   (``*_refill``) at micro-steps 2, 4, 8 and 12, which must be JAX's rule;
   the cached micro-batch's time (its refill apart) beside train's, each
   refill's time; the Miner's cached micro-batches launch every Miner
   kernel and both backward ones, the Fastformer's (towers frozen) no
   backward one. lstm / legacy: ``train_miner.txt`` with ``--combine_type
   lstm --legacy_poly_mask`` for one epoch and its eval (news vectors in
   fp32, so poly-attention and lookup+score take their fp32 routes), then
   ``serve_miner.txt`` with the same flags on its ``finalModel`` over HTTP.
   fp32 train: ``train_miner.txt`` with ``--compute_dtype float32`` at full
   width for 4 micro-batches at accumulation 4 (one update): the median
   micro-batch, the peak memory, and where the device's time goes (mha,
   cuBLAS, the rest; ``RunLogger.trace`` over the last 3, as for the
   profiled train phases: each writes its Chrome trace into its run
   directory, which the phase checks). Both fp32 mha
   kernels must launch.
   no_reduce: ``train_miner.txt`` without ``--apply_reduce_dim`` (a
   configuration derived from it, written by the script), the first 32
   impressions (2 micro-batches at accumulation 2), its eval, then
   ``serve_miner.txt`` without the flag on its ``finalModel`` for 16
   requests: news vectors of the PLM's D = 768, so bf16 poly-attention
   must launch at D = 768 in the micro-batches, the eval and the serving.
   remat_dots: ``train_miner.txt`` with ``--remat_policy dots``, 4
   micro-batches at accumulation 4, the last 3 traced: the micro-batch and
   the peak memory beside train's (``--remat`` alone), 24 mha forwards a
   micro-batch as train's.
   Under ``--remat`` (train, warm_start, no_reduce, remat_dots) a
   micro-batch launches mha_fwd 24 times, once a layer of the two tower
   calls: the recompute takes the saved attention context.
10. parity: the full-width Miner in float32 over 64 news, on the card
   through the kernels and on the CPU through the plain versions; the cache
   rows and the scores of one request batch must agree.
11. train parity, Miner, Fastformer, UnBERT, UniSRec and the Miner's
   cached-history micro-batch (one cache, filled on the card): one micro-batch of
   one impression (UnBERT: two packed rows) in float32, dropout off, on the
   card and on the CPU: the loss and every trainable parameter's gradient
   must agree (UniSRec with ``--unisrec_train_all``, so the tower's too);
   for UnBERT also the serving scores of two slates. They run in a process
   of their own (``chip_smoke.py --side``), started after the build: the
   CPU halves on ``CPU_PARITY_THREADS`` of the host's cores beside the
   kernel phase and the serial phases, the card halves (and the cached
   micro-batch's CPU half, on the cache its card half filled) once the
   serial phases end, beside the untimed ones.
12. mesh (each launched by ``python -m torch.distributed.run --standalone``
   as subprocesses of this script, ``--mesh_rank``, so that each rank runs
   the port's CLI; the counts set to 0 in each rank just before it; a rank
   that fails, or a launcher past ``MESH_TIMEOUT_S``, fails the run):
   mesh_train, ``train_miner.txt --mesh_data 2`` at full width for 8
   micro-batches at accumulation 4, without its eval (every Miner kernel on
   each rank, finite losses, both ranks' parameters bit-identical; the
   micro-batch, global examples/s, each update and the gradient sum's
   share, peak memory a rank, the backend, ranks a card); mesh_parity_fp32,
   the same in float32 with the config's dropout (off until PR 15), 2
   micro-batches at accumulation 2, at W = 2 against W = 1 (losses, the update's gradient norm before
   the clip and its clipped gradients, each within its stated tolerance);
   table_eval,
   ``eval_miner.txt`` on the train phase's ``finalModel`` with
   ``--mesh_table 2`` against a one-rank eval, bit for bit, lookup+score
   on each rank's shard; mesh_his_cache, ``--mesh_data 2 --mesh_table 2``
   (4 ranks) with the cached-history flags for 6 micro-batches (rebuilds
   at micro-steps 2 and 4, on sharded caches). Since PR 15 the model axis:
   tp_train, ``train_miner.txt --mesh_model 2`` at 4 rows a micro-batch
   for 3 micro-batches (every mha launch at a rank's 6 heads; the model
   group's all-reduces a micro-batch, their time and share); mesh_parity_tp,
   the fp32 parity at ``--mesh_model 2`` (4 rows) against one rank, and
   both parities with the config's dropout, which no longer depends on the
   mesh; ep_unisrec, ``train_unisrec.txt --mesh_model 2`` (the experts
   sharded), 2 micro-batches; mesh_serve / mesh_serve_loaded,
   ``serve_miner.txt --mesh_table 2`` over HTTP on train's ``finalModel``,
   fresh then from the cache it persisted, 20 requests each, replies
   bit-equal to one rank's and the file equal to one rank's. The launches
   start after the build (their ranks import what they run and wait), take
   their jobs before fp32_train, build their first models on the host
   beside fp32_train and remat_dots (whose time is the card's) and hold
   them there until the serial phases end; the timed phases
   (mesh_train, tp_train) run alone on the card, last; the others run
   beside the untimed phases. On one card the ranks share it (gloo); where
   each has a card, NCCL.

13. turnkey: ``python -m miner_tpu_torch.tools.turnkey_mind``
   (called in-process) on a zip of the planted corpus of ``synth_mind`` at
   1,200 news and 600 lines, as MIND ships: extracted, prepared into
   splits (``prepare_mind``), the Miner trained for an epoch at its
   defaults (the tiny tower, the hash tokenizer, bf16, the kernels) and
   evaluated standalone from ``bestAucModel`` with ``--save_eval_result``:
   the splits, the checkpoint, ``preds.pkl`` and the per-impression dumps
   there, ``tools/analyze_preds.py preds`` reading the ``preds.pkl`` in a
   process of its own, and mha, add_ln (forward and backward),
   poly-attention and lookup+score launched. It runs in the process of 11,
   after the card halves, beside the mesh launches.
14. convergence: the first run of the port that learns. The
   at-scale corpus of ``scale_convergence`` (60,000 news, 50,000 lines,
   5,000 held-out impressions, seed 11: the JAX package's SCALE tables')
   is written by ``python -m miner_tpu_torch.tools.synth_mind`` in a
   process started with the script, beside the build; after
   native_sampler ``chip_smoke.py --convergence`` starts in a process of
   its own, loads it and holds before its model reaches the card until
   the serial phases end, then runs ``scale_convergence --model miner
   --epochs 4 --stop_after_epochs 1`` (the launch counts set to 0 there,
   read after):
   epoch 0 of the 4-epoch recipe (small tower, B = 64, lr 1e-4, bf16, the
   kernels; 1,620 micro-batches) and its cached eval over the 60,000-news
   cache, beside hf_import, the parity phases and the untimed mesh
   phases, ended before the held mesh phases. It prints the per-epoch
   table, examples/s, the epoch's time and the peak memory, and fails the
   run if its held-out auc is below ``CONVERGENCE_AUC`` (0.70: halfway
   between chance and the JAX package's 0.7811 for that epoch of that
   recipe on a v5e) or it launched no Miner kernel.

15. analysis tools, each a phase of its own (the counts set to 0 just
   before, read just after): ``unisrec_diag --steps 40`` (its six
   variants, float32: the tiny tower's fp32 kernels at Dh = 16; finite
   losses, the deterministic variant's below ln 5); ``warmstart_ab
   --artifact domain`` for one seed on a 600-line planted corpus (the
   donor Miner, its tower exported in the transformers format and
   imported by the warm run, warm and cold finite); ``unisrec_contract
   --plm_preset tiny --stage_c_baseline``, an epoch a stage on 1,200 news
   (the export holds every tensor of the model; the baseline at lr 0
   scores what stage A's model scored); ``quality_trajectory`` legs
   port-A and port-B at the mid preset in float32 for 100 steps each,
   then ``analyze`` (finite logs; at step 0, one init and one batch, the
   two losses within 1%). Each phase's seconds and census are printed.

The phases run in the order above, but for those whose times nothing
reads (reference_roundtrip and roundtrip_serve of 7, UniSRec serve of 8,
lstm / legacy and no_reduce of 9, and 15): they run after the serial
phases, beside the mesh launches and the convergence epoch; UniSRec serve
in the process of 11 (after its card halves and 13), the others with 10
in this one.

After the phases, every shape at which the main path launched
poly-attention, lookup+score or an fp32 mha kernel (a census of their
launches: fp32_train's and the parity phases'; the convergence process's
joins it) is timed, and each kernel's
launch-weighted gap, launches x (time - bound) summed over the shapes it
was launched at, goes into its row (mha's fp32 share also into the row's
``fp32`` entry).

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
# fp32: the dense TF32 rate over three passes, the cost of fp32-accurate
# products on the tensor cores (split TF32, as the fp32 mha kernels run
# them); the CUDA cores' 67 TFLOP/s is no longer the least time the card
# could take
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
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
TRAIN_PHASES = ("train", "fastformer_train", "warm_start",  # 880 sequences a micro-batch
                "his_cache_warmup", "fastformer_his_cache_warmup", "lstm_legacy_train",
                "no_reduce_train", "remat_dots_train")
# the phases that differentiate the PLM
BWD_PHASES = ("train", "warm_start", "pretrain", "his_cache_warmup", "lstm_legacy_train",
              "no_reduce_train", "remat_dots_train")
FILL_PHASES = ("eval", "serve", "fastformer_eval", "fastformer_serve", "warm_start_eval",
               "pretrain_eval", "serve_cache", "serve_int8", "his_cache_refill",
               "his_cache_eval", "fastformer_his_cache_refill", "fastformer_his_cache_eval",
               "lstm_legacy_eval", "lstm_legacy_serve", "no_reduce_eval", "no_reduce_serve",
               "remat_dots_eval", "roundtrip_serve", "table_eval", "table_eval_one",
               "mesh_serve")
# the mha kernels' training cases (N, L, dropout rate, dtype, phases): the
# sapo shape with dropout (the main path's), without it (Philox's share);
# the title shape; the pretrain micro-batch's two shapes
# over a mesh with a data axis of 2 (mesh_train, mesh_his_cache's warmup) a
# rank's micro-batch is half of it: 440 sequences a field, 8 users; its
# eval batch 32 rows; a table rank's cache half the corpus and a zero row
MESH_N, MESH_B, MESH_EVAL_B = TRAIN_N // 2, 8, 32
MESH_PHASES = ("mesh_train", "mesh_his_cache")
# over the model axis (tp_train: --mesh_model 2 at --train_batch_size 4) a
# rank runs every sequence of a micro-batch, 880 x 4 / 16 = 220 a field, at
# half the heads (6 of 12): qkv (220, L, 3 x 768 / 2)
TP_B, TP_HEADS = 4, HEADS // 2
TP_N = TRAIN_N * TP_B // 16
TP_PHASES = ("tp_train",)
# the phases the fp32 add_ln cases (880 sequences) stand for
FP32_LN_PHASES = ("fp32_train", "mesh_parity_fp32", "mesh_parity_fp32_one", "mesh_parity_tp")
TRAIN_MHA_CASES = ((TRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.bfloat16, TRAIN_PHASES),
                   (TRAIN_N, TRAIN_SAPO, 0.0, torch.bfloat16, ()),
                   (TRAIN_N, TRAIN_TITLE, TRAIN_RATE, torch.bfloat16, TRAIN_PHASES),
                   (PRETRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.bfloat16, ("pretrain",)),
                   (PRETRAIN_N, TRAIN_TITLE, TRAIN_RATE, torch.bfloat16, ("pretrain",)),
                   (MESH_N, TRAIN_SAPO, TRAIN_RATE, torch.bfloat16, MESH_PHASES),
                   (MESH_N, TRAIN_TITLE, TRAIN_RATE, torch.bfloat16, MESH_PHASES))
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
UNISREC_TRAIN_PHASES = ("unisrec_train", "unisrec_train_all", "ep_unisrec")
UNISREC_FILL_PHASES = ("unisrec_eval", "unisrec_train_all_eval", "unisrec_serve",
                       "unisrec_serve_cache", "unisrec_serve_int8")
UNISREC_MHA_CASES = ((TRAIN_N, UNISREC_L, TRAIN_RATE, torch.bfloat16, UNISREC_TRAIN_PHASES),
                     (CHUNK, UNISREC_L, 0.0, torch.bfloat16, UNISREC_FILL_PHASES),
                     (64, UNISREC_L, 0.0, torch.bfloat16, ()))
# cached-history training (--his_cache_refresh): past the warmup a
# micro-batch's PLM sees its 16 x (1 + 4) candidates alone, titles and sapos
CACHED_N = 16 * 5
CACHED_PHASES = ("his_cache_train", "fastformer_his_cache_train")
CACHED_MHA_CASES = tuple((CACHED_N, L, TRAIN_RATE, torch.bfloat16, CACHED_PHASES)
                         for L in (TRAIN_SAPO, TRAIN_TITLE))
# the fp32 mha cases (--compute_dtype float32: the split-TF32 kernels): the
# sapo shape with dropout (the fp32 route's entry in the row) and without,
# the title shape, a cached-history micro-batch's 80 candidates and
# UniSRec's 159 tokens. Their launches (fp32_train, the parity phases) are
# counted and timed shape by shape (LaunchCensus), so they stand for no phase
FP32_MHA_CASES = ((TRAIN_N, TRAIN_SAPO, TRAIN_RATE, torch.float32,
                   # the census sees no rank: the fp32 parity ranks' launches
                   # (440 sequences, or 880 at 6 heads) stand here
                   ("mesh_parity_fp32", "mesh_parity_tp")),
                  (TRAIN_N, TRAIN_SAPO, 0.0, torch.float32, ()),
                  (TRAIN_N, TRAIN_TITLE, TRAIN_RATE, torch.float32, ()),
                  (CACHED_N, TRAIN_SAPO, TRAIN_RATE, torch.float32, ()),
                  (TRAIN_N, UNISREC_L, TRAIN_RATE, torch.float32, ()))
# the end-to-end and analysis tools' towers (their phases' launches of mha
# and add_ln stand at these cases): a micro-batch's sequences of a field with
# dropout (and the statistics), the eval's sequences (cache-fill chunks, or
# the eval batch) without. The tiny tower (plm_preset tiny: D = 64, 4 heads
# of Dh = 16, layer-norm eps 1e-5) of turnkey_mind's defaults (16 users, 1 +
# 4 candidates and 10 history news each, titles of 16 tokens and sapos of
# 24) and warmstart_ab's (32 users), both bf16; of unisrec_diag (32 users, 5
# candidates and 10 history news, titles of 12 tokens) and the mid preset of
# quality_trajectory (64 users, 5 candidates and 20 history news, titles of
# 32 and sapos of 24), both float32; of the analysis phase's unisrec_contract
# (ANALYSIS_CONTRACT_B users, 5 candidates and 50 history news,
# pre-concatenated titles of 32 + 2 - 1 = 33 tokens, bf16). The small tower
# (plm_preset small: D = 256, 8 heads of Dh = 32, eps 1e-12) of
# scale_convergence's Miner (64 users, 5 + 50 news, titles of 32) and of
# unisrec_contract at its defaults (64 users, 5 + 50 news, L = 33: run by
# hand, so it stands for no phase). name: (D, heads, eps, dtype, micro-batch
# N, eval N or None, lengths, phases)
ANALYSIS_CONTRACT_B = 16
TOOL_TOWERS = {
    "turnkey": (64, 4, 1e-5, torch.bfloat16, 16 * (5 + 10), CHUNK, (16, 24), ("turnkey",)),
    "convergence": (256, 8, 1e-12, torch.bfloat16, 64 * (5 + 50), CHUNK, (32,),
                    ("convergence",)),
    "warmstart_ab": (64, 4, 1e-5, torch.bfloat16, 32 * (5 + 10), CHUNK, (16, 24),
                     ("warmstart_ab",)),
    "unisrec_diag": (64, 4, 1e-5, torch.float32, 32 * (5 + 10), 32 * (5 + 10), (12,),
                     ("unisrec_diag",)),
    "quality_trajectory": (64, 4, 1e-5, torch.float32, 64 * (5 + 20), None, (32, 24),
                           ("quality_trajectory",)),
    "unisrec_contract": (64, 4, 1e-5, torch.bfloat16, ANALYSIS_CONTRACT_B * (5 + 50), CHUNK,
                         (33,), ("unisrec_contract",)),
    "unisrec_contract_small": (256, 8, 1e-12, torch.bfloat16, 64 * (5 + 50), CHUNK, (33,), ()),
}
# the tools' cases whose numbers go into the kernels' rows as routes of their
# own (their micro-batch at its first length): mha at Dh = 16 in float32 and
# at L = 33 in bf16; add_ln at D = 64 in float32
TOOL_ROUTES = {"unisrec_diag": "tools_fp32_tiny", "unisrec_contract_small": "tools_bf16_l33"}
# fp32_train: train_miner.txt in float32 for this many micro-batches at
# accumulation 4 (one update), the first a warm-up, the rest traced
FP32_MICRO_BATCHES = 4
# the flags the cached-history phases add to train_miner.txt and
# train_fastformer.txt: warmup 1 update, refresh every 2, accumulation 2, so
# that one epoch of 16 micro-batches crosses the warmup switch and refills
HIS_CACHE_FLAGS = ("--his_cache_refresh", "2", "--his_cache_warmup_steps", "1",
                   "--gradient_accumulation_steps", "2")
LSTM_LEGACY_FLAGS = ("--combine_type", "lstm", "--legacy_poly_mask")
FF_HEADS = 16  # the Fastformer of word_embed_dim 256 (trainer: 16 if D % 16 == 0)
# the phases each Fastformer attention case stands for (its batch: 16, 64, 32)
FF_CASE_PHASES = {"train": ("fastformer_train", "fastformer_his_cache_train",
                            "fastformer_his_cache_warmup"),
                  "eval": ("fastformer_eval", "fastformer_his_cache_eval"),
                  "serve": ("fastformer_serve",)}
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
    # cached-history training: the candidates' micro-steps differentiate the
    # PLM as the full ones do; a refill is the PLM forward alone
    "his_cache_train": MINER_KERNELS + PLM_BWD,
    "his_cache_warmup": MINER_KERNELS + PLM_BWD,
    "his_cache_refill": PLM_FWD,
    "his_cache_eval": SERVE_KERNELS,
    "fastformer_his_cache_train": FF_KERNELS,
    "fastformer_his_cache_warmup": FF_KERNELS,
    "fastformer_his_cache_refill": PLM_FWD,
    "fastformer_his_cache_eval": FF_KERNELS,
    "lstm_legacy_train": MINER_KERNELS + PLM_BWD,
    "lstm_legacy_eval": SERVE_KERNELS,
    "lstm_legacy_serve": SERVE_KERNELS,
    # --compute_dtype float32: the fp32 routes of the PLM kernels (and of
    # poly-attention, the news vectors being fp32)
    "fp32_train": MINER_KERNELS + PLM_BWD,
    # a Miner without --apply_reduce_dim: poly-attention at D = 768
    "no_reduce_train": MINER_KERNELS + PLM_BWD,
    "no_reduce_eval": SERVE_KERNELS,
    "no_reduce_serve": SERVE_KERNELS,
    "remat_dots_train": MINER_KERNELS + PLM_BWD,
    "remat_dots_eval": SERVE_KERNELS,
    # the train phase's finalModel out to the reference's format and back
    "roundtrip_serve": SERVE_KERNELS,
    # over a mesh of ranks, each rank's launches (start_mesh)
    "mesh_train": MINER_KERNELS + PLM_BWD,
    "mesh_parity_fp32": MINER_KERNELS + PLM_BWD,
    "mesh_parity_fp32_one": MINER_KERNELS + PLM_BWD,
    "table_eval": SERVE_KERNELS,
    "mesh_his_cache": MINER_KERNELS + PLM_BWD,
    # --mesh_model 2: the kernels on each rank's heads; UniSRec's adaptor
    # alone trains, as unisrec_train; serving over --mesh_table 2 from a
    # fresh cache, then from the file it persisted
    "tp_train": MINER_KERNELS + PLM_BWD,
    "mesh_parity_tp": MINER_KERNELS + PLM_BWD,
    "ep_unisrec": PLM_FWD,
    "mesh_serve": SERVE_KERNELS,
    "mesh_serve_loaded": ("poly_attention_fwd", "lookup_score_fwd"),
    # the end-to-end tools (miner_tpu_torch/tools): a Miner trained and evaluated
    # from the cache, its micro-batches differentiating the PLM
    "turnkey": SERVE_KERNELS + PLM_BWD,
    "convergence": SERVE_KERNELS + PLM_BWD,
    # the analysis tools: UniSRec's tower trained and evaluated (its tail
    # plain products); the Miner warm and cold with its cached eval; the
    # Miner's trajectory legs, evaluated by the model itself
    "unisrec_diag": PLM_FWD + PLM_BWD,
    "warmstart_ab": SERVE_KERNELS + PLM_BWD,
    "unisrec_contract": PLM_FWD + PLM_BWD,
    "quality_trajectory": MINER_KERNELS + PLM_BWD,
}
FORBIDDEN = {"fastformer_train": PLM_BWD,
             "ep_unisrec": TAIL_KERNELS + PLM_BWD,
             "mesh_serve_loaded": PLM_FWD,
             "serve_cache_loaded": PLM_FWD,  # the cache comes from the file
             "serve_int8_loaded": PLM_FWD,
             "pretrain": TAIL_KERNELS,  # the news encoder alone
             "unisrec_diag": TAIL_KERNELS,
             "unisrec_contract": TAIL_KERNELS,
             "pretrain_eval": TAIL_KERNELS + PLM_BWD,
             # the cross-encoder: the PLM kernels alone
             "unbert_train": TAIL_KERNELS,
             **{phase: TAIL_KERNELS + PLM_BWD for phase in UNBERT_INFER_PHASES},
             "unisrec_train": TAIL_KERNELS + PLM_BWD,  # no backward through the PLM
             "unisrec_train_all": TAIL_KERNELS,
             **{phase: TAIL_KERNELS + PLM_BWD for phase in UNISREC_FILL_PHASES},
             **{f"unisrec_serve_{c}_loaded": TAIL_KERNELS + PLM_FWD + PLM_BWD
                for c in ("cache", "int8")},
             # the towers frozen, as train_fastformer.txt ships them
             "fastformer_his_cache_train": PLM_BWD,
             "fastformer_his_cache_warmup": PLM_BWD,
             **{f"{f}his_cache_refill": TAIL_KERNELS + PLM_BWD
                for f in ("", "fastformer_")}}
# the libraries whose ptxas report names each entry (kernels built in
# several variants)
ENTRY_REPORTS = ("mha_fwd", "mha_bwd", "add_ln_bwd", "poly_attention_fwd",
                 "lookup_score_fwd", "fastformer_attn_fwd")
# the libraries whose fp32 entries run split TF32: a spill there fails the run
SPLIT_TF32 = ("mha_fwd", "mha_bwd", "poly_attention_fwd")
# MIND (Wu et al., ACL 2020) counts 161,013 news: a cache of 161,014 rows
# (row 0 the padding), and the corpus top-k's candidate bucket over it
MIND_NEWS = 161013
# the augmented news variants config/pretrain_miner.txt loads (the other
# training configs take a subset of them)
AUGMENTATIONS = ("changed_topic_text", "enhanced_text", "semi_enhanced_text")


# the corpus of scale_convergence (the JAX package's SCALE tables'): 60,000
# news, 50,000 train lines, 5,000 eval impressions, histories of 30-50
SCALE_CORPUS = ("--news", "60000", "--users", "5000", "--train_lines", "50000",
                "--eval_lines", "5000", "--hist_len", "30", "50")
# the convergence phase's gate: halfway between chance and the JAX package's
# epoch-0 auc of the same recipe on the same corpus (0.7811, SCALE_r03.md)
CONVERGENCE_AUC = 0.70
CONVERGENCE_TIMEOUT_S = 600
# the side phases' process (side_main: train parity, turnkey, UniSRec's
# serving): the host's cores its CPU halves take beside the kernel phase and
# the serial phases, and its time at most from its release onto the card
CPU_PARITY_THREADS = 2
SIDE_TIMEOUT_S = 600
# the turnkey phase's archive: the planted corpus at 1,200 news
TURNKEY_LINES = 600
TURNKEY_VALID = 60
# the analysis tools (analysis_tools_phases): unisrec_diag's steps a
# variant, the planted corpus's lines of warmstart_ab and unisrec_contract,
# quality_trajectory's lines, eval impressions and steps a leg
DIAG_STEPS = 40
ANALYSIS_LINES = 600
ANALYSIS_NEWS = 1200
TRAJECTORY_LINES, TRAJECTORY_EVAL, TRAJECTORY_STEPS = 1600, 200, 100

T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.0f} s] {msg}", flush=True)


def device_ms(fn, target_s: float = 0.05) -> float:
    """Mean time of ``fn()`` on the card in ms, from CUDA events around a
    run of launches after a warm-up; a call of ``target_s`` or more (the
    plain versions at the training shapes) is timed once, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) >= target_s * 1e3:
        return start.elapsed_time(end)
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


def _mha_inputs(dev, g, N, L, dtype, hidden=HIDDEN):
    qkv = torch.randn(N, L, 3 * hidden, device=dev, generator=g).to(dtype)
    lengths = torch.randint(1, L + 1, (N,), device=dev, generator=g)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).to(torch.int32)
    return qkv, mask


def takes_offsets() -> bool:
    """Whether the package's mha wrapper takes Philox offsets (another
    version's, timed beside this one, may not: its rank cases are left
    out)."""
    import inspect

    from miner_tpu_torch.ops import mha

    return "seq_offset" in inspect.signature(mha._launch_fwd).parameters


def _sdpa_leaves(qkv, heads=HEADS):
    """q, k, v (N, heads, L, Dh) as leaf tensors, for the SDPA yardstick."""
    N, L, _ = qkv.shape
    return [t.contiguous().requires_grad_()
            for t in qkv.view(N, L, 3, heads, -1).permute(2, 0, 3, 1, 4)]


def mha_dropout_mask_check(qkv, mask, seed, heads=HEADS):
    """The forward kernel's dropout zeros against the plain Philox mask, bit
    for bit: with V set to one-hot rows (one launch per block of Dh keys)
    each output row is a row of dropped probabilities, zero exactly where
    the key is dropped or masked."""
    from miner_tpu_torch.ops import mha, philox

    N, L, D3 = qkv.shape
    Dh = D3 // 3 // heads
    keep = philox.keep_mask(philox.mha_bits(seed, N, heads, L, qkv.device), TRAIN_RATE)
    want_zero = ~(keep & mask.bool()[:, None, None, :])  # (N, heads, L, L)
    mismatches = 0
    for k0 in range(0, L, Dh):
        nb = min(Dh, L - k0)
        probe = qkv.clone().view(N, L, 3, heads, Dh)
        probe[:, :, 2] = 0
        j = torch.arange(nb, device=qkv.device)
        probe[:, k0 + j, 2, :, j] = 1
        out = mha.fused_mha(probe.view(N, L, -1), mask, heads, TRAIN_RATE, 1, seed)
        got_zero = out.view(N, L, heads, Dh)[..., :nb] == 0
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
    for N, L, rate, dtype, phases in TRAIN_MHA_CASES + FP32_MHA_CASES:
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
            route=("fp32" if (N, L, rate, dtype) == FP32_MHA_CASES[0][:4]
                   else "w2" if (N, L) == (MESH_N, TRAIN_SAPO) else None),
            phases=phases)
    # a rank of the model axis (tp_train): its 6 heads of every sequence,
    # their masks drawn at heads 6-11 of model rank 1
    for L in (TRAIN_SAPO, TRAIN_TITLE) if takes_offsets() else ():
        seed = 2 ** 45 + L
        qkv, mask = _mha_inputs(dev, g, TP_N, L, torch.bfloat16, HIDDEN // 2)
        q, k, v = qkv.view(TP_N, L, 3, TP_HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(TP_N, L, HIDDEN // 2, dtype=qkv.dtype, device=dev)
        stats = torch.empty(TP_N, TP_HEADS, L, 2, device=dev)
        yield dict(
            case=f"model rank bf16 N={TP_N} L={L} heads {TP_HEADS} dropout {TRAIN_RATE}",
            dtype=torch.bfloat16,
            kernel=lambda: mha._launch_fwd(qkv, mask, TP_HEADS, 1, TRAIN_RATE, seed, True,
                                           0, TP_HEADS)[0],
            plain=lambda: mha.mha_reference(qkv, mask, TP_HEADS, 1, TRAIN_RATE, seed, 0,
                                            TP_HEADS),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=TRAIN_RATE),
            bound=bound_ms(_nbytes(qkv, mask, out, stats),
                           4 * TP_N * TP_HEADS * L * L * (HIDDEN // HEADS), torch.bfloat16),
            route="w2_model" if L == TRAIN_SAPO else None, phases=TP_PHASES)
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
    # the statistics), the cache fill's chunk and an eval batch without; and
    # a cached-history micro-batch's 80 candidates at L = 128 and 32
    for N, L, rate, dtype, phases in UNISREC_MHA_CASES + CACHED_MHA_CASES:
        seed, train = 2 ** 46 + N + L, rate > 0
        qkv, mask = _mha_inputs(dev, g, N, L, dtype)
        q, k, v = qkv.view(N, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
        bool_mask = mask.bool()[:, None, None, :]
        out = torch.empty(N, L, HIDDEN, dtype=dtype, device=dev)
        stats = torch.empty(N, HEADS, L, 2, device=dev) if train else out[:0]
        yield dict(
            case=f"{'cached' if N == CACHED_N else 'unisrec'} bf16 N={N} L={L} dropout {rate}",
            dtype=dtype,
            kernel=lambda: mha._launch_fwd(qkv, mask, HEADS, 1, rate, seed, train)[0],
            plain=lambda: mha.mha_reference(qkv, mask, HEADS, 1, rate, seed),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bool_mask, dropout_p=rate),
            check=(lambda: mha_dropout_mask_check(qkv, mask, seed)) if rate else None,
            bound=bound_ms(_nbytes(qkv, mask, out, stats),
                           4 * N * HEADS * L * L * (HIDDEN // HEADS), dtype),
            phases=phases)
    # the end-to-end tools' towers: a micro-batch with dropout (and the
    # statistics), a cache-fill chunk without
    for name, (D, heads, _, dtype, train_n, fill_n, lengths, phases) in TOOL_TOWERS.items():
        for L in lengths:
            for N, rate in ((train_n, TRAIN_RATE), (fill_n, 0.0)):
                if N is None:
                    continue
                seed, train = 2 ** 49 + N + L, rate > 0
                qkv, mask = _mha_inputs(dev, g, N, L, dtype, D)
                q, k, v = qkv.view(N, L, 3, heads, -1).permute(2, 0, 3, 1, 4)
                bool_mask = mask.bool()[:, None, None, :]
                out = torch.empty(N, L, D, dtype=qkv.dtype, device=dev)
                stats = torch.empty(N, heads, L, 2, device=dev) if train else out[:0]
                yield dict(
                    case=f"{name} {str(dtype)[6:]} N={N} L={L} D={D} dropout {rate}",
                    dtype=dtype,
                    kernel=lambda: mha._launch_fwd(qkv, mask, heads, 1, rate, seed, train)[0],
                    plain=lambda: mha.mha_reference(qkv, mask, heads, 1, rate, seed),
                    library=lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=bool_mask, dropout_p=rate),
                    check=((lambda: mha_dropout_mask_check(qkv, mask, seed, heads)) if rate
                           else None),
                    bound=bound_ms(_nbytes(qkv, mask, out, stats),
                                   4 * N * heads * L * L * (D // heads), dtype),
                    route=TOOL_ROUTES.get(name) if train and L == lengths[0] else None,
                    phases=phases)


def mha_grad_errors(got, want, rel, heads=HEADS):
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
    shape = (N, L, 3, heads, D3 // 3 // heads)
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

    for N, L, rate, dtype, phases in TRAIN_MHA_CASES + FP32_MHA_CASES + tuple(
            c for c in UNBERT_MHA_CASES + UNISREC_MHA_CASES + CACHED_MHA_CASES if c[2] > 0):
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
            route=("fp32" if (N, L, rate, dtype) == FP32_MHA_CASES[0][:4]
                   else "w2" if (N, L) == (MESH_N, TRAIN_SAPO) else None),
            phases=tuple(p for p in phases
                         if p in BWD_PHASES + MESH_PHASES + ("unbert_train", "unisrec_train_all",
                                                             "his_cache_train",
                                                             "mesh_parity_fp32",
                                                             "mesh_parity_tp")))
    # a rank of the model axis (tp_train)
    for L in (TRAIN_SAPO, TRAIN_TITLE) if takes_offsets() else ():
        seed = 2 ** 45 + L
        qkv, mask = _mha_inputs(dev, g, TP_N, L, torch.bfloat16, HIDDEN // 2)
        dout = torch.randn(TP_N, L, HIDDEN // 2, device=dev, generator=g).to(torch.bfloat16)
        out, stats = mha._launch_fwd(qkv, mask, TP_HEADS, 1, TRAIN_RATE, seed, True, 0,
                                     TP_HEADS)
        leaves = _sdpa_leaves(qkv, TP_HEADS)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask.bool()[:, None, None, :], dropout_p=TRAIN_RATE)
        sdpa_dout = dout.view(TP_N, L, TP_HEADS, -1).transpose(1, 2)
        yield dict(
            case=f"model rank bf16 N={TP_N} L={L} heads {TP_HEADS} dropout {TRAIN_RATE}",
            dtype=torch.bfloat16,
            kernel=lambda: mha.mha_backward(qkv, mask, dout, TP_HEADS, TRAIN_RATE, seed, 1,
                                            out, stats, 0, TP_HEADS),
            plain=lambda: mha.mha_backward_reference(qkv, mask, dout, TP_HEADS, 1,
                                                     TRAIN_RATE, seed, 0, TP_HEADS),
            library=lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                retain_graph=True),
            errors=lambda got, want, rel: mha_grad_errors(got, want, rel, TP_HEADS),
            bound=bound_ms(_nbytes(qkv, out, dout, stats, mask, qkv),
                           5 * 2 * TP_N * TP_HEADS * L * L * (HIDDEN // HEADS),
                           torch.bfloat16),
            route="w2_model" if L == TRAIN_SAPO else None, phases=TP_PHASES)
    # the end-to-end tools' micro-batches
    for name, (D, heads, _, dtype, N, _, lengths, phases) in TOOL_TOWERS.items():
        for L in lengths:
            seed = 2 ** 50 + N + L
            qkv, mask = _mha_inputs(dev, g, N, L, dtype, D)
            dout = torch.randn(N, L, D, device=dev, generator=g).to(dtype)
            out, stats = mha._launch_fwd(qkv, mask, heads, 1, TRAIN_RATE, seed, True)
            leaves = _sdpa_leaves(qkv, heads)
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask.bool()[:, None, None, :], dropout_p=TRAIN_RATE)
            sdpa_dout = dout.view(N, L, heads, -1).transpose(1, 2)
            yield dict(
                case=f"{name} {str(dtype)[6:]} N={N} L={L} D={D} dropout {TRAIN_RATE}",
                dtype=dtype,
                kernel=lambda: mha.mha_backward(qkv, mask, dout, heads, TRAIN_RATE, seed, 1,
                                                out, stats),
                plain=lambda: mha.mha_backward_reference(qkv, mask, dout, heads, 1,
                                                         TRAIN_RATE, seed),
                library=lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                    retain_graph=True),
                errors=lambda got, want, rel: mha_grad_errors(got, want, rel, heads),
                bound=bound_ms(_nbytes(qkv, out, dout, stats, mask, qkv),
                               5 * 2 * N * heads * L * L * (D // heads), dtype),
                route=TOOL_ROUTES.get(name) if L == lengths[0] else None,
                phases=phases)


def _ln_inputs(dev, g, T, dtype, D=HIDDEN):
    x = torch.randn(T, D, device=dev, generator=g).to(dtype)
    h = torch.randn(T, D, device=dev, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    bias = 0.1 * torch.randn(D, device=dev, generator=g)
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
    # the training micro-batches; in fp32 those of fp32_train
    for N, L, dtype in ((TRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (TRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (PRETRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (PRETRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (TRAIN_N, TRAIN_SAPO, torch.float32),
                        (TRAIN_N, TRAIN_TITLE, torch.float32),
                        (MESH_N, TRAIN_SAPO, torch.bfloat16),
                        (MESH_N, TRAIN_TITLE, torch.bfloat16),
                        (TP_N, TRAIN_SAPO, torch.bfloat16),
                        (TP_N, TRAIN_TITLE, torch.bfloat16)):
        T, seed = N * L, 2 ** 42 + L
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        yield dict(
            case=f"{str(dtype)[6:]} T={T} dropout {TRAIN_RATE}", dtype=dtype,
            kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, TRAIN_RATE,
                                                       1e-5, seed),
            plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-5,
                                                  TRAIN_RATE, seed),
            library=lambda: torch.nn.functional.layer_norm(
                x + torch.nn.functional.dropout(h, TRAIN_RATE), (HIDDEN,), scale_t,
                bias_t, 1e-5),
            bound=bound_ms(_nbytes(x, h, scale, bias, x), 9 * T * HIDDEN,
                           torch.float32),
            main=N == TRAIN_N and L == TRAIN_SAPO and dtype == torch.bfloat16,
            route="w2" if (N, L) == (MESH_N, TRAIN_SAPO) else None,
            phases=(FP32_LN_PHASES if dtype == torch.float32 else
                    TRAIN_PHASES if N == TRAIN_N else MESH_PHASES if N == MESH_N
                    else TP_PHASES if N == TP_N else ("pretrain",)))
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
    # 512 x 159 without; a cached-history micro-batch's 80 x 128 and 80 x 32
    for N, L, rate, dtype, phases in UNISREC_MHA_CASES[:2] + CACHED_MHA_CASES:
        T, seed = N * L, 2 ** 47 + N
        x, h, scale, bias = _ln_inputs(dev, g, T, dtype)
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        yield dict(
            case=f"{'cached' if N == CACHED_N else 'unisrec'} bf16 T={T} dropout {rate}",
            dtype=dtype,
            kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, rate, 1e-12,
                                                       seed),
            plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-12, rate, seed),
            library=lambda: torch.nn.functional.layer_norm(
                x + torch.nn.functional.dropout(h, rate), (HIDDEN,), scale_t, bias_t, 1e-12),
            bound=bound_ms(_nbytes(x, h, scale, bias, x), (9 if rate else 8) * T * HIDDEN,
                           torch.float32),
            phases=phases)
    # the end-to-end tools' towers: a micro-batch's rows with dropout, a
    # cache-fill chunk's without
    for name, (D, _, eps, dtype, train_n, fill_n, lengths, phases) in TOOL_TOWERS.items():
        for L in lengths:
            for N, rate in ((train_n, TRAIN_RATE), (fill_n, 0.0)):
                if N is None:
                    continue
                T, seed = N * L, 2 ** 51 + N + L
                x, h, scale, bias = _ln_inputs(dev, g, T, dtype, D)
                scale_t, bias_t = scale.to(dtype), bias.to(dtype)
                yield dict(
                    case=f"{name} {str(dtype)[6:]} T={T} D={D} dropout {rate}", dtype=dtype,
                    kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, rate, eps,
                                                               seed),
                    plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, eps, rate, seed),
                    library=lambda: torch.nn.functional.layer_norm(
                        x + torch.nn.functional.dropout(h, rate), (D,), scale_t, bias_t, eps),
                    bound=bound_ms(_nbytes(x, h, scale, bias, x),
                                   (9 if rate else 8) * T * D, torch.float32),
                    route=(TOOL_ROUTES.get(name) if rate and L == lengths[0] else None),
                    phases=phases)


def add_ln_bwd_cases(dev, g):
    from miner_tpu_torch.ops import add_ln, philox

    for N, L, dtype in ((TRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (TRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (TRAIN_N, TRAIN_SAPO, torch.float32),
                        (TRAIN_N, TRAIN_TITLE, torch.float32),
                        (PRETRAIN_N, TRAIN_SAPO, torch.bfloat16),
                        (PRETRAIN_N, TRAIN_TITLE, torch.bfloat16),
                        (UNBERT_TRAIN_B, UNBERT_WORD, torch.bfloat16),
                        (UNBERT_TRAIN_B, UNBERT_NEWS, torch.bfloat16),
                        (TRAIN_N, UNISREC_L, torch.bfloat16),
                        (CACHED_N, TRAIN_SAPO, torch.bfloat16),
                        (CACHED_N, TRAIN_TITLE, torch.bfloat16),
                        (MESH_N, TRAIN_SAPO, torch.bfloat16),
                        (MESH_N, TRAIN_TITLE, torch.bfloat16),
                        (TP_N, TRAIN_SAPO, torch.bfloat16),
                        (TP_N, TRAIN_TITLE, torch.bfloat16)):
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
            route="w2" if (N, L) == (MESH_N, TRAIN_SAPO) else None,
            phases=(FP32_LN_PHASES if dtype != torch.bfloat16
                    else MESH_PHASES if N == MESH_N
                    else TP_PHASES if N == TP_N
                    else ("pretrain",) if N == PRETRAIN_N
                    else ("unbert_train",) if N == UNBERT_TRAIN_B
                    else ("unisrec_train_all",) if L == UNISREC_L
                    else ("his_cache_train",) if N == CACHED_N
                    else tuple(p for p in TRAIN_PHASES if p in BWD_PHASES)))
    # the end-to-end tools' micro-batches
    for name, (D, _, eps, dtype, N, _, lengths, phases) in TOOL_TOWERS.items():
        for L in lengths:
            T, seed = N * L, 2 ** 52 + N + L
            x, h, scale, bias = _ln_inputs(dev, g, T, dtype, D)
            dy = torch.randn(T, D, device=dev, generator=g).to(dtype)
            leaves = [t.detach().clone().requires_grad_() for t in (x, h, scale, bias)]
            y = torch.nn.functional.layer_norm(leaves[0] + leaves[1], (D,),
                                               leaves[2].to(dtype), leaves[3].to(dtype), eps)

            def mask_check():
                keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, dev), TRAIN_RATE)
                dh = add_ln.add_ln_backward(x, h, scale, dy, eps, TRAIN_RATE, seed)[1]
                mismatches = int(((dh != 0) != keep).sum())
                return mismatches == 0, f"mask mismatches {mismatches}"

            yield dict(
                case=f"{name} {str(dtype)[6:]} T={T} D={D} dropout {TRAIN_RATE}", dtype=dtype,
                kernel=lambda: add_ln.add_ln_backward(x, h, scale, dy, eps, TRAIN_RATE, seed),
                plain=lambda: add_ln.add_ln_backward_reference(x, h, scale, dy, eps,
                                                               TRAIN_RATE, seed),
                library=lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                check=mask_check,
                bound=bound_ms(_nbytes(x, h, dy, x, h), 20 * T * D, torch.float32),
                route=TOOL_ROUTES.get(name) if L == lengths[0] else None,
                phases=phases)


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
    bf16 and fp32 (the fp32 route's own row entry at 32; at 1, a request
    of one user), and at 32 with a quarter of the rows fully masked (users
    with no clicks: the mean of the 50 real history rows); under
    --legacy_poly_mask (the launch's fill 1e-30 in place of logits + bias:
    pads keep a weight), bf16 and fp32 at 32 with a quarter of the rows
    fully masked and the rest of random length; and fp32 at the PLM's D =
    768 (a Miner without --apply_reduce_dim, which the lstm combine sends
    down the fp32 route: D split across a cluster of 8) at 16 and 64; and
    bf16 at D = 768 (a Miner without --apply_reduce_dim, the no_reduce
    phases: D split across a cluster of 8) at 1, 16, 32 and 64, under
    both fills (the B = 32 -1e9 case is the row's ``bf16_d768`` entry)."""
    from miner_tpu_torch.ops import poly_attention

    legacy = poly_attention.LEGACY_FILL
    f32, bf16 = torch.float32, torch.bfloat16
    for B, dtype, masked, fill, D in (
            (TRAIN_B, bf16, 0, None, DIM), (MAX_BATCH, bf16, 0, None, DIM),
            (EVAL_B, bf16, 0, None, DIM), (1, f32, 0, None, DIM), (TRAIN_B, f32, 0, None, DIM),
            (MAX_BATCH, f32, 0, None, DIM), (EVAL_B, f32, 0, None, DIM),
            (MAX_BATCH, bf16, MAX_BATCH // 4, None, DIM),
            (MAX_BATCH, f32, MAX_BATCH // 4, None, DIM),
            (MAX_BATCH, bf16, MAX_BATCH // 4, legacy, DIM),
            (MAX_BATCH, f32, MAX_BATCH // 4, legacy, DIM),
            (TRAIN_B, f32, 0, None, HIDDEN), (EVAL_B, f32, 0, None, HIDDEN),
            *((B, bf16, 0, fill, HIDDEN) for B in (1, TRAIN_B, MAX_BATCH, EVAL_B)
              for fill in (None, legacy)),
            (MESH_B, bf16, 0, None, DIM)):  # a data rank's 32 eval rows: the B = 32 case
        args = _poly_inputs(dev, g, B, dtype, masked, D=D) + ((fill,) if fill else ())
        yield dict(
            case=f"{str(dtype)[6:]} B={B}" + (f", {masked} rows fully masked" if masked else "")
            + (" legacy fill" if fill else "") + (f", D={D}" if D != DIM else ""),
            dtype=dtype,
            kernel=lambda: poly_attention.poly_attention_fused(*args),
            plain=lambda: poly_attention.poly_attention_reference(*args),
            library=None,
            bound=_poly_bound(args[:5]),
            main=dtype == bf16 and B == MAX_BATCH and not masked and D == DIM and not fill,
            route=("fp32" if dtype == f32 and B == MAX_BATCH and not masked and D == DIM
                   else "bf16_d768" if dtype == bf16 and B == MAX_BATCH and D == HIDDEN
                   and not fill else "w2" if B == MESH_B else None))


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
    tensor cores) and fp32 (the CUDA cores); and bf16 and int8 rows at the
    PLM's D = 768 (the no_reduce phases: bf16 rows in one gather buffer) at
    the three serving shapes. Beside each bf16 and int8 case the yardstick
    of the PyTorch calls computing the same function."""
    from miner_tpu_torch.ops import lookup_score
    from miner_tpu_torch.utils import candidate_bucket

    shapes = ((MAX_BATCH, 16), (MAX_BATCH, candidate_bucket(NUM_NEWS)), (EVAL_B, 1))
    cases = [(dtype, dtype, NUM_NEWS + 1, B, C)
             for dtype in (torch.bfloat16, torch.float32) for B, C in shapes]
    cases.append((torch.bfloat16, torch.bfloat16, MIND_NEWS + 1, 8, candidate_bucket(MIND_NEWS)))
    cases += [(torch.int8, int_dt, NUM_NEWS + 1, B, C)
              for int_dt in (torch.bfloat16, torch.float32) for B, C in shapes]
    cases.append((torch.int8, torch.bfloat16, MIND_NEWS + 1, 8, candidate_bucket(MIND_NEWS)))
    cases = [case + (DIM,) for case in cases]
    # the PLM's D = 768 (the no_reduce phases): one gather buffer for bf16 rows;
    # fp32 rows (the lstm combine's) in tiles of 32 candidates, one buffer
    cases += [(cache_dt, int_dt, NUM_NEWS + 1, B, C, HIDDEN)
              for cache_dt, int_dt in ((torch.bfloat16, torch.bfloat16),
                                       (torch.int8, torch.bfloat16),
                                       (torch.float32, torch.float32)) for B, C in shapes]
    # a rank's shapes over a mesh: a data rank's half eval batch, and a
    # table rank's shard (half the corpus and a zero row) at a whole one
    cases += [(torch.bfloat16, torch.bfloat16, NUM_NEWS + 1, MESH_EVAL_B, 1, DIM),
              (torch.bfloat16, torch.bfloat16, NUM_NEWS // 2 + 2, EVAL_B, 1, DIM)]
    for cache_dt, int_dt, N, B, C, D in cases:
        args, nbytes = _lookup_inputs(dev, g, N, B, C, CODES, D, cache_dt, int_dt)
        topk = N == NUM_NEWS + 1 and C == candidate_bucket(NUM_NEWS)
        yield dict(
            case=f"{str(cache_dt)[6:]}/{str(int_dt)[6:]} N={N} B={B} C={C}"
            + (f" D={D}" if D != DIM else ""), dtype=int_dt,
            kernel=lambda: lookup_score.lookup_score_fused(*args),
            plain=lambda: lookup_score.lookup_score_reference(*args),
            library=None,
            yardstick=(_lookup_yardstick(*args)
                       if cache_dt in (torch.bfloat16, torch.int8) else None),
            check=(lambda: lookup_nan_check(*args)) if C == 16 else None,
            bound=bound_ms(nbytes, 2 * B * C * CODES * D, int_dt),
            main=cache_dt == torch.bfloat16 and topk and D == DIM,
            route=("int8" if cache_dt == torch.int8 and int_dt == torch.bfloat16 and topk
                   and D == DIM else "bf16_d768" if cache_dt == torch.bfloat16 and topk
                   and D == HIDDEN else "fp32_d768" if cache_dt == torch.float32 and topk
                   and D == HIDDEN else "w2" if N == NUM_NEWS // 2 + 2 else None))


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
            phases=FF_CASE_PHASES[what] if dtype == torch.float32 and " " not in what
            else ())


def offset_slice_checks(dev, g) -> list:
    """A rank's launches against the whole batch's: mha forward and
    backward at the train shape (bf16, N = 880, L = 128, dropout 0.1) over
    data rank 1's sequences of a micro-batch of 16 users at ``--mesh_data
    2`` (two runs of them, its candidates' and its history's, one launch
    each: ``philox.Offsets``) and model rank 1's heads (6-11) at
    ``--mesh_model 2``; add_ln forward and backward over those sequences'
    rows. Each output must be its slice of the whole launch's bit for bit,
    masks included (dropped elements are zeros where the whole launch's
    are). Returns the failures."""
    from miner_tpu_torch.ops import add_ln, mha, philox

    C, H = 5, HIS  # 1 + 4 candidates and 50 history news a user
    B, half = TRAIN_N // (C + H), TRAIN_N // (C + H) // 2
    offset = ((0, half * C), (half * C, (B - half) * C + half * H))  # data rank 1
    n = half * (C + H)
    pick = philox.row_places(offset, n, dev)
    seed, L, Dh = 2 ** 47 + 1, TRAIN_SAPO, HIDDEN // HEADS
    qkv, mask = _mha_inputs(dev, g, TRAIN_N, L, torch.bfloat16)
    dout = torch.randn(TRAIN_N, L, HIDDEN, device=dev, generator=g).to(torch.bfloat16)
    out, stats = mha._launch_fwd(qkv, mask, HEADS, 1, TRAIN_RATE, seed, True)
    dqkv = mha.mha_backward(qkv, mask, dout, HEADS, TRAIN_RATE, seed, 1, out, stats)

    def heads(x, parts):  # model rank 1's heads of a (n, L, parts x 768) tensor
        return x.view(n, L, parts, HEADS, Dh)[:, :, :, TP_HEADS:].reshape(n, L, -1).contiguous()

    mine = heads(qkv[pick], 3)
    m = mask[pick].contiguous()
    got, got_stats = mha._launch_fwd(mine, m, TP_HEADS, 1, TRAIN_RATE, seed, True, offset,
                                     TP_HEADS)
    got_d = mha.mha_backward(mine, m, heads(dout[pick], 1), TP_HEADS, TRAIN_RATE, seed, 1,
                             got, got_stats, offset, TP_HEADS)
    T = TRAIN_N * L
    x, h, scale, bias = _ln_inputs(dev, g, T, torch.bfloat16)
    dy = torch.randn(T, HIDDEN, device=dev, generator=g).to(torch.bfloat16)
    rows = (pick[:, None] * L + torch.arange(L, device=dev)).reshape(-1)
    y = add_ln.fused_dropout_add_ln(x, h, scale, bias, TRAIN_RATE, 1e-5, seed)
    dx, dh, _, _ = add_ln.add_ln_backward(x, h, scale, dy, 1e-5, TRAIN_RATE, seed)
    rows_offset = philox.scaled(offset, L)
    got_y = add_ln.fused_dropout_add_ln(x[rows], h[rows], scale, bias, TRAIN_RATE, 1e-5, seed,
                                        rows_offset)
    got_dx, got_dh, _, _ = add_ln.add_ln_backward(x[rows], h[rows], scale, dy[rows], 1e-5,
                                                  TRAIN_RATE, seed, rows_offset)
    torch.cuda.synchronize()
    pairs = {"mha_fwd out": (got, heads(out[pick], 1)),
             "mha_fwd stats": (got_stats, stats[pick][:, TP_HEADS:]),
             "mha_bwd dqkv": (got_d, heads(dqkv[pick], 3)),
             "add_ln_fwd y": (got_y, y[rows]), "add_ln_bwd dx": (got_dx, dx[rows]),
             "add_ln_bwd dh": (got_dh, dh[rows])}
    failures = []
    for what, (a, b) in pairs.items():
        same = torch.equal(a, b)
        log(f"  offsets: {what} of data rank 1 (sequences {offset}, two launches) and model "
            f"rank 1 (heads {TP_HEADS}-{HEADS - 1}): {'bit-equal to' if same else 'DIFFERS from'}"
            f" its slice of the whole batch's launch {tuple(b.shape)}")
        if not same:
            failures.append(f"offsets: {what} differs from the whole launch's slice")
    return failures


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
            try:
                got = _outputs(c["kernel"]())
            except ValueError as e:  # another version's plan refuses the shape
                if names is None:
                    raise
                log(f"  {name:18s} {c['case']:30s} refused: {e}")
                continue
            want = _outputs(c["plain"]())
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
                                      "library_ms": library_ms, "yardstick_ms": yard_ms}
            del got, want
            torch.cuda.empty_cache()
        row.update(routes)
        rows.append(row)
    if ((names is None or {"mha_fwd", "mha_bwd", "add_ln_fwd", "add_ln_bwd"} & set(names))
            and takes_offsets()):
        failures += offset_slice_checks(dev, g)
    if failures:
        raise SystemExit("kernel phase failed:\n  " + "\n  ".join(failures))
    return rows, timed


def _mha_shape(args, first: int):
    """An fp32 mha launch's (N, L, H, Dh, seqs, dropout rate, stats kept)
    from its C arguments (N at ``first``), or None for another type."""
    N, L, H, Dh, seqs = args[first:first + 5]
    inv_keep, dropping = args[first + 7:first + 9]
    code = args[first + 11]  # past the sequence and head offsets
    if code != 0:  # common.DTYPE_CODES[torch.float32]
        return None
    rate = round(1.0 - 1.0 / inv_keep, 6) if dropping else 0.0
    return N, L, H, Dh, seqs, rate, first == 7 or args[3] is not None


class LaunchCensus:
    """The main path's launches of poly-attention, lookup+score and the
    fp32 mha kernels by shape and phase: the batch (and candidate count) of
    the first two follows the phase and the serving batcher, fp32 mha runs
    at the shapes of fp32_train and of the parity phases' one impression,
    and their time follows the shape. It reads the C arguments each launch
    passes through ``common.launch`` while ``phase`` is set, and launches
    and counts nothing itself. ``EVERY``: the kernels all of whose launches
    it counts (mha's bf16 launches are counted by phase instead)."""

    SHAPE = {"poly_attention_fwd": lambda a: tuple(a[6:12]),  # B, H, D, P, K, dtype code
             # N, B, C, K, D, cache, interests codes
             "lookup_score_fwd": lambda a: tuple(a[5:12]),
             "mha_fwd": lambda a: _mha_shape(a, 4),
             "mha_bwd": lambda a: _mha_shape(a, 7)}
    EVERY = ("poly_attention_fwd", "lookup_score_fwd")

    def __init__(self):
        import collections

        self.phase = None
        self.counts = collections.Counter()

    def install(self) -> None:
        from miner_tpu_torch.ops import common

        launch = common.launch

        def counted(name, fn, *args):
            if self.phase is not None and name in self.SHAPE:
                shape = self.SHAPE[name](args)
                if shape is not None:
                    self.counts[(name, self.phase, shape)] += 1
            return launch(name, fn, *args)

        common.launch = counted

    def launched(self, name: str, phase: str) -> int:
        return sum(n for (k, p, _), n in self.counts.items() if k == name and p == phase)


CENSUS = LaunchCensus()


def _census_mha(dev, g, name, shape):
    """A call of an fp32 mha kernel at a census shape, and its bound."""
    from miner_tpu_torch.ops import mha

    N, L, H, Dh, seqs, rate, with_stats = shape
    qkv = torch.randn(N, L, 3 * H * Dh, device=dev, generator=g)
    lengths = torch.randint(1, L + 1, (N,), device=dev, generator=g)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).to(torch.int32)
    seed = 2 ** 48 + L
    out, stats = mha._launch_fwd(qkv, mask, H, seqs, rate, seed, True)
    flops = 4 * N * H * L * L * Dh
    if name == "mha_fwd":
        fn = lambda: mha._launch_fwd(qkv, mask, H, seqs, rate, seed, with_stats)  # noqa: E731
        nbytes = _nbytes(qkv, mask, out, *((stats,) if with_stats else ()))
    else:
        dout = torch.randn_like(out)
        fn = lambda: mha.mha_backward(qkv, mask, dout, H, rate, seed, seqs,  # noqa: E731
                                      out, stats)
        flops, nbytes = flops * 5 // 2, _nbytes(qkv, out, dout, stats, mask, qkv)
    what = f"fp32 N={N} L={L} dropout {rate}" + (f" seqs {seqs}" if seqs > 1 else "")
    return fn, bound_ms(nbytes, flops, torch.float32)[0], what


def _width(D: int) -> str:
    return f" D={D}" if D != DIM else ""


# the route entries of a row that take their share of the census's shapes,
# by the shape's label: poly-attention's fp32 route, and poly-attention's
# and lookup+score's bf16 launches at the PLM's D = 768
ROUTE_SHAPES = {"fp32": lambda what: what.startswith("float32"),
                "bf16_d768": lambda what: what.startswith("bfloat16")
                and what.endswith(f"D={HIDDEN}")}


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
        if name in ("mha_fwd", "mha_bwd"):
            fn, b_ms, what = _census_mha(dev, g, name, shape)
        elif name == "poly_attention_fwd":
            B, H, D, P, K, code = shape
            args = _poly_inputs(dev, g, B, dtypes[code], 0, H, D, P, K)
            fn = lambda: poly_attention.poly_attention_fused(*args)
            (b_ms, _), what = _poly_bound(args), f"{str(dtypes[code])[6:]} B={B}{_width(D)}"
        else:
            N, B, C, K, D, code, int_code = shape
            cache_dt = torch.int8 if code == common.INT8_CODE else dtypes[code]
            args, nbytes = _lookup_inputs(dev, g, N, B, C, K, D, cache_dt, dtypes[int_code])
            fn = lambda: lookup_score.lookup_score_fused(*args)
            b_ms, _ = bound_ms(nbytes, 2 * B * C * K * D, dtypes[int_code])
            what = f"{str(cache_dt)[6:]} B={B} C={C}{_width(D)}"
        ms, call_ms = graph_ms(fn), device_ms(fn, 0.05)
        out.setdefault(name, []).append(dict(shape=what, launches_by_phase=by_phase,
                                             ms=ms, call_ms=call_ms, bound_ms=b_ms))
        log(f"  {name:18s} {what:18s} launches {by_phase}  kernel {ms:.4f} ms "
            f"({call_ms:.4f} a call back to back)  bound {b_ms:.4f} ms")
    return out


def launch_weighted_gaps(rows, timed, sweep) -> None:
    """Each row's launches x (time - bound), summed over the shapes its
    launches took: the census's shapes for the launches it counted (all of
    poly-attention's and lookup+score's, mha's in fp32); for the rest, each
    phase's launches at the cases standing for it. The launches of the
    parity phases, which only the census counts, join the row's here."""
    import collections

    for row in rows:
        name = row["name"]
        shapes = sweep.get(name, [])
        census = collections.Counter()
        for sh in shapes:
            census.update(sh["launches_by_phase"])
        gap = sum(n * (sh["ms"] - sh["bound_ms"]) for sh in shapes
                  for n in sh["launches_by_phase"].values())
        by_phase = row["launches_by_phase"]
        for phase, n in census.items():
            by_phase.setdefault(phase, n)
        row["launches"] = sum(by_phase.values())
        if name in LaunchCensus.EVERY:
            if shapes:
                row["shapes"] = shapes
            for route, picks in ROUTE_SHAPES.items():  # a route's share
                if route not in row:
                    continue
                sub = [sh for sh in shapes if picks(sh["shape"])]
                n_r = sum(sum(sh["launches_by_phase"].values()) for sh in sub)
                gap_r = sum(n * (sh["ms"] - sh["bound_ms"]) for sh in sub
                            for n in sh["launches_by_phase"].values())
                row[route].update(launches=n_r, launch_weighted_gap_ms=gap_r)
                log(f"  {name:18s} {route}: {n_r} launches, launch-weighted gap "
                    f"{gap_r:.3f} ms")
        else:
            if shapes:  # mha: its fp32 launches
                row["fp32"].update(shapes=shapes, launches=sum(census.values()),
                                   launches_by_phase=dict(census),
                                   launch_weighted_gap_ms=gap)
                log(f"  {name:18s} fp32: {sum(census.values())} launches, "
                    f"launch-weighted gap {gap:.3f} ms")
            for phase, n in by_phase.items():
                n -= census[phase]
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


def serve_args(corpus: str, *extra: str, drop=()):
    """The parsed :func:`serve_words`."""
    from miner_tpu_torch.config import make_parser

    return make_parser().parse_args(serve_words(corpus, *extra, drop=drop))


def serve_words(corpus: str, *extra: str, drop=()):
    """``config/serve_miner.txt`` as it stands, on the synthetic corpus, with
    the hash tokenizer over roberta-base's vocabulary size (no tokenizer
    files here). Its checkpoint and persisted cache are dropped: the caller
    names a checkpoint of the train phase in ``extra``, or none for random
    weights from the seed, and a cache file in the temporary directory, or
    none to encode the corpus at every start."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = (derived_config(os.path.dirname(corpus), "serve_miner.txt", drop) if drop
            else os.path.join(here, "config", "serve_miner.txt"))
    words = _config_words(path)
    for flag in ("--saved_model_path", "--serve_cache_path"):
        i = words.index(flag)
        del words[i:i + 2]
    return ["serve", *words, "--pretrained_tokenizer", "hash:50265",
            "--user2id_path", os.path.join(corpus, "user2id.json"),
            "--category2id_path", os.path.join(corpus, "category2id.json"),
            "--eval_news_path", os.path.join(corpus, "news.tsv"),
            "--port", "0", *extra]


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


def _check_native(phase: str, kind: str, calls=None) -> dict:
    """The native data plane's calls since the phase's reset (``calls``: a
    rank's report of them), logged. Fails the phase where its kind has a
    native path and it took none (no quiet numpy fallback): the Miner's,
    Fastformer's and UniSRec's samplers (``sample_epoch``), UnBERT's packer
    (``pack_unbert``). The pretrain kind's sampler is numpy only, as the
    JAX package's is."""
    from miner_tpu_torch.data import native

    calls = native.call_counts() if calls is None else calls
    want = {"unbert": "pack_unbert", "pretrain": None}.get(kind, "sample_epoch")
    log(f"{phase}: native data plane calls {calls}"
        + ("" if want else " (the pretrain sampler is numpy only, as in JAX)"))
    if want and not calls[want]:
        raise SystemExit(f"{phase} phase: the native {want} never ran ({calls})")
    return calls


def _check_trace(phase: str, directory: str) -> None:
    """Fail the phase unless ``RunLogger.trace`` wrote its Chrome trace
    (this process's, rank 0) under the run directory, naming kernels."""
    path = os.path.join(directory, "rank0.pt.trace.json")
    size = os.path.getsize(path) if os.path.isfile(path) else 0
    head = ""
    if size:
        with open(path, errors="replace") as f:
            head = f.read(1 << 20)
    log(f"{phase}: RunLogger.trace wrote {path} ({size / 2 ** 20:.1f} MiB)")
    if not size or '"traceEvents"' not in head:
        raise SystemExit(f"{phase} phase: no Chrome trace at {path}")


# UniSRec's one tower call a micro-batch: 12 layers of two add_ln sites;
# its backward (--unisrec_train_all) the same in reverse. The Miner's two
# tower calls (titles, sapos) under --remat: 24 mha forwards, one a layer
# (the recompute takes the saved context, as JAX's remat does), 24 backwards
PER_BATCH = {"unisrec_train": {"mha_fwd": 12, "add_ln_fwd": 24},
             "ep_unisrec": {"mha_fwd": 12, "add_ln_fwd": 24},
             "tp_train": {"mha_fwd": 24, "mha_bwd": 24},
             "unisrec_train_all": {"mha_bwd": 12, "add_ln_bwd": 24},
             **{phase: {"mha_fwd": 24, "mha_bwd": 24}
                for phase in ("train", "no_reduce_train", "remat_dots_train")}}


def _check_d768(phase: str) -> None:
    """Fail the phase unless it launched bf16 poly-attention at the PLM's
    D = 768 (the census: B, H, D, P, K, dtype code); log those launches and
    lookup+score's at that width."""
    from miner_tpu_torch.ops import common

    bf16 = common.DTYPE_CODES[torch.bfloat16]
    width = {"poly_attention_fwd": 2, "lookup_score_fwd": 4}  # D's place in the shape
    shapes = {(name, shape): n for (name, p, shape), n in CENSUS.counts.items()
              if p == phase and name in width and shape[width[name]] == HIDDEN}
    poly = sum(n for (name, shape), n in shapes.items()
               if name == "poly_attention_fwd" and shape[5] == bf16)
    log(f"{phase}: launches at D = {HIDDEN}: {poly} bf16 poly_attention_fwd; by shape "
        f"{ {f'{name} {shape}': n for (name, shape), n in sorted(shapes.items())} }")
    if not poly:
        raise SystemExit(f"{phase} phase: no bf16 poly_attention_fwd launch at D = {HIDDEN}")


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

    args = serve_args(corpus, "--saved_model_path", checkpoint, *SERVE_FLAGS.get(phase, ()),
                      drop=DERIVED.get(phase, ()))
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


# the requests of serve_cache_phase's fresh bf16 start and its replies
SERVED = {}


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
        if not int8:
            SERVED[f"{prefix}serve_cache"] = (reqs, bodies0)
        log(f"{phase}: start-up fresh {fresh_s:.2f} s, loaded {loaded_s:.2f} s; the loaded "
            f"cache and its {len(reqs)} replies equal the fresh ones bit for bit")
    nbytes = {k: sum(_nbytes(a) for a in v[:-1]) for k, v in arrays.items()}
    log(f"{prefix}serve_cache: cache bytes (rows and scales) int8 {nbytes[True]}, "
        f"{arrays[False][0].dtype} {nbytes[False]} ({nbytes[True] / nbytes[False]:.3f}x)")
    return counts


def reference_roundtrip_phase(corpus: str, tmp: str, finals: dict) -> dict:
    """Checkpoints to the reference (MrRobot2211/miner) and back, through
    the port's tools: each train phase's ``finalModel`` in ``finals``
    (family: path; Miner, Fastformer, UnBERT) exported by ``python -m
    miner_tpu_torch.tools.export_to_reference`` and the file imported by
    ``import_reference_checkpoint`` (``--force_layout_mismatch`` for the
    position-sensitive families: the weights are what is compared); every
    parameter must come back bit for bit. Host work; then the re-imported
    Miner is served (``serve_miner.txt``, the cache encoded at start-up)
    and must answer the serve_cache phase's requests, one at a time, with
    its fresh start's replies bit for bit. Returns the serving launch
    counts."""
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.serving import ScoringService
    from miner_tpu_torch.tools import export_to_reference, import_reference_checkpoint
    from miner_tpu_torch.training import checkpoint
    from miner_tpu_torch.training.trainer import Trainer

    back = {}
    for family, final in finals.items():
        ref = os.path.join(tmp, f"{family}_reference.pt")
        back[family] = os.path.join(tmp, f"{family}_reimported")
        gate = () if family == "miner" else ("--force_layout_mismatch",)
        t0 = time.perf_counter()
        export_to_reference.main(["--ckpt", final, "--model_name", family, "--out", ref,
                                  *gate])
        export_s = time.perf_counter() - t0
        want = checkpoint.load(final)["params"]
        layers = sum(k.startswith("news_encoder.plm.layers.") and k.endswith(".qkv.weight")
                     for k in want)  # the tower's depth (UnBERT's is read from the file)
        import_reference_checkpoint.main(["--torch_ckpt", ref, "--model_name", family,
                                          "--num_layers", str(max(layers, 1)), "--out",
                                          back[family], *gate])
        import_s = time.perf_counter() - t0 - export_s
        got = checkpoint.load(back[family])["params"]
        moved = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        n_ref = len(torch.load(ref, weights_only=True))
        log(f"reference_roundtrip: {family}: {len(want)} tensors "
            f"({sum(v.numel() for v in want.values()) / 1e6:.1f} M values) -> {n_ref} "
            f"reference tensors ({os.path.getsize(ref) / 2 ** 20:.0f} MiB) in "
            f"{export_s:.2f} s -> {len(got)} back in {import_s:.2f} s; "
            f"{len(want) - len(moved)} bit-equal")
        if moved or set(got) != set(want):
            raise SystemExit(f"reference_roundtrip phase: {family}: changed {moved[:5]}, "
                             f"extra {sorted(set(got) - set(want))[:5]}")
    reqs, want_bodies = SERVED["serve_cache"]
    args = serve_args(corpus, "--saved_model_path", back["miner"])
    reset_launch_counts()
    CENSUS.phase = "roundtrip_serve"
    t0 = time.perf_counter()
    service = ScoringService(Trainer(args))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    try:
        replies, _ = _serve_requests(service, args, reqs, 1, "roundtrip_serve")
        counts = launch_counts()
    finally:
        CENSUS.phase = None
        service.close()
    same = [body for _, body, _ in replies] == want_bodies
    log(f"roundtrip_serve: the re-imported Miner: start-up {startup_s:.2f} s; {len(reqs)} "
        f"requests one at a time, replies bit-equal to serve_cache's: {same}; launches "
        f"{counts}")
    _check_launches("roundtrip_serve", counts)
    if not same:
        raise SystemExit("roundtrip_serve phase: the re-imported Miner's replies differ")
    return counts


# ------------------------------------------------------------------ UnBERT
class PackTimer:
    """Host time of UnBERT's packing (``unbert_packing.pack_rows``: the
    native C++ packer at the default backend, a batch a call): each call's
    rows and seconds while ``phase`` is set. It wraps the function where
    the batcher's blocks and the serving path look it up, and changes
    nothing of what it returns."""

    def __init__(self):
        self.phase = None
        self.calls = {}

    def install(self) -> None:
        from miner_tpu_torch.data import unbert_packing
        from miner_tpu_torch.training import trainer

        pack = unbert_packing.pack_rows

        def timed(packer, cand, hist, backend="auto"):
            t0 = time.perf_counter()
            out = pack(packer, cand, hist, backend)
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

    from miner_tpu_torch.data import native
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training.trainer import Trainer

    run_dir = os.path.dirname(os.path.dirname(final_model))
    with open(os.path.join(run_dir, "eval.csv")) as f:
        train_auc = max(float(r["auc"]) for r in csv.DictReader(f))
    best = os.path.join(run_dir, "ckpt", "bestAucModel")
    phase = "unbert_eval_standalone"
    reset_launch_counts()
    native.reset_call_counts()
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
    _check_native(phase, "unbert")
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

    from miner_tpu_torch.data import native
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.serving import ScoringService
    from miner_tpu_torch.training.trainer import Trainer

    phase = "unbert_serve"
    args = unbert_serve_args(corpus, checkpoint)
    reset_launch_counts()
    native.reset_call_counts()
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
    _check_native(phase, "unbert")
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


# ------------------------------------------------------------ native data
# a train log of about MIND-small's size (its 51,282 news; 200,000 click
# events of 10 to 60 negatives each; 50 history news; titles of 32), with
# the 3 augmentation variants of the hard mode's configs (V = 4)
NATIVE_EVENTS, NATIVE_NEWS, NATIVE_NEGS, NATIVE_VARIANTS = 200_000, 51_282, (10, 60), 4
NUMPY_BUDGET_S = 1.0  # the numpy sampler's slice of the log, per mode
PACK_CALLS = {"native": 200, "numpy": 10}


def _native_log(rng):
    """The synthetic log and store of ``native_sampler_phase``, from a seed,
    no file I/O: events' positives and negatives uniform over the news,
    each event its own history of 5 to 50 clicks, pads after them."""
    import numpy as np

    from miner_tpu_torch.data.behaviors import BehaviorsLog
    from miner_tpu_torch.data.news_store import NewsStore

    E, N, V, H = NATIVE_EVENTS, NATIVE_NEWS, NATIVE_VARIANTS, HIS
    counts = rng.integers(NATIVE_NEGS[0], NATIVE_NEGS[1] + 1, E)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    history = rng.integers(1, N, (E, H)).astype(np.int32)
    history[np.arange(H)[None, :] >= rng.integers(5, H + 1, E)[:, None]] = 0
    empty = np.zeros(0, np.int32)
    log_ = BehaviorsLog(
        user=np.zeros(E, np.int32), history=history, hist_ptr=np.arange(E, dtype=np.int32),
        pos_row=rng.integers(1, N, E).astype(np.int32),
        impression_id=np.arange(E, dtype=np.int32),
        neg_flat=rng.integers(1, N, int(offsets[-1])).astype(np.int32), neg_offsets=offsets,
        eval_hist_ptr=empty, eval_user=empty, eval_impression_id=empty, eval_cand_flat=empty,
        eval_label_flat=np.zeros(0, np.int8), eval_offsets=np.zeros(1, np.int32),
        max_his_click=H)
    title = rng.integers(3, 30_000, (V, N, TRAIN_TITLE)).astype(np.int32)
    title[np.arange(TRAIN_TITLE)[None, None, :] >= rng.integers(
        4, TRAIN_TITLE + 1, (V, N))[..., None]] = 0
    store = NewsStore(title=title, sapo=np.zeros((V, N, 1), np.int32),
                      category=np.zeros((V, N), np.int32), id_to_row={},
                      variants=["vanilla", *(f"aug{i}" for i in range(1, V))],
                      pad_token_id=0, category_pad_id=0)
    return log_, store


def native_sampler_phase(smi: str) -> None:
    """Host phase: the port's native data plane (``data/native.py``, g++ at
    first use; a failed build or load fails the run) against its numpy
    path on a log of about MIND-small's train size (``_native_log``). An
    epoch's ``sample_epoch`` in modes base and hard (npratio 4): native over
    the whole log, numpy over the first events it samples in about
    ``NUMPY_BUDGET_S``; UnBERT's ``pack_rows`` at a train micro-batch (16
    rows) and at the largest serving call (512 rows), native against numpy
    (the same arrays, checked equal). Printed with the card's name and power
    limit and the host's CPU."""
    import dataclasses
    import platform

    import numpy as np

    from miner_tpu_torch.data import native
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.data.unbert_packing import UnbertPacker, pack_rows

    phase = "native_sampler"
    t0 = time.perf_counter()
    native.load()  # raises with the compiler's output
    log(f"{phase}: native library {os.path.relpath(native.library_path())} loaded in "
        f"{time.perf_counter() - t0:.2f} s (g++ at first use)")
    cpu = next((line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                if line.startswith("model name")), platform.processor())
    where = f"host {cpu}, {os.cpu_count()} cores; card {smi}"
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    log_, store = _native_log(rng)
    log(f"{phase}: {NATIVE_EVENTS} events over {NATIVE_NEWS} news x {NATIVE_VARIANTS} "
        f"variants, {len(log_.neg_flat)} negatives, made in {time.perf_counter() - t0:.1f} s")
    native.reset_call_counts()
    for mode in ("base", "hard"):
        sampler = OnlineSampler(log_, store, 4, seed=7, mode=mode, backend="native")
        t0 = time.perf_counter()
        block = sampler.sample_epoch(0)
        native_s = time.perf_counter() - t0
        n = 1000  # numpy events: a first slice sizes the one timed within the budget
        for _ in range(2):
            part = dataclasses.replace(log_, pos_row=log_.pos_row[:n],
                                       hist_ptr=log_.hist_ptr[:n],
                                       impression_id=log_.impression_id[:n],
                                       neg_offsets=log_.neg_offsets[:n + 1])
            slow = OnlineSampler(part, store, 4, seed=7, mode=mode, backend="numpy")
            t0 = time.perf_counter()
            ref = slow.sample_epoch(0)
            numpy_s = time.perf_counter() - t0
            if numpy_s >= 0.5 * NUMPY_BUDGET_S:
                break
            n = min(NATIVE_EVENTS, int(n * NUMPY_BUDGET_S / max(numpy_s, 1e-3)))
        per_native, per_numpy = native_s / NATIVE_EVENTS, numpy_s / n
        ok = bool((block.label.sum(1) == 1).all() and (ref.label.sum(1) == 1).all()
                  and block.cand.shape == (NATIVE_EVENTS, 5))
        log(f"{phase}: sample_epoch {mode}: native {NATIVE_EVENTS} events in "
            f"{native_s:.3f} s ({1e6 * per_native:.3f} us an event); numpy {n} events in "
            f"{numpy_s:.3f} s ({1e6 * per_numpy:.1f} us an event, the whole log "
            f"{per_numpy * NATIVE_EVENTS:.1f} s at that rate); native "
            f"{per_numpy / per_native:.0f}x faster; {where}")
        if not ok:
            raise SystemExit(f"{phase} phase: a {mode} epoch's rows are not one-hot")
    packer = UnbertPacker(store, cls_id=101, sep_id=102, pad_id=0)
    for rows in (UNBERT_TRAIN_B, UNBERT_SERVE_B):
        cand = rng.integers(1, NATIVE_NEWS * NATIVE_VARIANTS, rows).astype(np.int32)
        hist = log_.history[rng.integers(0, NATIVE_EVENTS, rows)]
        ms, outs = {}, {}
        for backend, calls in PACK_CALLS.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                outs[backend] = pack_rows(packer, cand, hist, backend)
            ms[backend] = 1e3 * (time.perf_counter() - t0) / calls
        same = all(np.array_equal(outs["native"][k], outs["numpy"][k]) for k in outs["numpy"])
        log(f"{phase}: pack_rows at {rows} rows of {UNBERT_WORD} tokens: native "
            f"{ms['native']:.3f} ms a call ({PACK_CALLS['native']} calls), numpy "
            f"{ms['numpy']:.3f} ms ({PACK_CALLS['numpy']} calls), native "
            f"{ms['numpy'] / ms['native']:.0f}x faster; equal: {same}; {where}")
        if not same:
            raise SystemExit(f"{phase} phase: the native packer's rows differ from numpy's")
    _check_native(phase, "miner")


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
                                 "unisrec_train_all_eval"),
                 # HIS_CACHE_FLAGS on top of train_miner.txt and train_fastformer.txt
                 "his_cache": ("train", "train_miner.txt", "his_cache_train", "his_cache_eval"),
                 "fastformer_his_cache": ("train_fastformer", "train_fastformer.txt",
                                          "fastformer_his_cache_train",
                                          "fastformer_his_cache_eval"),
                 # LSTM_LEGACY_FLAGS on top of train_miner.txt
                 "lstm_legacy": ("train", "train_miner.txt", "lstm_legacy_train",
                                 "lstm_legacy_eval"),
                 # train_miner.txt without --apply_reduce_dim (DERIVED)
                 "no_reduce": ("train", "train_miner.txt", "no_reduce_train", "no_reduce_eval"),
                 # train_miner.txt with --remat_policy dots (SHORT_FLAGS)
                 "remat_dots": ("train", "train_miner.txt", "remat_dots_train",
                                "remat_dots_eval"),
                 # over a mesh of ranks (MESH_PHASES): --mesh_data 2, its eval;
                 # float32 at W = 2 and at W = 1; --mesh_data 2 --mesh_table 2
                 "mesh": ("train", "train_miner.txt", "mesh_train", None),
                 "mesh_parity": ("train", "train_miner.txt", "mesh_parity_fp32", None),
                 "mesh_his_cache": ("train", "train_miner.txt", "mesh_his_cache", None),
                 # --mesh_model 2: the Miner at TP_B rows a micro-batch; the
                 # fp32 parity; UniSRec's experts sharded
                 "tp": ("train", "train_miner.txt", "tp_train", None),
                 "mesh_parity_tp": ("train", "train_miner.txt", "mesh_parity_tp", None),
                 "ep_unisrec": ("train_fastformer", "train_unisrec.txt", "ep_unisrec", None)}
# the flags a derived configuration drops from the file it is derived from
# (each on a line of its own there): a Miner without --apply_reduce_dim,
# whose news vectors keep the PLM's D = 768, trained and served
DERIVED = {"no_reduce": ("--apply_reduce_dim",), "no_reduce_serve": ("--apply_reduce_dim",)}
# the depth of the epoch of the phases cut for time: their impressions (16
# a micro-batch) and the flags they add; no_reduce 2 micro-batches at
# accumulation 2 (one update), remat_dots 4 at accumulation 4 (one update),
# unbert 30 (3 updates; 5 packed rows an impression); the mesh phases: mesh
# 8 micro-batches at accumulation 4 (2 updates), mesh_parity (and its
# --mesh_model 2 twin) 2 at accumulation 2 (one update, at the full rate: no
# warmup) in float32 with the config's dropout (its --mesh_model 2 twin at
# TP_B rows a micro-batch: each all-reduce of fp32 activations crosses the
# host), mesh_his_cache 6 at accumulation 2 (the cache built at micro-step
# 2, rebuilt at 4), tp 3 of TP_B at accumulation 3 (one update), ep_unisrec
# 2 at accumulation 2
SHORT_IMPRESSIONS = {"no_reduce": 32, "remat_dots": 64, "mesh": 128, "mesh_parity": 32,
                     "mesh_parity_tp": 2 * TP_B, "mesh_his_cache": 96, "unbert": 96,
                     "tp": 3 * TP_B, "ep_unisrec": 32}
# the micro-batch of the phases that take another than their config's 16
SHORT_BATCH = {"tp": TP_B, "mesh_parity_tp": TP_B}
PARITY_FLAGS_FP32 = ("--gradient_accumulation_steps", "2", "--compute_dtype", "float32",
                     "--warmup_steps", "0")
SHORT_FLAGS = {"no_reduce": ("--gradient_accumulation_steps", "2"),
               "remat_dots": ("--remat_policy", "dots", "--gradient_accumulation_steps", "4"),
               "mesh": ("--gradient_accumulation_steps", "4"),
               "mesh_parity": PARITY_FLAGS_FP32,
               "mesh_parity_tp": PARITY_FLAGS_FP32 + ("--train_batch_size", str(TP_B)),
               "mesh_his_cache": HIS_CACHE_FLAGS,
               "tp": ("--train_batch_size", str(TP_B), "--gradient_accumulation_steps", "3"),
               "ep_unisrec": ("--gradient_accumulation_steps", "2")}
# the families trained without their config's eval (and its best
# checkpoint: 1.5 GB fewer written to disk each)
NO_EVAL = ("mesh", "mesh_parity", "mesh_parity_tp", "mesh_his_cache", "tp", "ep_unisrec")
# "his_cache": the Miner's cached-history micro-batch (the candidates through
# the towers, the history from a cache filled on the card)
PARITY_FAMILIES = ("miner", "fastformer", "unbert", "unisrec", "his_cache")
# the flags each family's parity phase adds: UniSRec trains its PLM too, so
# that every tower gradient is compared
PARITY_FLAGS = {"unisrec": ("--unisrec_train_all",)}
# the hash tokenizer over each family's vocabulary size: roberta-base's, and
# bert-base's for UnBERT and UniSRec (bert_base preset); no tokenizer files here
TOKENIZERS = {"unbert": "hash:30522", "unisrec": "hash:30522", "unisrec_all": "hash:30522",
              "ep_unisrec": "hash:30522"}
# serve_miner.txt's flags overridden for a family's checkpoint
SERVE_FLAGS = {"fastformer_serve": ("--model_name", "fastformer"),
               "lstm_legacy_serve": LSTM_LEGACY_FLAGS,
               "unisrec_serve": ("--model_name", "unisrec", "--plm_preset", "bert_base",
                                 "--pretrained_tokenizer", TOKENIZERS["unisrec"],
                                 "--combine_type", "pre-concat")}


# the median micro-batch of each train phase, in ms (the cached-history
# phases print theirs beside the full-history ones), and its peak memory
MICRO_BATCH_MS, PEAK_GIB = {}, {}
# the train phases whose last micro-batches torch.profiler traces: the
# device's busy time a micro-batch against the median of the others, and
# where it goes (the profiled micro-batches stay out of the median)
PROFILED_PHASES = ("train", "fastformer_train", "his_cache_train", "fastformer_his_cache_train",
                   "remat_dots_train")
PROFILED_STEPS = 3
# substrings of the hand-written kernels' names in a trace (csrc's entry
# points and the Triton add_ln forward)
OWN_KERNELS = ("mha_fwd_", "mha_bwd_", "add_ln_fwd", "add_ln_bwd_kernel", "poly_attention_",
               "lookup_score_", "fastformer_attn_fwd_kernel")


def micro_batches(family: str) -> int:
    """One epoch's micro-batches of 16 over the 256 train impressions (the
    phases cut for time: their ``SHORT_IMPRESSIONS``): one a impression, or
    for UnBERT five packed rows an impression (one candidate drawn per
    visit, five visits)."""
    impressions = SHORT_IMPRESSIONS.get(family, TRAIN_IMPRESSIONS)
    return impressions * (5 if family == "unbert" else 1) // SHORT_BATCH.get(family, 16)


def derived_config(directory: str, name: str, drop) -> str:
    """``config/<name>`` without the lines of the flags in ``drop``, written
    to ``directory`` (``config/`` stays as it is); returns its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "config", name)) as f:
        lines = [line for line in f if line.split()[:1] not in ([flag] for flag in drop)]
    path = os.path.join(directory, name.replace(".txt", "_derived.txt"))
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _config_words(path: str):
    from miner_tpu_torch.config import convert_arg_line_to_args

    words = []
    with open(path) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    return words


def write_short_behaviors(corpus: str) -> None:
    """The first ``SHORT_IMPRESSIONS`` lines of the train behaviors, for
    each phase cut for time, under ``train_<family>/``."""
    with open(os.path.join(corpus, "train", "behaviors.tsv")) as f:
        lines = f.readlines()
    for family, n in SHORT_IMPRESSIONS.items():
        os.makedirs(os.path.join(corpus, f"train_{family}"), exist_ok=True)
        with open(os.path.join(corpus, f"train_{family}", "behaviors.tsv"), "w") as f:
            f.writelines(lines[:n])


def train_args(corpus: str, out: str, *extra: str, family: str = "miner"):
    """The parsed :func:`train_words`."""
    from miner_tpu_torch.config import make_parser

    return make_parser().parse_args(train_words(corpus, out, *extra, family=family))


def train_words(corpus: str, out: str, *extra: str, family: str = "miner"):
    """``config/train_miner.txt`` (or for ``family`` "fastformer"
    ``config/train_fastformer.txt`` under ``train_fastformer``, "pretrain"
    ``config/pretrain_miner.txt`` under ``pretrain``, "hard"
    ``config/train_miner_hard.txt``, "unbert" ``config/train_unbert.txt``
    and "unisrec" / "unisrec_all" ``config/train_unisrec.txt`` under
    ``train_fastformer``) as it stands, on the synthetic corpus and
    behaviors, with the hash tokenizer over the PLM's vocabulary
    (``TOKENIZERS``), random init, and one epoch; a ``DERIVED`` family reads
    a configuration derived from the file, written under ``out``; one cut
    for time (``SHORT_IMPRESSIONS``) trains on its first impressions with
    its ``SHORT_FLAGS``; a family of ``NO_EVAL`` runs no eval. The
    subcommand and its words."""
    mode, config = TRAIN_CONFIGS[family][:2]
    here = os.path.dirname(os.path.abspath(__file__))
    path = (derived_config(out, config, DERIVED[family]) if family in DERIVED
            else os.path.join(here, "config", config))
    words = _config_words(path)
    behaviors = (os.path.join(corpus, f"train_{family}", "behaviors.tsv")
                 if family in SHORT_IMPRESSIONS else os.path.join(corpus, "train", "behaviors.tsv"))
    for flag, value in (
            ("--pretrained_tokenizer", TOKENIZERS.get(family, "hash:50265")),
            ("--user2id_path", os.path.join(corpus, "user2id.json")),
            ("--category2id_path", os.path.join(corpus, "category2id.json")),
            ("--train_behaviors_path", behaviors),
            ("--train_news_path", os.path.join(corpus, "news.tsv")),
            ("--eval_behaviors_path", os.path.join(corpus, "valid", "behaviors.tsv")),
            ("--eval_news_path", os.path.join(corpus, "news.tsv")),
            ("--num_train_epochs", "1")):
        words[words.index(flag) + 1] = value
    if family in NO_EVAL:
        at = words.index("--eval_behaviors_path")
        del words[at:at + 2]
    return [mode, *words, "--train_path", os.path.join(out, family),
            *SHORT_FLAGS.get(family, ()), *extra]


def linking_repeats(save):
    """``checkpoint.save`` for one training run, in which a checkpoint saved
    at the micro-step of the one saved last (finalModel after the epoch's
    eval, bestAucModel beside bestLossModel: the same payload) becomes a
    hard link to that file. The card's machine stops a call at 45 GiB
    written to its disk, deleted files included, and a full-width
    checkpoint (fp32 masters and Adam's moments) takes 1.5 GB; the port
    itself writes every checkpoint in full."""
    last = {}

    def linking(path, payload):
        if "path" in last and last["step"] == payload["micro_step"]:
            tmp = f"{path}.link"
            os.link(last["path"], tmp)
            os.replace(tmp, path)
        else:
            save(path, payload)
        last.update(step=payload["micro_step"], path=path)

    return linking


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

    from miner_tpu_torch.data import native
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
    apply_and_loss, cached_loss = trainer._apply_and_loss, trainer._cached_his_loss
    # cached-history training: each micro-batch's phase (``phase`` for the
    # cached ones, ``{phase}_warmup`` for the full-history ones), the
    # launches of each, and each cache refill's time and launches
    # (``{phase}_refill``), apart from the micro-batch it sits in
    step_phase, step_counts, refill_s, refill_in_step, caches = [], {}, [], [], []
    sub_phase = lambda kind: f"{phase.rsplit('_train', 1)[0]}_{kind}"  # noqa: E731
    # device memory peaks (bytes): before the first cached micro-batch (the
    # stats are reset there), and of the micro-batches at the eval's start
    peaks = {}
    profile_from = (micro_batches(family) - PROFILED_STEPS if phase in PROFILED_PHASES
                    else None)
    profiler = []
    make_cache, fill = trainer.make_history_cache, trainer.fill_history_cache

    def captured_cache(*a, **k):
        caches.append(make_cache(*a, **k))
        return caches[-1]

    ledger = {"phase": None, "at": None}

    def charge(to):
        """Charge the launches since the last call to the phase then
        current, and make ``to`` current (None: no phase)."""
        now = launch_counts()
        if ledger["phase"] is not None:
            counts = step_counts.setdefault(ledger["phase"], {n: 0 for n in now})
            for n in now:
                counts[n] += now[n] - ledger["at"][n]
        ledger.update(phase=to, at=now)
        CENSUS.phase = to or phase

    def timed_fill(*a, **k):
        torch.cuda.synchronize()
        outer, t0 = ledger["phase"], time.perf_counter()
        charge(sub_phase("refill"))
        out = fill(*a, **k)
        torch.cuda.synchronize()
        refill_s.append(time.perf_counter() - t0)
        charge(outer)
        return out

    def measured_forward(*a, **k):
        out = apply_and_loss(*a, **k)
        after_fwd.append(torch.cuda.memory_allocated() / 2 ** 30)
        return out

    def measured_cached_forward(*a, **k):
        out = cached_loss(*a, **k)
        after_fwd.append(torch.cuda.memory_allocated() / 2 ** 30)
        return out

    def timed_step(*a, **k):
        if len(step_s) == profile_from:  # RunLogger.trace into the run directory
            profiler.append(trainer.run_logger.trace())
            profiler.append(profiler[0].__enter__())
        held.append(torch.cuda.memory_allocated() / 2 ** 30)
        cache = a[5] if len(a) > 5 else k.get("his_cache")
        name = phase if cache is None or cache.cached(a[4]) else sub_phase("warmup")
        if cache is not None and name == phase and "warmup" not in peaks:
            peaks["warmup"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        step_phase.append(name)
        charge(name)
        fills, t0 = len(refill_s), time.perf_counter()
        loss = train_step(*a, **k)
        step_loss.append(float(loss))  # synchronises
        step_s.append(time.perf_counter() - t0)
        refill_in_step.append(sum(refill_s[fills:]))
        charge(None)
        if profiler and len(step_s) == profile_from + PROFILED_STEPS:
            profiler[0].__exit__(None, None, None)
        return loss

    def timed_eval(*a, **k):
        before_eval.update(launch_counts())
        peaks.setdefault("steps", torch.cuda.max_memory_allocated())
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
    trainer._cached_his_loss = measured_cached_forward
    trainer.make_history_cache = captured_cache
    trainer.fill_history_cache = timed_fill
    # what earlier phases left in reference cycles (their models and
    # optimizer states among them) is freed first, so the peak is this run's
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    native.reset_call_counts()
    CENSUS.phase = phase
    save, checkpoint.save = checkpoint.save, linking_repeats(checkpoint.save)
    t0 = time.perf_counter()
    try:
        run = trainer.train()
        torch.cuda.synchronize()
    finally:
        CENSUS.phase = None
        checkpoint.save = save
    wall_s = time.perf_counter() - t0
    _check_native(phase, trainer.kind)
    counts = launch_counts()
    eval_counts = {k: counts[k] - before_eval[k] for k in counts}
    with open(os.path.join(run.run_dir, "eval.csv")) as f:
        evals = list(csv.DictReader(f))
    # the loss column is empty under train_miner.txt's --evaluation_info metrics
    metrics = {k: float(v) for k, v in evals[-1].items()
               if k not in ("epoch", "step") and v != ""}
    (cache,) = caches
    # a cached-history run's micro-batch is a cached one, its refill apart;
    # the profiled ones are left out
    unprofiled = len(step_s) if profile_from is None else profile_from
    # a phase cut to fewer micro-batches than it profiles takes the median
    # of the profiled ones (the first, with the compiles, apart)
    steady = (sorted(step_s[1:unprofiled]) or sorted(step_s[1:])) if cache is None else sorted(
        t - r for t, r, n in zip(step_s[:unprofiled], refill_in_step, step_phase) if n == phase)
    mid = steady[len(steady) // 2]
    MICRO_BATCH_MS[phase] = 1e3 * mid
    PEAK_GIB[phase] = max(peaks.get("warmup", 0), torch.cuda.max_memory_allocated()) / 2 ** 30
    accum = args.gradient_accumulation_steps
    if trainer.kind == "pretrain":  # the positive, its variants, the negatives
        what = f"{args.train_batch_size * (1 + len(args.augmentations or ()) + args.npratio)} news"
    elif trainer.kind == "unbert":
        what = f"packed rows of {UNBERT_WORD} tokens and {UNBERT_NEWS} sentences"
    elif cache is not None:
        what = (f"{args.train_batch_size * (args.npratio + 1)} news through the towers past "
                f"the warmup, {args.train_batch_size * (args.npratio + 1 + args.his_length)} "
                "before")
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
        f"{PEAK_GIB[phase]:.2f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"{phase}: optimizer updates (clip, AdamW; in the micro-batch times above) "
        f"{[round(1e3 * t, 1) for t in update_s]} ms")
    log(f"{phase}: device memory of the last micro-batch: {held[-1]:.2f} GiB held "
        f"at its start (weights, optimizer state, gradient sums), "
        f"{after_fwd[len(held) - 1]:.2f} GiB after its forward (the forwards "
        f"of the eval, if any, come later)")
    log(f"{phase}: losses {[round(x, 4) for x in step_loss]}")
    log(f"{phase}: eval {metrics}")
    if profiler:
        _report_profile(phase, trainer.run_logger.profiler, 1e3 * mid)
        _check_trace(phase, profiler[1])
    if cache is not None:
        _report_history_cache(phase, args, cache, step_s, step_phase, refill_s,
                              refill_in_step, peaks, unprofiled)
    per_batch = {k: step_counts[phase][k] / step_phase.count(phase) for k in step_counts[phase]}
    log(f"{phase}: kernel launches per micro-batch {per_batch}; in the eval "
        f"{eval_counts}")
    bad = [x for x in step_loss + list(metrics.values()) if not math.isfinite(x)]
    if (bad or run.optimizer.updates != len(step_s) // accum
            or len(step_s) != micro_batches(family)):
        raise SystemExit(f"{phase} phase: non-finite {bad}, {run.optimizer.updates} "
                         f"updates, {len(step_s)} micro-batches")
    for name, c in step_counts.items():
        if name != phase:
            log(f"{name}: kernel launches {c}")
        _check_launches(name, c)
    _check_launches(eval_phase, eval_counts)
    _check_per_batch(phase, per_batch)
    if family in DERIVED:  # poly-attention in bf16 at the PLM's D = 768
        for name in (phase, eval_phase):
            _check_d768(name)
    if phase == "remat_dots_train":
        log(f"{phase}: --remat_policy dots against --remat alone (the train phase): "
            f"micro-batch {MICRO_BATCH_MS[phase]:.1f} ms against "
            f"{MICRO_BATCH_MS.get('train', float('nan')):.1f} ms, peak {PEAK_GIB[phase]:.2f} "
            f"GiB against {PEAK_GIB.get('train', float('nan')):.2f} GiB")
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
    return {**step_counts, eval_phase: eval_counts}, final


def _report_profile(phase: str, prof, median_ms: float, steps: int = PROFILED_STEPS,
                    against: str = "of the others") -> None:
    """The device's busy time a micro-batch over the ``steps`` profiled ones
    (the sum of the kernels and copies the trace shows, one stream; the
    device-side copies of annotated ranges, such as the optimizer's step,
    left out), against the median micro-batch ``against`` says, and the
    kernels that take it: the hand-written ones (mha's forward and
    backward apart), cuBLAS's products, the rest."""
    per_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, calls = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    per = lambda us: us / 1e3 / steps  # noqa: E731
    total = per(sum(us for us, _ in per_name.values()))
    if total == 0:
        log(f"{phase}: torch.profiler saw no device time: device busy share not measured")
        return
    own = per(sum(us for n, (us, _) in per_name.items() if any(k in n for k in OWN_KERNELS)))
    gemm = per(sum(us for n, (us, _) in per_name.items() if not any(k in n for k in OWN_KERNELS)
                   and any(k in n.lower() for k in ("nvjet", "gemm", "xmma", "cutlass", "cublas"))))
    mha = {k: per(sum(us for n, (us, _) in per_name.items() if f"mha_{k}_" in n))
           for k in ("fwd", "bwd")}
    log(f"{phase}: torch.profiler over the last {steps} micro-batches: device busy "
        f"{total:.2f} ms a micro-batch against the {median_ms:.1f} ms median {against} "
        f"(busy share {total / median_ms:.1%}): hand-written kernels {own:.2f} ms (mha "
        f"forward {mha['fwd']:.2f}, backward {mha['bwd']:.2f}), cuBLAS products "
        f"{gemm:.2f} ms, the rest {total - own - gemm:.2f} ms, over "
        f"{sum(c for _, c in per_name.values()) / steps:.0f} launches a micro-batch")
    for name, (us, calls) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {per(us):8.3f} ms, {calls / steps:6.1f} calls a micro-batch  "
            f"{name[:90]}")


def _report_history_cache(phase, args, cache, step_s, step_phase, refill_s,
                          refill_in_step, peaks, unprofiled) -> None:
    """A cached-history run's figures, and its refills against JAX's rule
    (``miner_tpu/training/trainer.py:759-766``): micro-steps below the
    warmup (W x accumulation) on the full history; the cache built at the
    first cached micro-step (it starts empty) and rebuilt at every multiple
    of K x accumulation."""
    steps = len(step_s)
    rule = [s for s in range(steps)
            if s >= cache.warmup and (s == cache.warmup or s % cache.every == 0)]
    cached = [(1e3 * (t - r), r > 0) for t, r, n in zip(step_s, refill_in_step, step_phase)
              if n == phase]
    timed = cached[:len(cached) - (steps - unprofiled)]  # the profiled ones apart
    plain = sorted(ms for ms, refilled in timed if not refilled)
    net = sorted(ms for ms, _ in timed)
    full = [round(1e3 * t, 1) for t, n in zip(step_s, step_phase) if n != phase]
    batch = args.train_batch_size
    log(f"{phase}: --his_cache_refresh {args.his_cache_refresh} --his_cache_warmup_steps "
        f"{args.his_cache_warmup_steps} at accumulation {args.gradient_accumulation_steps}: "
        f"{steps - len(cached)} full-history micro-batches {full} ms (the first with kernel "
        f"compiles), then {len(cached)} cached ({batch} x {args.npratio + 1} candidates "
        f"through the PLM, {args.his_length} history rows a user from the cache)")
    log(f"{phase}: cached micro-batch {net[len(net) // 2]:.1f} ms median of {len(net)} "
        f"(its refill apart), {plain[len(plain) // 2]:.1f} ms median of the {len(plain)} "
        f"without a refill; {1e3 * batch / net[len(net) // 2]:.2f} examples/s; "
        f"train's full-history micro-batch {MICRO_BATCH_MS.get('train', float('nan')):.1f} "
        f"ms, fastformer_train's {MICRO_BATCH_MS.get('fastformer_train', float('nan')):.1f} ms")
    log(f"{phase}: cache refills at micro-steps {cache.fills} (JAX's rule: {rule}), "
        f"{[round(1e3 * t, 1) for t in refill_s]} ms each, {cache.embeddings.shape[0]} "
        f"news of {cache.embeddings.shape[1]} in {cache.embeddings.dtype}")
    log(f"{phase}: peak memory {peaks['warmup'] / 2 ** 30:.2f} GiB up to the last "
        f"full-history micro-batch, {peaks['steps'] / 2 ** 30:.2f} GiB over the cached ones "
        f"and their refills")
    if cache.fills != rule or len(refill_s) != len(rule):
        raise SystemExit(f"{phase} phase: refills at {cache.fills} ({len(refill_s)} timed), "
                         f"JAX's rule gives {rule}")


def fp32_train_phase(corpus: str, out: str) -> dict:
    """``train_miner.txt`` with ``--compute_dtype float32`` at full width
    (roberta-base towers, titles 32 / sapo 128, 50 history news, 1 + 4
    candidates, batch 16, --remat, dropout) for ``FP32_MICRO_BATCHES``
    micro-batches at accumulation 4, one optimizer update, through
    ``Trainer.train_step``: the split-TF32 mha kernels' main path. The
    first micro-batch warms up; the others are traced by torch.profiler
    (mha's device time against cuBLAS's and the rest), and their median is
    the micro-batch time. Both fp32 mha kernels must launch. Returns the
    launch counts of the micro-batches."""
    import gc

    from miner_tpu_torch.data import native
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.observability.logging import RunLogger
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training.trainer import Trainer

    phase = "fp32_train"
    native.reset_call_counts()
    trainer = Trainer(train_args(corpus, out, "--compute_dtype", "float32",
                                 "--gradient_accumulation_steps",
                                 str(FP32_MICRO_BATCHES)))
    a = trainer.args
    store = trainer._load_store(a.train_news_path)
    block = OnlineSampler(trainer._load_log(a.train_behaviors_path, store), store, a.npratio,
                          seed=a.seed).sample_epoch(0)
    B = a.train_batch_size
    model = trainer.initial_model().to(trainer.device).train()
    table = trainer._make_table(store)
    optimizer = trainer.make_optimizer(model, 1, 0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    CENSUS.phase = phase
    step_s, losses = [], []

    def micro_batch(i):
        rows = slice(i * B, (i + 1) * B)
        batch = {"cand_idx": block.cand[rows], "his_idx": block.his[rows],
                 "label": block.label[rows]}
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(model, table, batch, optimizer, i)))
        step_s.append(time.perf_counter() - t0)

    logger = RunLogger(os.path.join(out, phase), phase)
    try:
        micro_batch(0)
        with logger.trace() as trace_dir:
            for i in range(1, FP32_MICRO_BATCHES):
                micro_batch(i)
    finally:
        CENSUS.phase = None
    prof = logger.profiler
    _check_trace(phase, trace_dir)
    _check_native(phase, trainer.kind)
    counts = launch_counts()
    traced = sorted(step_s[1:])
    mid = 1e3 * traced[len(traced) // 2]
    MICRO_BATCH_MS[phase] = mid
    log(f"{phase}: Miner, {len(step_s)} micro-batches of {B} "
        f"({B * (a.npratio + 1 + a.his_length)} news per micro-batch), "
        f"{optimizer.updates} optimizer update at accumulation "
        f"{a.gradient_accumulation_steps}, {a.compute_dtype}, --remat {a.remat}, dropout "
        f"{a.dropout} / {TRAIN_RATE}: micro-batch {mid:.1f} ms median of the "
        f"{len(traced)} traced (first {1e3 * step_s[0]:.1f} ms), {B / mid * 1e3:.2f} "
        f"examples/s; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"on {torch.cuda.get_device_name(0)}; train_miner.txt's bf16 micro-batch "
        f"{MICRO_BATCH_MS.get('train', float('nan')):.1f} ms")
    log(f"{phase}: losses {[round(x, 4) for x in losses]}")
    _report_profile(phase, prof, mid, steps=len(traced), against="of these")
    fp32 = {k: CENSUS.launched(k, phase) for k in ("mha_fwd", "mha_bwd")}
    log(f"{phase}: kernel launches {counts}; fp32 mha {fp32}")
    if (not all(math.isfinite(x) for x in losses) or optimizer.updates != 1
            or not all(fp32.values()) or fp32["mha_fwd"] != counts["mha_fwd"]):
        raise SystemExit(f"{phase} phase: losses {losses}, {optimizer.updates} updates, "
                         f"fp32 mha launches {fp32} of {counts}")
    _check_launches(phase, counts)
    return counts


def train_parity_half(corpus: str, out: str, family: str, device: str,
                      cache_emb=None) -> dict:
    """One device's half of a train parity phase (:func:`train_parity_phase`):
    the loss, every trainable parameter's gradient (on the CPU), UnBERT's
    serving scores and, for "his_cache", the history cache it used (filled
    here on the card unless ``cache_emb`` is given)."""
    from miner_tpu_torch.data.samplers import OnlineSampler
    from miner_tpu_torch.training.trainer import Trainer

    import numpy as np

    trainer = Trainer(train_args(corpus, out, "--compute_dtype", "float32",
                                 "--device", device, *PARITY_FLAGS.get(family, ()),
                                 family=family))
    a = trainer.args
    store = trainer._load_store(a.train_news_path)
    log_ = trainer._load_log(a.train_behaviors_path, store)
    if trainer.kind == "unbert":
        batch = trainer._train_sampler(log_, store).sample_epoch(0).materialize(np.arange(2))
    else:
        block = OnlineSampler(log_, store, a.npratio, seed=a.seed).sample_epoch(0)
        batch = {"cand_idx": block.cand[:1], "his_idx": block.his[:1],
                 "label": block.label[:1]}
    model = trainer.build_model().to(trainer.device).eval()
    if a.freeze_transformer:
        model.news_encoder.plm.requires_grad_(False)
    table = trainer._make_table(store)
    CENSUS.phase = f"train_parity_{family}" if device == "cuda" else None
    try:
        if family == "his_cache":
            # one cache for both devices, filled on the card (its rows are
            # held against the CPU's by the parity phase): the cached step's
            # own arithmetic is compared
            if cache_emb is None:
                cache_emb = trainer.fill_history_cache(model, table)
            loss, _ = trainer._cached_his_loss(model, table, batch,
                                               cache_emb.to(trainer.device))
        else:
            loss, _ = trainer._apply_and_loss(model, table, batch)
        loss.backward()
        # a tensor the loss does not reach has no gradient on either device
        # (UniSRec's w_noise: no gating noise in eval mode)
        half = dict(loss=float(loss.detach()), kind=trainer.kind,
                    grads={n: p.grad.float().cpu() for n, p in model.named_parameters()
                           if p.grad is not None},
                    cache=None if cache_emb is None else cache_emb.float().cpu())
        if trainer.kind == "unbert":
            cand = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
            his = np.stack([log_.history[0], log_.history[1]])
            half["scores"] = trainer.serve_scores_unbert(
                model, trainer._unbert_packer(store), cand, his)
    finally:
        CENSUS.phase = None
    return half


def write_parity_corpus(corpus: str) -> None:
    """The corpus of the train phases and the train parity phases."""
    write_corpus(corpus, NUM_NEWS, seed=0)
    write_behaviors(corpus, NUM_NEWS, seed=3)
    write_short_behaviors(corpus)


def side_main(root: str) -> int:
    """The train parity phases (:func:`train_parity_phase`), turnkey
    (:func:`turnkey_phase`) and UniSRec's serving phases in a process of
    their own beside this script's (``chip_smoke.py --side ROOT``,
    :func:`start_side`): the corpus written again under ``root`` from its
    seeds, each family's CPU half (:func:`train_parity_half`) on
    ``CPU_PARITY_THREADS`` of the host's cores beside the kernel phase and
    the serial phases; then, once ``root/go`` is there (:func:`release`,
    with the paths of this script's corpus, its temporary directory and
    UniSRec's ``finalModel``), each family's card half and the comparison
    ("his_cache" takes its CPU half on the cache its card half filled),
    turnkey under ``root``, and unisrec_serve and UniSRec's persisted-cache
    starts (:func:`serve_phase`, :func:`serve_cache_phase`); their launch
    counts and the census of the card's launches written to
    ``root/report.json``."""
    from miner_tpu_torch.data import native

    torch.set_num_threads(CPU_PARITY_THREADS)
    CENSUS.install()
    corpus = os.path.join(root, "corpus")
    write_parity_corpus(corpus)
    cpu = {}
    for family in PARITY_FAMILIES:
        if family != "his_cache":  # its CPU half takes the card's cache
            t0 = time.perf_counter()
            cpu[family] = train_parity_half(corpus, root, family, "cpu")
            log(f"train parity ({family}): the CPU half in {time.perf_counter() - t0:.1f} s")
    while not os.path.exists(os.path.join(root, "go")):
        time.sleep(0.2)
    with open(os.path.join(root, "go")) as f:
        paths = json.load(f)
    log("released onto the card")
    for family in PARITY_FAMILIES:
        native.reset_call_counts()
        card = train_parity_half(corpus, root, family, "cuda")
        _check_native(f"train_parity_{family}", card["kind"])
        if family == "his_cache":
            cpu[family] = train_parity_half(corpus, root, family, "cpu", card["cache"])
        train_parity_phase(family, card, cpu.pop(family))
    counts = {"turnkey": turnkey_phase(root)}
    counts["unisrec_serve"] = serve_phase(paths["corpus"], paths["unisrec"], "unisrec_serve")
    counts.update(serve_cache_phase(paths["corpus"], paths["unisrec"], paths["tmp"], "unisrec"))
    with open(os.path.join(root, "report.json"), "w") as f:
        json.dump({"counts": counts,
                   "census": [[name, phase, list(shape), n]
                              for (name, phase, shape), n in CENSUS.counts.items()]}, f)
    return 0


def start_side(root: str) -> dict:
    """Start :func:`side_main` under ``root``."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(root, "side.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                             "--side", root],
                            stdout=out, stderr=subprocess.STDOUT, env=_port_env(), cwd=here,
                            start_new_session=True)
    return dict(proc=proc, out=out, root=root)


def finish_side(launch: dict) -> dict:
    """Wait for :func:`side_main`'s process (past ``SIDE_TIMEOUT_S`` from
    its release it is stopped), log its lines, fail the run if it failed,
    and add its census to this one's. Returns its phases' launch counts."""
    proc = launch["proc"]
    try:
        proc.wait(timeout=max(1.0, SIDE_TIMEOUT_S - (time.perf_counter() - launch["t0"])))
    except subprocess.TimeoutExpired:
        stop_processes(launch)
    launch["out"].close()
    with open(os.path.join(launch["root"], "side.log"), errors="replace") as f:
        lines = [line for line in f.read().splitlines() if line.startswith("[")]
    for line in lines:  # its own clock: seconds from its start
        log(f"side process {line}")
    if proc.returncode != 0:
        raise SystemExit(f"the side phases: their process exited "
                         f"{proc.returncode} {time.perf_counter() - launch['t0']:.0f} s after "
                         "its release (its log above)")
    with open(os.path.join(launch["root"], "report.json")) as f:
        report = json.load(f)
    for name, phase, shape, n in report["census"]:
        CENSUS.counts[(name, phase, tuple(shape))] += n
    return report["counts"]


def train_parity_phase(family: str, card: dict, cpu: dict) -> None:
    """One micro-batch of one impression (55 news; for UnBERT two packed
    rows of 300 tokens, both towers at full depth) through the full-width
    model in float32 with dropout off, on the card (kernels, their autograd
    Functions: ``card``) and on the CPU (plain versions: ``cpu``), each
    half from :func:`train_parity_half`,
    same weights from the seed:
    the loss and every trainable parameter's gradient must agree (the
    Fastformer's PLM is frozen, as ``--freeze_transformer`` makes it in
    training; UniSRec runs with ``--unisrec_train_all``, so its tower's
    gradients are compared too, and its ``w_noise``, which only the
    training mode's gating noise reaches, has none on either device); for
    UnBERT also the serving scores of two slates of 4, within 1e-3 of their
    scale; "his_cache" is the Miner's cached-history micro-batch: the 5
    candidates through the towers, the 50 history rows gathered from one
    cache of the corpus (filled on the card, a copy on the CPU).
    Tolerance: 1e-3 of each gradient's largest magnitude plus 1e-5 of the
    largest over all gradients, since float32 sums through 12
    layers forward and back are taken in other orders by the kernels and
    cuBLAS than by the plain versions and the CPU's BLAS, and a gradient
    that is a small difference of large terms (the target-aware
    projection's, 1e-7 at random init) carries the absolute rounding of
    those terms."""
    import numpy as np

    if "scores" in card:
        got, want = card["scores"], cpu["scores"]
        err = float(np.abs(got - want).max())
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        log(f"train parity ({family}): serving scores {got.shape} card vs CPU max abs "
            f"err {err:.3g} (tol {tol:.3g})")
        if not (np.isfinite(got).all() and err <= tol):
            raise SystemExit(f"train parity phase ({family}): serving scores disagree "
                             f"({err} > {tol})")
    loss_gpu, grads_gpu = card["loss"], card["grads"]
    loss_cpu, grads_cpu = cpu["loss"], cpu["grads"]
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
        CENSUS.phase = "parity" if device == "cuda" else None
        ctx = trainer.serving_context()
        out[device] = (ctx.cache.embeddings.float().cpu().numpy(),
                       trainer.serve_scores(ctx.model, ctx.cache, cand, his))
        CENSUS.phase = None
    for what, i in (("cache rows", 0), ("scores", 1)):
        got, want = out["cuda"][i], out["cpu"][i]
        err = float(np.abs(got - want).max())
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        log(f"parity: {what} {got.shape} card vs CPU max abs err {err:.3g} "
            f"(tol {tol:.3g})")
        if not (np.isfinite(got).all() and err <= tol):
            raise SystemExit(f"parity phase: {what} disagree ({err} > {tol})")


# ------------------------------------------------------------------- main
# ------------------------------------------------------------------ mesh
# the mesh phases, launched through ``python -m torch.distributed.run
# --standalone`` as subprocesses of this script (``--mesh_rank``), so that
# the port's CLI is the entry point each rank runs; the ranks of one launch
# run its phases one after another (a rank's start-up, 13-20 s, paid once);
# every launch starts after the build and takes its jobs beside the
# untimed phases (hf_import, the parity phases, turnkey, convergence...),
# the timed phases (HELD) held at their first micro-batch until the other
# launches are done; a launcher that outlives MESH_TIMEOUT_S (its ranks
# included) fails the run
MESH_TIMEOUT_S = 600
MESH_RANK = "MESH_RANK "  # the prefix of a rank's report line
HELD = ("mesh_train", "tp_train")  # timed alone on the card, after ``go``


def mesh_rank_main(jobs_path: str) -> int:
    """One rank of a mesh launch, under ``torch.distributed.run``: the
    process group started as the port starts it (the launch's first model
    built on the host, then held until :func:`release_mesh`), then for each
    job of the
    JSON list at ``jobs_path`` (``{"phase", "argv", "grads"}``) the port's
    ``miner_tpu_torch.cli.main(argv)`` with the launch counts set to 0 just
    before it, each micro-batch and optimizer update timed (the card
    synchronised around them), the launches of an eval apart from the
    micro-batches', then one line ``MESH_RANK {json}``: the rank, the world,
    the backend, the launch counts, the global losses, the times, the
    gradient sum's time an update, the peak memory, the history cache's
    rebuilds and a checksum of the final parameters (sha256 of their
    bytes), printed and written to ``<phase>.rank<r>.json``
    beside ``jobs_path`` (ranks printing together can share a line). With
    ``grads`` set, rank 0 saves there the gradients the first update
    applies (summed over the data group, divided, clipped; a sharded leaf
    gathered whole over the model group); each update's global gradient
    norm before the clip is reported. Over the model axis each micro-batch's
    all-reduces of the model group are counted and timed (the card
    synchronised around each), and the shapes of the mha launches recorded.
    A serve job (``"requests"``) runs ``serve`` as the CLI does: on rank 0
    a client thread sends the requests one at a time over HTTP once the
    server is up, keeps the replies, and shuts the server down, which stops
    the other ranks' following."""
    import hashlib
    import threading

    import miner_tpu_torch.training.trainer as port_trainer
    from miner_tpu_torch import cli, serving
    from miner_tpu_torch.data import native
    from miner_tpu_torch.ops import common, launch_counts, reset_launch_counts
    from miner_tpu_torch.parallel import mesh, tp
    from miner_tpu_torch.training.optim import Optimizer

    # a launch started before its jobs are known (start_mesh) waits here,
    # its imports done, until give_jobs writes them
    while not os.path.exists(jobs_path):
        time.sleep(0.2)
    entry = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(jobs_path) as f:
        jobs = json.load(f)
    backend = mesh.maybe_initialize_distributed()
    Trainer = port_trainer.Trainer
    train_step, run_eval, train = Trainer.train_step, Trainer._run_eval, Trainer.train
    make_cache, opt_step = Trainer.make_history_cache, Optimizer.step
    make_optimizer, make_server = Trainer.make_optimizer, serving.make_http_server
    rep, job, held = {}, {}, {}
    launch, reduce_fwd, copy_bwd = (common.launch, tp._ReduceFromModel.forward,
                                    tp._CopyToModel.backward)

    def timed_collective(fn):
        def run(ctx, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(ctx, *a)
            torch.cuda.synchronize()
            rep["tp_s"][-1] += time.perf_counter() - t0
            rep["tp_n"][-1] += 1
            return out
        return staticmethod(run)

    def recorded_launch(name, fn, *args):
        if name == "mha_fwd":  # N, L, heads; the head offset
            shape = f"{args[4]}x{args[5]}x{args[6]}+{args[14]}"
            rep["mha_shapes"][shape] = rep["mha_shapes"].get(shape, 0) + 1
        return launch(name, fn, *args)

    def kept_optimizer(self, model, *a, **k):
        held.update(model=model, model_group=self.mesh.model_group)
        return make_optimizer(self, model, *a, **k)

    def client_server(service, host, port, impl="async"):
        server = make_server(service, host, port, impl)
        if mesh.this_rank() == 0:
            def client():
                url = f"http://{host}:{server.server_address[1]}"
                try:
                    rep["replies"] = [_post(url, r)[1] for r in job["requests"]]
                finally:
                    server.shutdown()
            threading.Thread(target=client, daemon=True).start()
        return server

    def timed_step(self, *a, **k):
        if "first_step" not in rep["at"]:
            go = os.environ.get("CHIP_SMOKE_GO") if job["phase"] in HELD else None
            while go and not os.path.exists(go):  # held until this script says go
                time.sleep(0.05)
            rep["at"]["first_step"] = time.time()
        torch.cuda.synchronize()
        rep["tp_s"].append(0.0)
        rep["tp_n"].append(0)
        t0 = time.perf_counter()
        loss = train_step(self, *a, **k)
        rep["losses"].append(float(loss))  # synchronises
        rep["step_s"].append(time.perf_counter() - t0)
        return loss

    def timed_update(self):
        if job.get("grads") and not rep.get("grads") and self.mini_step + 1 == self.accum_steps:
            adamw_step = self.adamw.step

            def saving(*x, **kw):
                specs, group = tp.specs_of(held["model"]), held["model_group"]
                grads = [tp.gather(p.grad, specs[n], group) if n in specs else p.grad
                         for n, p in zip(self.names, self.params)]
                if mesh.is_writer():
                    torch.save([g.detach().cpu() for g in grads], job["grads"])
                rep["grads"] = job["grads"]
                return adamw_step(*x, **kw)

            self.adamw.step = saving
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        applied = opt_step(self)
        torch.cuda.synchronize()
        if applied:
            rep["update_s"].append(time.perf_counter() - t0)
            rep["sum_s"] = list(self.sum_seconds)
            rep["grad_norms"].append(float(self.grad_norm))
        return applied

    def counted_eval(self, *a, **k):
        before = launch_counts()
        out = run_eval(self, *a, **k)
        rep["eval_counts"] = {n: c - before[n] for n, c in launch_counts().items()}
        return out

    def captured_cache(self, *a, **k):
        cache = make_cache(self, *a, **k)
        if cache is not None:
            rep["cache"] = cache
        return cache

    def summed_train(self):
        run = train(self)
        rep["at"]["trained"] = time.time()
        h = hashlib.sha256()
        for name, t in self.full_state_dict(run.model).items():
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        rep.update(checksum=h.hexdigest(), run_dir=run.run_dir, updates=run.optimizer.updates,
                   mesh=self.mesh.shape, device=str(self.device))
        return run

    release, initial_model = os.path.join(os.path.dirname(jobs_path), "release"), \
        Trainer.initial_model

    def released_model(self):  # built on the host; onto the card once released
        model = initial_model(self)
        while not os.path.exists(release):
            time.sleep(0.05)
        return model

    Trainer.initial_model = released_model
    Trainer.train_step, Trainer._run_eval, Trainer.train = timed_step, counted_eval, summed_train
    Trainer.make_history_cache, Optimizer.step = captured_cache, timed_update
    Trainer.make_optimizer, serving.make_http_server = kept_optimizer, client_server
    common.launch = recorded_launch
    tp._ReduceFromModel.forward = timed_collective(reduce_fwd)
    tp._CopyToModel.backward = timed_collective(copy_bwd)
    for j in jobs:
        job.clear()
        job.update(j)
        rep.clear()
        rep.update(phase=j["phase"], step_s=[], losses=[], update_s=[], sum_s=[], grad_norms=[],
                   eval_counts=None, fills=[], checksum=None, rank=mesh.this_rank(),
                   world=mesh.world_size(), backend=backend, cards=torch.cuda.device_count(),
                   tp_s=[0.0], tp_n=[0], mha_shapes={},
                   at={"entry": entry, "job": time.time()})
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        native.reset_call_counts()
        cli.main(j["argv"])
        rep["native"] = native.call_counts()
        counts = launch_counts()
        rep["tp_s"], rep["tp_n"] = rep["tp_s"][1:], rep["tp_n"][1:]  # the micro-batches'
        held.clear()
        evals = rep["eval_counts"] or {n: 0 for n in counts}
        rep["train_counts"] = {n: c - evals[n] for n, c in counts.items()}
        if "cache" in rep:
            rep["fills"] = rep.pop("cache").fills
        rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rep["at"]["exit"] = time.time()
        line = MESH_RANK + json.dumps(rep)
        print(line, flush=True)
        with open(os.path.join(os.path.dirname(jobs_path),
                               f"{j['phase']}.rank{rep['rank']}.json"), "w") as f:
            f.write(line + "\n")
        entry = rep["at"]["exit"]
    mesh.destroy_distributed()
    return 0


def start_mesh(world: int, held: bool = False) -> dict:
    """Start ``world`` ranks of ``python -m torch.distributed.run
    --standalone`` (:func:`mesh_rank_main`), the port of this checkout,
    before their jobs are known: the ranks import what they run and wait
    for :func:`give_jobs`. With ``held`` the ranks wait at the first
    micro-batch of a ``HELD`` phase until the launch's ``go`` file is
    there. Returns the launch, for :func:`give_jobs` and
    :func:`finish_mesh`."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    reports_dir = tempfile.mkdtemp(prefix="mesh_")
    jobs_path = os.path.join(reports_dir, "jobs.json")
    go = os.path.join(reports_dir, "go") if held else None
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), os.path.join(here, "chip_smoke.py"), "--mesh_rank", jobs_path]
    env = dict(_port_env(), **({"CHIP_SMOKE_GO": go} if go else {}))
    # to a file: a pipe this script does not read while it works would fill
    with open(os.path.join(reports_dir, "out.log"), "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env, cwd=here,
                                start_new_session=True)
    return dict(world=world, dir=reports_dir, jobs_path=jobs_path, go=go, proc=proc)


def give_jobs(launch: dict, jobs) -> dict:
    """Give a launch of :func:`start_mesh` its ``jobs``, each ``(phase, cli
    words, grads file or None)`` and, for a serve job, its requests, run
    one after another on its ranks; they build the first job's model on
    the host and hold it there until :func:`release_mesh`."""
    tmp = launch["jobs_path"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump([{"phase": j[0], "argv": j[1], "grads": j[2],
                    "requests": j[3] if len(j) > 3 else None} for j in jobs], f)
    os.replace(tmp, launch["jobs_path"])  # whole when a rank sees it
    launch.update(jobs=jobs, names="+".join(j[0] for j in jobs))
    return launch


def release_mesh(launches: dict) -> None:
    """Let the ranks of every launch in ``launches``
    (:func:`start_mesh_phases`) onto the card; their times count from here."""
    for launch in (launches["four"], *launches["checks"], launches["timed"]):
        with open(os.path.join(launch["dir"], "release"), "w"):
            pass
        launch.update(t0=time.perf_counter(), launched=time.time())
    log("mesh launches: released onto the card")


def finish_mesh(launch: dict) -> dict:
    """Wait for a launch of :func:`start_mesh` and return each phase's rank
    reports in rank order. Fails the run if a rank exits non-zero or does
    not report, or the launcher outlives ``MESH_TIMEOUT_S`` from its start;
    every process it started is stopped."""
    import shutil
    import signal

    proc, names, world = launch["proc"], launch["names"], launch["world"]
    try:
        proc.wait(timeout=max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - launch["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    with open(os.path.join(launch["dir"], "out.log"), errors="replace") as f:
        out = f.read()
    if proc.returncode == -signal.SIGKILL:
        raise SystemExit(f"{names}: the ranks outlived {MESH_TIMEOUT_S} s:\n{out[-6000:]}")
    wall_s = time.perf_counter() - launch["t0"]
    results = {}
    for phase, *_ in launch["jobs"]:
        reports = []
        for r in range(world):
            path = os.path.join(launch["dir"], f"{phase}.rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports.append(json.loads(f.read()[len(MESH_RANK):]))
        results[phase] = reports
    shutil.rmtree(launch["dir"])
    if proc.returncode != 0 or any(len(r) != world for r in results.values()):
        raise SystemExit(f"{names}: the launcher exited {proc.returncode} with "
                         f"{ {p: len(r) for p, r in results.items()} } of {world} ranks "
                         f"reporting:\n{out[-6000:]}")
    log(f"{names}: {wall_s:.1f} s from its release to the launcher's exit; on rank 0 "
        + "; ".join(f"{p}: " + ", ".join(f"{k} +{t - launch['launched']:.1f} s"
                                        for k, t in results[p][0]["at"].items())
                    for p, *_ in launch["jobs"]))
    return results


def _check_ranks(phase: str, reports, micro_batches_: int) -> dict:
    """Every rank launched its phase's kernels (``REQUIRED``), took
    ``micro_batches_`` micro-batches with finite losses, the same global
    losses and the same final parameters bit for bit as rank 0. Logs the
    backend, the ranks a card, the micro-batch and update times, the
    gradient sum's share of each update and the peak memory a rank.
    Returns the launch counts of the micro-batches, summed over the ranks."""
    r0 = reports[0]
    for r in reports:
        _check_launches(phase, r["train_counts"])
        _check_native(f"{phase} rank {r['rank']}", "sampler", r["native"])
        bad = [x for x in r["losses"] if not math.isfinite(x)]
        if bad or len(r["losses"]) != micro_batches_:
            raise SystemExit(f"{phase}: rank {r['rank']}: {len(r['losses'])} micro-batches, "
                             f"non-finite losses {bad}")
        if r["losses"] != r0["losses"] or r["checksum"] != r0["checksum"]:
            raise SystemExit(f"{phase}: rank {r['rank']}'s losses or final parameters differ "
                             f"from rank 0's: {r['losses']} against {r0['losses']}, "
                             f"{r['checksum']} against {r0['checksum']}")
    steps = sorted(t for r in reports for t in r["step_s"][1:])
    mid = steps[len(steps) // 2] if steps else float("nan")
    share = [s / u for u, s in zip(r0["update_s"], r0["sum_s"])]
    log(f"{phase}: {r0['world']} ranks, mesh {r0['mesh']}, backend {r0['backend']}, "
        f"{r0['world'] / max(1, r0['cards']):g} ranks a card ({r0['cards']} card(s)), "
        f"rank 0 on {r0['device']}; all ranks' final parameters bit-identical "
        f"(sha256 {r0['checksum'][:16]}); losses {[round(x, 4) for x in r0['losses']]}")
    log(f"{phase}: micro-batch {1e3 * mid:.1f} ms median over the ranks (the first apart), "
        f"{r0['updates']} updates of {[round(1e3 * t, 1) for t in r0['update_s']]} ms on rank "
        f"0, of which the gradient sum over the data group "
        f"{[round(1e3 * t, 1) for t in r0['sum_s']]} ms ({[round(x, 3) for x in share]} of "
        f"the update); peak memory a rank {[round(r['peak_gib'], 2) for r in reports]} GiB")
    counts = {n: sum(r["train_counts"][n] for r in reports) for n in r0["train_counts"]}
    log(f"{phase}: kernel launches summed over the ranks {counts}")
    return {phase: counts}


def start_mesh_launches() -> dict:
    """The mesh phases' launches (:func:`start_mesh_phases`), started
    before the kernel phase so that their ranks' start-up (the launcher,
    the imports) is done when their jobs come."""
    return dict(four=start_mesh(4), checks=[start_mesh(2), start_mesh(2)],
                timed=start_mesh(2, held=True))


def start_mesh_phases(corpus: str, out: str, final_model: str, started: dict) -> dict:
    """Give the mesh phases' launches (``started``: :func:`start_mesh_launches`)
    their jobs (their checks: :func:`finish_mesh_phases`): their ranks build
    their first models on the host beside the last serial phases and run
    beside the untimed ones once released (:func:`release_mesh`).

    One launch of 2 ranks whose last two phases are held at their first
    micro-batch until ``go``, for the times (the card then runs nothing
    else); the phases before them run at once, correctness alone:

    * ep_unisrec: ``config/train_unisrec.txt --mesh_model 2``, 2
      micro-batches: the MoE adaptor's experts sharded (4 of 8 a rank), the
      bert-base tower's heads too;
    * table_eval: ``config/eval_miner.txt`` on the train phase's
      ``finalModel`` with ``--mesh_table 2``;
    * mesh_serve and mesh_serve_loaded: ``serve`` of ``serve_miner.txt``
      on that ``finalModel`` with ``--mesh_table 2``, fresh (the cache
      filled, each rank keeping half of its rows, and persisted), then from
      the file it wrote; rank 0 answers serve_cache's 20 requests over HTTP,
      one at a time, rank 1 following its device calls;
    * mesh_train (held): ``config/train_miner.txt --mesh_data 2`` at full
      width (roberta-base, bf16, dropout, --remat), 8 micro-batches at
      accumulation 4, without its eval (table_eval runs the cached eval
      over a mesh);
    * tp_train (held): the same with ``--mesh_model 2`` at
      ``--train_batch_size`` ``TP_B``, 3 micro-batches at accumulation 3
      (one update): each rank half of every layer's heads and feed-forward
      features, the model group's all-reduces through the host (gloo).

    Two launches of 2 ranks and one of 4, side by side, correctness alone
    (their times are taken beside other work):

    * mesh_parity_fp32 and mesh_parity_tp, a launch each: the same path in float32 with
      the config's dropout, 2 micro-batches at accumulation 2 (one update,
      at lr 2e-5: no warmup), over ``--mesh_data 2`` (16 rows a
      micro-batch) and ``--mesh_model 2`` (``TP_B``);
    * on 4 ranks, mesh_his_cache: the cached-history flags over
      ``--mesh_data 2 --mesh_table 2``, 6 micro-batches: 2 on the full
      history, then 4 whose history rows come from the train corpus's
      cache, row-sharded over the table axis and rebuilt at micro-steps 2
      and 4."""
    parity = os.path.join(out, "mesh_parity")
    os.makedirs(parity, exist_ok=True)
    grads = {p: os.path.join(parity, f"{p}.grads.pt") for p in ("mesh_parity_fp32",
                                                                 "mesh_parity_tp")}
    reqs, _ = SERVED["serve_cache"]
    cache = os.path.join(out, "mesh_serve_cache.npz")
    serve = serve_words(corpus, "--saved_model_path", final_model, "--serve_cache_path", cache,
                        "--mesh_table", "2")
    four = give_jobs(started["four"], [("mesh_his_cache", train_words(
        corpus, out, "--mesh_data", "2", "--mesh_table", "2", family="mesh_his_cache"), None)])
    # the two parity checks in launches of their own, side by side
    checks = [give_jobs(started["checks"][0], [
        ("mesh_parity_fp32", train_words(corpus, parity, "--mesh_data", "2",
                                         family="mesh_parity"), grads["mesh_parity_fp32"])]),
              give_jobs(started["checks"][1], [
        ("mesh_parity_tp", train_words(corpus, parity, "--mesh_model", "2",
                                       family="mesh_parity_tp"), grads["mesh_parity_tp"])])]
    timed = give_jobs(started["timed"], [
        ("ep_unisrec", train_words(corpus, out, "--mesh_model", "2", family="ep_unisrec"),
         None),
        ("table_eval", eval_words(corpus, os.path.join(out, "table_eval"), final_model,
                                  "--mesh_table", "2"), None),
        ("mesh_serve", serve, None, reqs),
        ("mesh_serve_loaded", serve, None, reqs),
        ("mesh_train", train_words(corpus, out, "--mesh_data", "2", family="mesh"), None),
        ("tp_train", train_words(corpus, out, "--mesh_model", "2", family="tp"), None)])
    return dict(timed=timed, checks=checks, four=four, go=timed["go"], grads=grads,
                parity=parity, cache=cache)


def finish_mesh_phases(corpus: str, out: str, final_model: str, launches: dict,
                       before_go=None) -> dict:
    """The mesh phases' checks. mesh_his_cache first: every rank launched
    its kernels, finite losses, every rank's parameters bit-identical, the
    cache rebuilt at micro-steps 2 and 4 (JAX's rule). Then the checks'
    launch: mesh_parity_fp32 and mesh_parity_tp against W = 1
    (:func:`mesh_parity_check`). Then ``before_go`` (the end of other work
    on the card: the convergence phase), then ``go`` for the timed launch's
    held phases, on a card this script no longer shares, and the launch's
    checks: ep_unisrec rank-identical with UniSRec's launches a
    micro-batch; table_eval against one rank (:func:`table_eval_check`);
    mesh_serve against the one-rank serving (:func:`mesh_serve_check`);
    mesh_train launched every Miner kernel
    on each rank, finite losses, both ranks' parameters bit-identical; its
    micro-batch, global examples/s (the 16 rows of a micro-batch over the
    time the ranks take for theirs), each update's time and the gradient
    sum's share of it, the peak memory a rank, the backend and the ranks a
    card; tp_train the same (the parameters gathered whole), its model
    group's all-reduces a micro-batch and their share of it, and every mha
    launch at the rank's heads (:func:`_check_tp`). Returns the launch
    counts of each phase."""
    import gc

    four = finish_mesh(launches["four"])["mesh_his_cache"]
    counts = _check_ranks("mesh_his_cache", four, micro_batches("mesh_his_cache"))
    fills = {tuple(r["fills"]) for r in four}
    log(f"mesh_his_cache: the cache rebuilt at micro-steps {sorted(fills)} on every rank "
        "(its times were taken beside the untimed phases)")
    if fills != {(2, 4)}:
        raise SystemExit(f"mesh_his_cache: rebuilds at {fills}, JAX's rule gives (2, 4)")
    # the one-rank halves of the checks, beside the checks' ranks
    families = (("mesh_parity_fp32", "mesh_parity"), ("mesh_parity_tp", "mesh_parity_tp"))
    ones = {phase: parity_one_rank(corpus, launches["parity"], family)
            for phase, family in families}
    eval_one = table_eval_one(corpus, out, final_model)
    two = {phase: reports for launch in launches["checks"]
           for phase, reports in finish_mesh(launch).items()}
    counts["mesh_parity_fp32_one"] = {}
    for phase, family in families:
        counts.update(_check_ranks(phase, two[phase], micro_batches(family)))
        mesh_parity_check(phase, two[phase][0], launches["grads"][phase], ones[phase])
        for n, c in ones[phase]["counts"].items():
            counts["mesh_parity_fp32_one"][n] = counts["mesh_parity_fp32_one"].get(n, 0) + c
    if before_go is not None:  # other work on the card, ended before the timed phases
        before_go()
    gc.collect()
    torch.cuda.empty_cache()
    with open(launches["go"], "w"):
        pass
    timed = finish_mesh(launches["timed"])
    counts.update(_check_ranks("ep_unisrec", timed["ep_unisrec"], micro_batches("ep_unisrec")))
    for r in timed["ep_unisrec"]:
        _check_per_batch("ep_unisrec", {k: v // micro_batches("ep_unisrec")
                                        for k, v in r["train_counts"].items()})
    counts.update(table_eval_check(out, timed["table_eval"], eval_one))
    counts.update(mesh_serve_check(timed, launches["cache"], out))
    counts.update(_check_ranks("mesh_train", timed["mesh_train"], micro_batches("mesh")))
    args = train_args(corpus, out, family="mesh")
    steps = sorted(t for r in timed["mesh_train"] for t in r["step_s"][1:])
    mid = steps[len(steps) // 2]
    MICRO_BATCH_MS["mesh_train"] = 1e3 * mid
    PEAK_GIB["mesh_train"] = max(r["peak_gib"] for r in timed["mesh_train"])
    log(f"mesh_train: {args.train_batch_size / mid:.2f} global examples/s "
        f"({args.train_batch_size} rows a micro-batch, {args.train_batch_size // 2} a rank); "
        f"one card's train phase {MICRO_BATCH_MS.get('train', float('nan')):.1f} ms a "
        f"micro-batch")
    counts.update(_check_tp(timed["tp_train"]))
    return counts


def _check_tp(reports) -> dict:
    """tp_train's ranks: as :func:`_check_ranks`, 24 mha launches of each
    kind a micro-batch (``PER_BATCH``), every mha forward at the rank's 6
    heads of all ``TP_N`` sequences, at head offset 6 x its model rank;
    logs the micro-batch, its all-reduces over the model group (count and
    time, the card synchronised around each) and their share of it."""
    counts = _check_ranks("tp_train", reports, micro_batches("tp"))
    for r in reports:
        _check_per_batch("tp_train", {k: v // micro_batches("tp")
                                      for k, v in r["train_counts"].items()})
        want = {f"{TP_N}x{L}x{TP_HEADS}+{TP_HEADS * r['rank']}" for L in (TRAIN_TITLE,
                                                                         TRAIN_SAPO)}
        if set(r["mha_shapes"]) != want:
            raise SystemExit(f"tp_train: rank {r['rank']}'s mha launches at "
                             f"{r['mha_shapes']} (N x L x heads + head offset), want {want}")
    steps = [t for r in reports for t in r["step_s"][1:]]
    shares = [s / t for r in reports for s, t in zip(r["tp_s"][1:], r["step_s"][1:])]
    mid = sorted(steps)[len(steps) // 2]
    MICRO_BATCH_MS["tp_train"] = 1e3 * mid
    r0 = reports[0]
    log(f"tp_train: micro-batch of {TP_B} rows {1e3 * mid:.1f} ms median over the ranks "
        f"(the first apart), {TP_B / mid:.2f} examples/s; the model group's all-reduces "
        f"{r0['tp_n']} a micro-batch on rank 0, {[round(1e3 * t, 1) for t in r0['tp_s']]} ms, "
        f"a median share {sorted(shares)[len(shares) // 2]:.3f} of the micro-batch; mha "
        f"launches by N x L x heads + head offset {[r['mha_shapes'] for r in reports]}")
    return counts


def parity_one_rank(corpus: str, out: str, family: str) -> dict:
    """A fp32 parity's W = 1 run of ``family`` in this process: ``train()``'s batches,
    model and optimizer through ``Trainer.train_step`` (no checkpoint
    written), with the config's dropout, as in the ranks: the losses, the
    update's gradients (AdamW's, clipped) and their norm before the clip,
    and the launch counts."""
    import miner_tpu_torch.training.trainer as port_trainer
    from miner_tpu_torch.data.batcher import Batcher
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts

    trainer = port_trainer.Trainer(train_args(corpus, os.path.join(out, f"w1_{family}"),
                                              family=family))
    a = trainer.args
    store = trainer._load_store(a.train_news_path, a.augmentations)
    block = trainer._train_sampler(trainer._load_log(a.train_behaviors_path, store),
                                   store).sample_epoch(0)
    model = trainer.initial_model().to(trainer.device).train()
    table = trainer._make_table(store)
    optimizer = trainer.make_optimizer(model, 1, 0)
    kept, adamw_step = {}, optimizer.adamw.step

    def keeping(*x, **k):
        kept["grads"] = [p.grad.detach().clone() for p in optimizer.params]
        return adamw_step(*x, **k)

    optimizer.adamw.step = keeping
    reset_launch_counts()
    CENSUS.phase = "mesh_parity_fp32_one"
    try:
        batches = Batcher(a.train_batch_size, drop_last=True, shuffle=True,
                          seed=a.seed).batches(block, 0)
        losses = [float(trainer.train_step(model, table, batch, optimizer, i))
                  for i, batch in enumerate(batches)]
    finally:
        CENSUS.phase = None
    counts = launch_counts()
    _check_launches("mesh_parity_fp32_one", counts)
    return dict(losses=losses, grads=kept["grads"], norm=float(optimizer.grad_norm),
                updates=optimizer.updates, counts=counts)


def mesh_parity_check(phase: str, two: dict, grads: str, one: dict) -> None:
    """A parity phase's W = 2 run (rank 0's report ``two``, its update's
    gradients in ``grads``, a sharded leaf's gathered whole) against W = 1
    (:func:`parity_one_rank`), both with the config's dropout, whose masks
    do not depend on the mesh. The global losses to 1e-4 of their size;
    the update's global gradient norm before the clip (the ranks' shares
    summed over the data group, divided; over the model axis the shares'
    squares summed) to 1e-4 of its size: a sum off by a factor moves it by
    that factor, where the clip (1.0) hides the factor from the clipped
    gradients; and the clipped gradients AdamW takes to the card-vs-CPU
    parity's tolerance (1e-3 of each gradient's largest magnitude plus
    1e-5 of the largest over all: float32 summation order). The norm and
    the clipped gradients together hold the summed gradient before the
    clip: equal norms give equal clip factors."""
    losses, want, norm = one["losses"], one["grads"], one["norm"]
    got = [g.to(want[0].device) for g in torch.load(grads)]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(two["losses"], losses))
    top = max(float(w.abs().max()) for w in want)
    ratios = [float((g - w).abs().max()) / (1e-3 * float(w.abs().max()) + 1e-5 * top)
              for g, w in zip(got, want)]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    norm_err = abs(two["grad_norms"][0] - norm) / norm
    log(f"{phase}: W = 2 ({two['mesh']}) against W = 1 (this process) on the card, dropout "
        f"on: losses {[round(x, 5) for x in two['losses']]} and "
        f"{[round(x, 5) for x in losses]}, {loss_err:.3g} of their size (tol 1e-4); the "
        f"update's gradient norm before the clip {two['grad_norms'][0]:.7g} and {norm:.7g}, "
        f"{norm_err:.3g} of its size (tol 1e-4); the clipped gradients at worst "
        f"{ratios[worst]:.3g} of their tolerance (tensor {worst} of {len(ratios)}, shape "
        f"{tuple(want[worst].shape)}; tol 1e-3 of each gradient's largest magnitude + 1e-5 of "
        f"the largest, {top:.3g})")
    if (len(losses) != len(two["losses"]) or one["updates"] != 1 or len(got) != len(want)
            or len(two["grad_norms"]) != 1 or loss_err > 1e-4 or norm_err > 1e-4
            or ratios[worst] > 1):
        raise SystemExit(f"{phase}: W = 2 disagrees with W = 1")


def mesh_serve_check(two: dict, cache: str, out: str) -> dict:
    """mesh_serve and mesh_serve_loaded (``serve`` over ``--mesh_table
    2``): every rank launched the serving kernels (the loaded start no PLM
    kernel); rank 0's replies to serve_cache's requests equal the one-rank
    fresh start's bit for bit (each gather and lookup+score summed over
    the two shards: one term a value is not zero); the cache the ranks
    persisted is the one-rank file's array for array. Returns the launch
    counts summed over the ranks."""
    import numpy as np

    reqs, want = SERVED["serve_cache"]
    counts = {}
    for phase in ("mesh_serve", "mesh_serve_loaded"):
        reports = two[phase]
        for r in reports:
            _check_launches(phase, r["train_counts"])
        got = reports[0].get("replies")
        at = reports[0]["at"]
        log(f"{phase}: {reports[0]['world']} ranks, rank 0 answering {len(reqs)} requests "
            f"over HTTP one at a time, {at['exit'] - at['job']:.1f} s start to stop on rank 0; "
            f"replies {'bit-equal to' if got == want else 'DIFFER from'} the one-rank serving's")
        if got != want:
            raise SystemExit(f"{phase}: replies over --mesh_table 2 differ from one rank's")
        counts[phase] = {n: sum(r["train_counts"][n] for r in reports)
                         for n in reports[0]["train_counts"]}
    with np.load(cache) as a, np.load(os.path.join(out, "serve_cache.npz")) as b:
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    log(f"mesh_serve: the cache persisted over --mesh_table 2 "
        f"{'equals' if same else 'DIFFERS from'} the one-rank file array for array")
    if not same:
        raise SystemExit("mesh_serve: the persisted sharded cache differs from one rank's")
    return counts


def eval_words(corpus: str, out: str, checkpoint: str, *extra: str):
    """``config/eval_miner.txt`` as it stands on the synthetic corpus and its
    eval behaviors, the hash tokenizer over roberta-base's vocabulary,
    ``--saved_model_path`` the given checkpoint, the run under ``out``."""
    here = os.path.dirname(os.path.abspath(__file__))
    words = _config_words(os.path.join(here, "config", "eval_miner.txt"))
    for flag, value in (
            ("--pretrained_tokenizer", "hash:50265"),
            ("--user2id_path", os.path.join(corpus, "user2id.json")),
            ("--category2id_path", os.path.join(corpus, "category2id.json")),
            ("--eval_behaviors_path", os.path.join(corpus, "valid", "behaviors.tsv")),
            ("--eval_news_path", os.path.join(corpus, "news.tsv")),
            ("--saved_model_path", checkpoint)):
        words[words.index(flag) + 1] = value
    return ["eval", *words, "--eval_path", out, *extra]


def _eval_files(path: str):
    import glob
    import pickle

    (run,) = glob.glob(os.path.join(path, "*"))
    with open(os.path.join(run, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    with open(os.path.join(run, "eval.csv")) as f:
        return preds, f.read()


def table_eval_one(corpus: str, out: str, final_model: str) -> dict:
    """table_eval's one-rank eval in this process: its scores, time and
    launch counts (its files under ``out``)."""
    from miner_tpu_torch.config import make_parser
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.training.trainer import Trainer

    reset_launch_counts()
    CENSUS.phase = "table_eval_one"
    t0 = time.perf_counter()
    try:
        want = Trainer(make_parser().parse_args(eval_words(
            corpus, os.path.join(out, "table_eval_one"), final_model))).eval()
    finally:
        CENSUS.phase = None
    counts = launch_counts()
    _check_launches("table_eval", counts)
    return dict(scores=want, seconds=time.perf_counter() - t0, counts=counts)


def table_eval_check(out: str, reports, one: dict) -> dict:
    """table_eval's ranks (``reports``: ``eval_miner.txt`` on the train
    phase's ``finalModel`` with ``--mesh_table 2``, each rank keeping half
    of the news-embedding cache's rows and a zero row, every gather and
    lookup+score run on the rank's shard and summed over the two) against
    the one-rank eval (:func:`table_eval_one`): the metrics, the eval loss
    and every prediction bit for bit, and lookup+score launched on each
    rank."""
    one_dir, two_dir = os.path.join(out, "table_eval_one"), os.path.join(out, "table_eval")
    want, one_s, one_counts = one["scores"], one["seconds"], one["counts"]
    for r in reports:
        _check_launches("table_eval", r["eval_counts"])
    (p1, csv1), (p2, csv2) = _eval_files(one_dir), _eval_files(two_dir)
    same = (csv1 == csv2 and p1["impression_id"] == p2["impression_id"]
            and all(a.tobytes() == b.tobytes() if hasattr(a, "tobytes") else a == b
                    for a, b in zip(p1["pred"], p2["pred"])))
    at = reports[0]["at"]
    log(f"table_eval: {reports[0]['world']} ranks, backend {reports[0]['backend']}, each "
        f"with half of the cache's rows: {at['exit'] - at['job']:.1f} s on rank 0; one "
        f"rank's eval {one_s:.1f} s in this process; {len(p1['pred'])} predictions; metrics "
        f"and eval loss {'bit-equal' if same else 'DIFFER'}: {want}")
    if not same:
        raise SystemExit(f"table_eval: the table-sharded eval differs from one rank's:\n"
                         f"{csv1}\n{csv2}")
    return {"table_eval_one": one_counts,
            "table_eval": {n: sum(r["eval_counts"][n] for r in reports) for n in one_counts}}


def _port_env() -> dict:
    """The environment of a process of this script's port (this checkout's
    ``miner_tpu_torch`` first on the path, expandable allocator segments)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    # a dozen processes share the card after the serial phases: blocks
    # their allocators free go back to the card in whole segments
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    return env


def start_scale_corpus(root: str) -> dict:
    """Start writing the at-scale corpus of ``scale_convergence`` under
    ``root/data`` (``python -m miner_tpu_torch.tools.synth_mind``, numpy on
    one core of the host), beside the build and the kernel phase."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(root, "corpus.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "miner_tpu_torch.tools.synth_mind",
                             os.path.join(root, "data"), *SCALE_CORPUS],
                            stdout=out, stderr=subprocess.STDOUT, env=_port_env(), cwd=here,
                            start_new_session=True)
    return dict(proc=proc, out=out, root=root)


def convergence_main(root: str) -> int:
    """The convergence phase's process: the launch counts set to 0, then
    ``scale_convergence --model miner --epochs 4 --stop_after_epochs 1``
    (epoch 0 of the 4-epoch recipe, bf16, the kernels) on the corpus under
    ``root``, the counts read; the result, the counts, the census of its
    launches' shapes (:class:`LaunchCensus`), the time from the release and
    the peak memory written to ``root/convergence.json``. It
    loads the corpus at once and holds before its model reaches the card
    until ``root/go`` is there (:func:`release`)."""
    import miner_tpu_torch.training.trainer as port_trainer
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.tools import scale_convergence

    torch.set_num_threads(2)  # the card's work; the host's cores are the others'
    build, held = port_trainer.Trainer.initial_model, {}

    def initial_model(self):  # the corpus loaded and on the card: wait for the release
        held["loaded_s"] = time.perf_counter() - T0
        while not os.path.exists(os.path.join(root, "go")):
            time.sleep(0.1)
        held["t"] = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        return build(self)

    port_trainer.Trainer.initial_model = initial_model
    CENSUS.install()
    CENSUS.phase = "convergence"
    reset_launch_counts()
    res = scale_convergence.main(["--model", "miner", "--out", root, "--epochs", "4",
                                  "--stop_after_epochs", "1", "--tag", "_smoke"])
    torch.cuda.synchronize()
    res.update(counts=launch_counts(), released_s=time.perf_counter() - held["t"],
               loaded_s=held["loaded_s"], peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               census=[[name, list(shape), n] for (name, _, shape), n in CENSUS.counts.items()])
    with open(os.path.join(root, "convergence.json"), "w") as f:
        json.dump(res, f)
    return 0


def start_convergence(corpus: dict) -> dict:
    """Wait for the at-scale corpus (:func:`start_scale_corpus`), then start
    the convergence phase in a process of its own (``chip_smoke.py
    --convergence ROOT``), which loads it on one core of the host and
    holds until :func:`release`."""
    proc = corpus["proc"]
    t0 = time.perf_counter()
    proc.wait()
    corpus["out"].close()
    with open(os.path.join(corpus["root"], "corpus.log"), errors="replace") as f:
        text = f.read()
    if proc.returncode != 0:
        raise SystemExit(f"convergence: the corpus exited {proc.returncode}:\n{text[-3000:]}")
    log(f"convergence: the at-scale corpus (60,000 news, 50,000 lines, 5,000 held out) "
        f"written in the background since the start; waited {time.perf_counter() - t0:.1f} s "
        f"for it")
    here = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(corpus["root"], "convergence.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                             "--convergence", corpus["root"]],
                            stdout=out, stderr=subprocess.STDOUT, env=_port_env(), cwd=here,
                            start_new_session=True)
    return dict(proc=proc, out=out, root=corpus["root"], t0=time.perf_counter())


def release(launch: dict, what: str, paths=None) -> None:
    """Let the process of ``launch`` (the convergence phase, the side
    phases) onto the card: the serial phases have ended; ``paths`` (JSON)
    go with it."""
    tmp = os.path.join(launch["root"], "go.tmp")
    with open(tmp, "w") as f:
        json.dump(paths or {}, f)
    os.replace(tmp, os.path.join(launch["root"], "go"))  # whole when seen
    launch["t0"] = time.perf_counter()
    log(f"{what}: released onto the card")


def stop_processes(*launches) -> None:
    """Stop the process group of every launch (a dict with its ``proc``) in
    ``launches`` still running; lists of launches and dicts of them (by
    name) are looked through."""
    import signal

    for launch in launches:
        if isinstance(launch, list):
            stop_processes(*launch)
        elif isinstance(launch, dict) and "proc" not in launch:
            stop_processes(*launch.values())
        elif isinstance(launch, dict) and launch["proc"].poll() is None:
            try:
                os.killpg(launch["proc"].pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            launch["proc"].wait()


def finish_convergence(launch: dict) -> dict:
    """Wait for the convergence phase (past ``CONVERGENCE_TIMEOUT_S`` from
    its release it is stopped and the run fails); log its per-epoch table,
    examples/s, the epoch's time and peak memory; fail the run unless it
    launched the Miner's kernels and its held-out auc after the epoch is at
    least ``CONVERGENCE_AUC``. Returns its launch counts."""
    proc = launch["proc"]
    try:
        proc.wait(timeout=max(1.0, CONVERGENCE_TIMEOUT_S - (time.perf_counter() - launch["t0"])))
    except subprocess.TimeoutExpired:
        stop_processes(launch)
    launch["out"].close()
    with open(os.path.join(launch["root"], "convergence.log"), errors="replace") as f:
        text = f.read()
    path = os.path.join(launch["root"], "convergence.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise SystemExit(f"convergence phase: exit {proc.returncode} after "
                         f"{time.perf_counter() - launch['t0']:.0f} s:\n{text[-6000:]}")
    with open(path) as f:
        res = json.load(f)
    table = [line for line in text.splitlines() if line.startswith("|")]
    auc = res["epochs"]["0"]["auc"]
    phase = "convergence"
    log(f"{phase}: scale_convergence --model miner --epochs 4 --stop_after_epochs 1 "
        f"(bf16, the kernels; {res['steps']} micro-batches of 64), the corpus loaded "
        f"{res['loaded_s']:.1f} s after its process started; "
        f"{res['released_s']:.1f} s from its release onto the card to its end, beside "
        f"the untimed phases:")
    for line in table:
        log(f"{phase}:   {line}")
    log(f"{phase}: held-out auc {auc:.4f} after the epoch (gate {CONVERGENCE_AUC}; the "
        f"JAX package's epoch 0 of the recipe on a v5e: 0.7811, SCALE_r03.md); "
        f"{res['train_examples_per_s']:.1f} examples/s while training, "
        f"{res['examples_per_s']:.1f} over the epoch with its eval; the epoch "
        f"{res['epoch_s'][0]:.1f} s; peak {res['peak_gib']:.2f} GiB")
    log(f"{phase}: kernel launches {res['counts']}")
    _check_launches(phase, res["counts"])
    for name, shape, n in res["census"]:  # its shapes join the census's sweep
        CENSUS.counts[(name, phase, tuple(shape))] += n
    if not auc >= CONVERGENCE_AUC:
        raise SystemExit(f"{phase} phase: held-out auc {auc!r} after the epoch, below "
                         f"{CONVERGENCE_AUC}")
    return {phase: res["counts"]}


def _tool_phase(phase: str, run):
    """``run()`` as the phase ``phase``: the launch counts set to 0 just
    before and read just after, the census's shapes under ``phase``. Returns
    (its result, the counts, its seconds)."""
    from miner_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    CENSUS.phase = phase
    t0 = time.perf_counter()
    try:
        res = run()
        torch.cuda.synchronize()
    finally:
        CENSUS.phase = None
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    shapes = {f"{name} {shape}": n for (name, p, shape), n in CENSUS.counts.items()
              if p == phase}
    log(f"{phase}: {seconds:.1f} s; kernel launches {counts}; census (fp32 mha, poly, "
        f"lookup by shape) {shapes}")
    _check_launches(phase, counts)
    return res, counts, seconds


def diag_phase() -> dict:
    """``unisrec_diag --steps DIAG_STEPS``: its six variants in float32 on
    the card (the tiny tower's fp32 kernels, Dh = 16); finite losses, the
    deterministic variant's below ln 5."""
    from miner_tpu_torch.tools import unisrec_diag

    phase = "unisrec_diag"
    rows, counts, _ = _tool_phase(phase, lambda: unisrec_diag.main(
        ["--steps", str(DIAG_STEPS)]))
    for r in rows:
        log(f"{phase}:   {r['variant']}: loss {r['loss']:.4f}, holdout acc {r['acc']:.3f} "
            f"({r['seconds']:.1f} s)")
    det = next(r for r in rows if r["variant"].startswith("fully deterministic"))
    bad = [r["variant"] for r in rows if not math.isfinite(r["loss"])]
    if bad or not det["loss"] < math.log(unisrec_diag.C):
        raise SystemExit(f"{phase} phase: non-finite losses {bad}; the deterministic "
                         f"variant's loss {det['loss']!r} (must be below ln 5)")
    return counts


def warmstart_phase(root: str) -> dict:
    """``warmstart_ab --artifact domain`` for one seed on the planted corpus
    of ANALYSIS_LINES lines (bf16, the kernels): the donor Miner on the
    disjoint corpus, its tower exported in the transformers format, warm and
    cold runs with finite metrics, the warm run's tower imported from it."""
    from miner_tpu_torch.tools import warmstart_ab

    phase = "warmstart_ab"
    out = os.path.join(root, phase)
    res, counts, _ = _tool_phase(phase, lambda: warmstart_ab.main(
        ["--out", out, "--artifact", "domain", "--seeds", "13",
         "--events", str(ANALYSIS_LINES), "--news", str(ANALYSIS_NEWS), "--eval_lines", "60"]))
    for label, scores, secs in res["rows"]:
        log(f"{phase}:   {label}: {scores} ({secs:.1f} s)")
    bad = [label for label, scores, _ in res["rows"]
           if not all(math.isfinite(v) for v in scores.values())]
    import glob

    warm = glob.glob(os.path.join(out, "warm-domain_13", "train", "*", "log", "all.log"))
    imported = bool(warm) and "imported the PLM's weights" in open(warm[0], errors="replace").read()
    if bad or len(res["rows"]) != 2 or not imported or not os.path.isfile(
            os.path.join(res["hf_dir"], "pytorch_model.bin")):
        raise SystemExit(f"{phase} phase: non-finite metrics {bad}; rows {res['rows']}; "
                         f"warm run imported the export: {imported}")
    return counts


def contract_phase(root: str) -> dict:
    """``unisrec_contract --plm_preset tiny --stage_c_baseline``: stages A
    (``--unisrec_train_all``), B (the RecBole-layout export) and C (the
    MoE-only freeze) and the baseline, an epoch each, on the planted corpus
    of ANALYSIS_NEWS news (bf16, the kernels): the export holds every tensor
    of the model, and the baseline at lr 0 scores what stage A's model
    scored."""
    from miner_tpu_torch.tools import unisrec_contract
    from miner_tpu_torch.training import checkpoint

    phase = "unisrec_contract"
    res, counts, _ = _tool_phase(phase, lambda: unisrec_contract.main(
        ["--out", os.path.join(root, phase), "--plm_preset", "tiny",
         "--news", str(ANALYSIS_NEWS), "--events", str(ANALYSIS_LINES), "--eval_lines", "60",
         "--stage_a_epochs", "1", "--stage_c_epochs", "1", "--stage_c_baseline",
         "--batch", str(ANALYSIS_CONTRACT_B)]))
    a = checkpoint.load(os.path.join(res["a"]["run_dir"], "ckpt", "finalModel"))["params"]
    # the reference's tensors: each layer's fused qkv as three, the experts
    # one by one, and the history-layout marker
    n_experts = a["news_encoder.moe_adaptor.experts.kernel"].shape[0]
    n_layers = (len({k.split(".")[3] for k in a if k.startswith("news_encoder.plm.layers.")})
                + len({k.split(".")[1] for k in a if k.startswith("trm_layers.")}))
    want = len(a) + 4 * n_layers - 2 + 2 * n_experts + 1
    a_eval = res["a"]["rows"][max(res["a"]["rows"])]
    b_eval = res["baseline"]["rows"][max(res["baseline"]["rows"])]
    diffs = {m: abs(float(a_eval[m]) - float(b_eval[m])) for m in unisrec_contract.METRICS}
    log(f"{phase}: stage A auc {float(a_eval['auc']):.4f} ({res['a']['seconds']:.1f} s), "
        f"{res['exported']} tensors exported ({want} in the model), baseline auc "
        f"{float(b_eval['auc']):.4f} (|diff| against stage A's {diffs}), stage C auc "
        f"{float(res['c']['rows'][max(res['c']['rows'])]['auc']):.4f}")
    if res["exported"] != want or max(diffs.values()) > 1e-6:
        raise SystemExit(f"{phase} phase: exported {res['exported']} tensors of {want}; "
                         f"the baseline's eval against stage A's: {diffs}")
    return counts


def trajectory_phase(root: str) -> dict:
    """``quality_trajectory`` legs port-A and port-B at the mid preset in
    float32 on the card (the kernels' fp32 routes) for TRAJECTORY_STEPS
    steps each, then ``analyze``: finite logs, and at step 0 (one init, one
    batch, the dropout streams apart) the two losses within 1%."""
    from miner_tpu_torch.tools import quality_trajectory

    phase = "quality_trajectory"
    runs, counts, _ = _tool_phase(phase, lambda: quality_trajectory.main(
        ["--out", os.path.join(root, phase), "--events", str(TRAJECTORY_LINES),
         "--eval_lines", str(TRAJECTORY_EVAL), "--max_steps", str(TRAJECTORY_STEPS),
         "--dtype", "fp32"]))
    a, b = runs["port-A"], runs["port-B"]
    div = runs["analysis"]["divergence"]["port-A vs port-B"]
    log(f"{phase}: port-A {a['steps']} steps in {a['train_s']} s, scores {a['scores']}; "
        f"port-B {b['train_s']} s, scores {b['scores']}; step 0 losses "
        f"{a['log'][0]['loss']:.6f} / {b['log'][0]['loss']:.6f}, gnorms "
        f"{a['log'][0]['gnorm']:.6f} / {b['log'][0]['gnorm']:.6f}; divergence {div}")
    finite = all(math.isfinite(r[k]) for leg in (a, b) for r in leg["log"]
                 for k in ("loss", "gnorm"))
    l0a, l0b = a["log"][0]["loss"], b["log"][0]["loss"]
    if (not finite or len(a["log"]) != TRAJECTORY_STEPS or len(b["log"]) != TRAJECTORY_STEPS
            or abs(l0a - l0b) > 0.01 * abs(l0a)):
        raise SystemExit(f"{phase} phase: finite {finite}, steps {len(a['log'])} and "
                         f"{len(b['log'])}, step 0 losses {l0a!r} and {l0b!r}")
    return counts


def analysis_tools_phases(root: str) -> dict:
    """The analysis tools on the card, each a phase of its own, under
    ``root``: unisrec_diag, warmstart_ab, unisrec_contract and
    quality_trajectory. Returns their launch counts."""
    t0 = time.perf_counter()
    counts = {"unisrec_diag": diag_phase(), "warmstart_ab": warmstart_phase(root),
              "unisrec_contract": contract_phase(root),
              "quality_trajectory": trajectory_phase(root)}
    log(f"analysis tools: {time.perf_counter() - t0:.1f} s")
    return counts


def turnkey_phase(tmp: str) -> dict:
    """The port's ``turnkey_mind`` on the card from a zip of a MIND-style
    corpus (the planted corpus of ``synth_mind`` at 1,200 news and
    ``TURNKEY_LINES`` lines, ``behaviors.tsv`` and ``news.tsv`` zipped as
    MIND ships them) at its defaults (the tiny tower, the hash tokenizer,
    bf16 and the kernels): the splits, the trained Miner's checkpoint, the
    standalone eval's ``preds.pkl`` and per-impression dumps must be there,
    ``tools/analyze_preds.py preds`` (numpy only) must read the
    ``preds.pkl`` in a process of its own, and the path must launch mha,
    add_ln (forward and backward), poly-attention and lookup+score. Returns
    the launch counts."""
    import zipfile

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.tools import synth_mind, turnkey_mind

    phase = "turnkey"
    src = synth_mind.make_synth_mind(os.path.join(tmp, "turnkey_src"), n_news=1200,
                                     n_users=300, n_train_lines=TURNKEY_LINES,
                                     n_eval_lines=10)
    archive = os.path.join(tmp, "MINDsynth.zip")
    with zipfile.ZipFile(archive, "w", zipfile.ZIP_DEFLATED) as z:
        for name in ("behaviors.tsv", "news.tsv"):
            z.write(os.path.join(src, name), arcname=f"MINDsynth_train/{name}")
    out = os.path.join(tmp, "turnkey")
    reset_launch_counts()
    t0 = time.perf_counter()
    CENSUS.phase = phase
    try:
        summary = turnkey_mind.main(["--archive", archive, "--out", out, "--valid_impressions",
                                     str(TURNKEY_VALID), "--epochs", "1"])
        torch.cuda.synchronize()
    finally:
        CENSUS.phase = None
    wall = time.perf_counter() - t0
    counts = launch_counts()
    missing = [rel for rel in ("data/train/behaviors.tsv", "data/train/news.tsv",
                               "data/valid/behaviors.tsv", "data/user2id.json",
                               "data/category2id.json") if not os.path.exists(
                                   os.path.join(out, rel))]
    erun = os.path.dirname(summary["preds_pkl"])
    missing += [p for p in [summary["checkpoint"], summary["preds_pkl"]] + [
        os.path.join(erun, f) for f in ("group_auc.txt", "mrr.txt", "ndcg5.txt",
                                        "ndcg10.txt")] if not os.path.isfile(p)]
    here = os.path.dirname(os.path.abspath(__file__))
    read = subprocess.run([sys.executable, os.path.join(here, "tools", "analyze_preds.py"),
                           "preds", summary["preds_pkl"]], capture_output=True, text=True,
                          timeout=120)
    log(f"{phase}: turnkey_mind from {os.path.basename(archive)} (1,200 news, "
        f"{TURNKEY_LINES} lines, {TURNKEY_VALID} held out; tiny tower, bf16) in {wall:.1f} s "
        f"(train {summary['train_s']} s, eval {summary['eval_s']} s): scores "
        f"{summary['scores']}, checkpoint {os.path.basename(summary['checkpoint'])}")
    log(f"{phase}: tools/analyze_preds.py preds exit {read.returncode}: "
        + " | ".join(read.stdout.strip().splitlines()[:3]))
    log(f"{phase}: kernel launches {counts}")
    bad = [k for k, v in summary["scores"].items() if not math.isfinite(v)]
    if missing or bad or read.returncode != 0 or "impressions:" not in read.stdout:
        raise SystemExit(f"{phase} phase: missing {missing}; non-finite {bad}; "
                         f"analyze_preds exit {read.returncode}: {read.stderr[-2000:]}")
    _check_launches(phase, counts)
    return counts


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mesh_rank"]:  # a rank of a mesh launch (start_mesh)
        return mesh_rank_main(argv[1])
    if argv[:1] == ["--convergence"]:  # the convergence phase (start_convergence)
        return convergence_main(argv[1])
    if argv[:1] == ["--side"]:  # train parity, turnkey, UniSRec serving (start_side)
        return side_main(argv[1])
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; package {os.path.dirname(miner_tpu_torch.__file__)}")

    names = opts.kernels.split(",") if opts.kernels else None
    if names is not None:
        return run(opts, names, smi)
    import shutil
    import tempfile

    # the at-scale corpus of the convergence phase, written beside the build
    scale = start_scale_corpus(tempfile.mkdtemp(prefix="convergence_"))
    side_root = tempfile.mkdtemp(prefix="side_")
    launches = [scale]
    try:
        return run(opts, names, smi, scale, launches, side_root)
    finally:
        stop_processes(*launches)
        shutil.rmtree(scale["root"], ignore_errors=True)
        shutil.rmtree(side_root, ignore_errors=True)


def run(opts, names, smi: str, scale=None, launches=None, side_root=None) -> int:
    """Everything past the start of :func:`main`: the build, the kernels
    and (without ``--kernels``) the phases; ``scale``: the at-scale
    corpus's launch (:func:`start_scale_corpus`). The processes it starts
    beside this one (the side phases under ``side_root``, the
    mesh launches, the convergence phase) are appended to ``launches``."""
    from miner_tpu_torch.ops import common

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    reports = common.build(common.CUDA_SOURCES if names is None
                           else [n for n in common.CUDA_SOURCES if n in names])
    log(f"build: {len(reports)} CUDA libraries in {time.perf_counter() - t0:.1f} s")
    spills = []
    for name, report in reports.items():
        # each kernel's registers, spills and shared memory; for the kernels
        # built in several variants also the entry each line belongs to
        keys = ("registers", "spill") + (("Compiling entry",) if name in ENTRY_REPORTS else ())
        entry = ""
        for line in report.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if any(k in line for k in keys):
                log(f"  {name}: {line.strip()}")
            if ("fp32" in entry and name in SPLIT_TF32 and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(f"{entry}: {line.strip()}")
    if spills:  # the split-TF32 kernels are sized to keep every fragment in registers
        msg = "fp32 (split TF32) builds spill:\n  " + "\n  ".join(spills)
        if names is None:
            raise SystemExit(msg)
        log(msg)  # another version's kernels, timed beside this one's

    if names is None:
        # beside the kernel phase and the serial phases, on the host's idle
        # cores: the train parities' CPU halves, and the mesh ranks'
        # start-up (neither takes the card until the serial phases end)
        side = start_side(side_root)
        launches.append(side)
        started = start_mesh_launches()
        launches.append(started)
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

    native_sampler_phase(smi)
    # the convergence phase's process loads its corpus from here on and
    # holds until the serial phases end
    convergence = start_convergence(scale)
    launches.append(convergence)
    CENSUS.install()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        write_parity_corpus(corpus)
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
        all_counts, _ = train_phase(corpus, tmp, "unisrec_all", "--unisrec_train_all",
                                    "--gradient_accumulation_steps", "8")
        counts.update(all_counts)
        hc_counts, _ = train_phase(corpus, tmp, "his_cache", *HIS_CACHE_FLAGS)
        counts.update(hc_counts)
        ff_hc_counts, _ = train_phase(corpus, tmp, "fastformer_his_cache", *HIS_CACHE_FLAGS)
        counts.update(ff_hc_counts)
        # the mesh ranks build their first models on the host beside the
        # last two, whose time is the card's
        mesh_launches = start_mesh_phases(corpus, tmp, final_model, started)
        counts["fp32_train"] = fp32_train_phase(corpus, tmp)
        rd_counts, _ = train_phase(corpus, tmp, "remat_dots")
        counts.update(rd_counts)
        # over a mesh of ranks: the counts set to 0 in each rank just before
        # the port's CLI runs there (mesh_rank_main); the ranks run beside
        # the untimed phases from here on (hf_import, parity and the phases
        # whose times nothing reads), as do the convergence epoch and the
        # side phases (the train parities' card halves, turnkey, UniSRec's
        # serving) in their processes; all end before the held mesh phases
        # take the card alone
        # the ranks share the card with this process: give back its cache
        torch.cuda.empty_cache()
        release_mesh(mesh_launches)
        release(convergence, "convergence")
        release(side, "train parity, turnkey and UniSRec serving phases",
                dict(corpus=corpus, tmp=tmp, unisrec=us_model))
        hf_import_phase(corpus, tmp, tmp)
        write_corpus(os.path.join(tmp, "parity"), 64, seed=1)
        parity_phase(os.path.join(tmp, "parity"))
        torch.cuda.empty_cache()
        counts["roundtrip_serve"] = reference_roundtrip_phase(
            corpus, tmp, {"miner": final_model, "fastformer": ff_model, "unbert": ub_model})
        torch.cuda.empty_cache()
        lstm_counts, lstm_model = train_phase(corpus, tmp, "lstm_legacy", *LSTM_LEGACY_FLAGS)
        counts.update(lstm_counts)
        counts["lstm_legacy_serve"] = serve_phase(corpus, lstm_model, "lstm_legacy_serve")
        torch.cuda.empty_cache()
        nr_counts, nr_model = train_phase(corpus, tmp, "no_reduce")
        counts.update(nr_counts)
        counts["no_reduce_serve"] = serve_phase(corpus, nr_model, "no_reduce_serve", 12, 4)
        _check_d768("no_reduce_serve")
        torch.cuda.empty_cache()
        # the analysis tools, small models beside the others' tails: no
        # process of their own (the card's memory is the mesh ranks')
        counts.update(analysis_tools_phases(tmp))
        torch.cuda.empty_cache()

        def before_go():  # the other processes' work on the card ended
            counts.update(finish_side(side))
            counts.update(finish_convergence(convergence))

        counts.update(finish_mesh_phases(corpus, tmp, final_model, mesh_launches,
                                         before_go=before_go))
    for row in rows:
        row["launches_by_phase"] = {phase: c[row["name"]] for phase, c in counts.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
    for row in rows:
        if "w2" in row:  # a rank's shapes over a mesh: the mesh phases' launches
            row["w2"]["launches"] = sum(row["launches_by_phase"][p] for p in (
                ("table_eval",) if row["name"] == "lookup_score_fwd" else MESH_PHASES))
        if "w2_model" in row:  # a rank's heads over the model axis
            row["w2_model"]["launches"] = sum(row["launches_by_phase"][p] for p in TP_PHASES)
        for tower, route in TOOL_ROUTES.items():  # the tools' shapes: their phases' launches
            if route in row:
                row[route]["launches"] = sum(row["launches_by_phase"].get(p, 0)
                                             for p in TOOL_TOWERS[tower][7])
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
