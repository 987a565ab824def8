"""Config / flag system of the port.

The JAX package's argparse surface (``miner_tpu/config.py``), every
subcommand: ``train``, ``train_fastformer`` and ``pretrain`` (the same
flags, as in JAX), ``eval`` and ``eval_fastformer``, ``serve`` (HTTP
scoring server) and ``recommend`` (one-shot ranking). ``@config/file.txt``
argument files with ``#`` comments parse unchanged (every shipped file of
``config/``). The JAX package's TPU settings (compilation cache, PRNG
implementation, layer scan, matmul precision) are accepted and ignored,
each saying so in ``--help``; ``--remat_policy`` is honoured under
``--remat``. The mesh flags are honoured under a launcher
(``python -m torch.distributed.run``, one process a rank): ``--mesh_data``,
``--mesh_table`` and ``--mesh_model`` as in JAX.
The ``Trainer`` refuses ``--param_dtype`` other than float32, as the JAX
package does, and ``--no-fused_kernels`` on a card.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
from typing import Optional

from miner_tpu_torch.models.plm import PLMConfig

_TPU_ONLY = "a TPU setting of the JAX package: accepted and ignored by the port"


def convert_arg_line_to_args(arg_line: str):
    """@file lines -> args; blank lines and ``#`` comments skipped."""
    arg_line = arg_line.strip()
    if not arg_line or arg_line.startswith("#"):
        return []
    return arg_line.split()


class _JoinWords(argparse.Action):
    """Collect ``nargs='*'`` words back into one space-joined string."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, " ".join(values) if values else None)


def _sub(sub, name: str) -> argparse.ArgumentParser:
    p = sub.add_parser(name, fromfile_prefix_chars="@", allow_abbrev=False)
    p.convert_arg_line_to_args = convert_arg_line_to_args
    return p


def _serving_parser(sub, name: str) -> argparse.ArgumentParser:
    p = _sub(sub, name)
    add_eval_arguments(p)
    p.add_argument("--serve_cache_path", type=str, default=None,
                   help="persist the corpus news-embedding cache here (.npz) "
                        "and load it on the next start when the corpus, "
                        "checkpoint and encoding settings still match")
    p.add_argument("--serve_cache_int8", action="store_true",
                   help="int8 corpus cache with per-row absmax scales (half "
                        "the bytes of bf16)")
    return p


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="miner_tpu_torch — MINER and Fastformer in PyTorch on a CUDA card",
        fromfile_prefix_chars="@",
        allow_abbrev=False,
    )
    parser.convert_arg_line_to_args = convert_arg_line_to_args
    sub = parser.add_subparsers(dest="mode")
    for name in ("train", "train_fastformer", "pretrain"):
        add_train_arguments(_sub(sub, name))
    for name in ("eval", "eval_fastformer"):
        add_eval_arguments(_sub(sub, name))
    p = _serving_parser(sub, "recommend")
    p.add_argument("--user_history", nargs="+", required=True,
                   help="clicked news ids, oldest first")
    p.add_argument("--candidates", nargs="*", default=None,
                   help="candidate news ids (default: whole corpus)")
    p.add_argument("--topk", type=int, default=10)
    p = _serving_parser(sub, "serve")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400,
                   help="HTTP port (0: pick a free port)")
    p.add_argument("--serve_max_batch", type=int, default=32,
                   help="max concurrent requests coalesced into one device "
                        "call (1 disables micro-batching)")
    p.add_argument("--serve_batch_wait_ms", type=float, default=None,
                   help="how long the batcher waits after the first request "
                        "of a drain window for more to coalesce. Default: "
                        "ADAPTIVE — ~10%% of the rolling device-call "
                        "duration (capped 20ms). A number (including 0) is "
                        "honored verbatim")
    p.add_argument("--serve_http_impl", type=str, default="async",
                   choices=["async", "threaded"],
                   help="HTTP front-end: single-threaded asyncio event loop "
                        "(default) or the stdlib ThreadingHTTPServer")
    p.add_argument("--serve_warmup_slates", type=int, nargs="*", default=[],
                   help="run the scoring path once for these slate sizes "
                        "(every batch bucket each, plus the corpus top-k) "
                        "before accepting traffic")
    p.add_argument("--serve_warmup_topk", type=int, default=16,
                   help="warm the corpus top-k path for this k bucket "
                        "(every batch bucket; 0 disables)")
    p.add_argument("--serve_max_slate", type=int, default=512,
                   help="reject unbert reranking slates above this size "
                        "(each cross-encoder candidate costs a full PLM "
                        "pass); read by UnBERT serving only")
    return parser


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--model_name", type=str, default="Miner")
    p.add_argument("--pretrained_tokenizer", type=str, default="hash:30522",
                   help="local HF tokenizer directory, or hash[:vocab_size]")
    p.add_argument("--user2id_path", type=str)
    p.add_argument("--category2id_path", type=str)
    p.add_argument("--category_embed_path", type=str, default=None)
    p.add_argument("--max_title_length", type=int, default=32)
    p.add_argument("--max_sapo_length", type=int, default=128)
    p.add_argument("--his_length", type=int, default=50)
    p.add_argument("--seed", type=int, default=36)
    p.add_argument("--save_eval_result", action="store_true")
    p.add_argument("--save_ranking", action="store_true",
                   help="write the MIND-leaderboard prediction.txt")
    p.add_argument("--metrics", type=str, nargs="+",
                   default=["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"])
    p.add_argument("--evaluation_info", type=str, nargs="+",
                   default=["metrics", "loss"], choices=["loss", "metrics"],
                   help="'loss': eval loss and bestLossModel; 'metrics': the "
                        "ranking evaluator and bestAucModel")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; cuda without a card raises")
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="ranks on the data axis (-1: every rank not on another axis); "
                        "each rank takes its rows of every global batch and the "
                        "gradients are summed over them at each update. Ranks are "
                        "processes of python -m torch.distributed.run; the mesh must "
                        "cover them")
    p.add_argument("--mesh_table", type=int, default=1,
                   help="ranks on the table axis: the news-embedding cache's rows "
                        "are sharded over them (cached eval, --his_cache_refresh, "
                        "serving)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="ranks on the tensor-parallel axis: the transformer layers' "
                        "heads and feed-forward features and the MoE experts are "
                        "sharded over them")
    p.add_argument("--param_dtype", type=str, default="float32",
                   help="float32 only: fp32 master weights")
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=["default", "bfloat16", "bfloat16_3x", "float32"],
                   help=_TPU_ONLY + " (float32 matmuls on the card are full "
                        "float32; float32 attention runs the mha kernels' "
                        "products in split TF32, three TF32 passes to about "
                        "float32's accuracy)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each PLM layer in the backward "
                        "(torch.utils.checkpoint) to save device memory, "
                        "keeping the attention context, as JAX does: the "
                        "recompute launches no mha forward; UnBERT's layers "
                        "are never rematerialised, as in JAX")
    p.add_argument("--remat_policy", type=str, default="", choices=["", "dots"],
                   help="under --remat, 'dots' also keeps the output of every "
                        "product with no batch dims (qkv, out, ffn_in, "
                        "ffn_out), so the recompute runs no matmul, for ~9 x "
                        "hidden x tokens x 2 bytes more a layer; refused "
                        "without --remat, as in JAX")
    p.add_argument("--scan_layers", action=argparse.BooleanOptionalAction,
                   default=False, help=_TPU_ONLY)
    p.add_argument("--plm_preset", type=str, default="tiny",
                   choices=["roberta_base", "bert_base", "tiny", "small"],
                   help="PLM tower architecture preset")
    p.add_argument("--hf_checkpoint", type=str, default=None,
                   help="HF checkpoint dir (model.safetensors or "
                        "pytorch_model.bin) to import the PLM's weights from")
    p.add_argument("--legacy_poly_mask", action="store_true",
                   help="reproduce the reference's 1e-30 poly-attention mask fill")
    p.add_argument("--legacy_history_layout", action="store_true",
                   help="pads-FIRST history rows, as a model trained under "
                        "the reference's layout expects")
    p.add_argument("--force_layout_mismatch", action="store_true",
                   help="load a full-layout UniSRec artifact whose history "
                        "layout differs from this run's")
    p.add_argument("--cached_eval", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="evaluate from the news-embedding cache (one PLM pass "
                        "over the corpus instead of per-impression re-encoding)")
    p.add_argument("--his_cache_refresh", type=int, default=0,
                   help="train with history encodings from the news-embedding "
                        "cache, rebuilt from the live parameters every K "
                        "steps (0: off — encode history with the PLM every "
                        "step like the reference). Candidates always go "
                        "through the full PLM with gradients; history rows "
                        "are stop-gradient'd. ~90%% fewer news-tower FLOPs "
                        "at C=5/H=50; quality A/B in SCALE_r02.md")
    p.add_argument("--his_cache_warmup_steps", type=int, default=0,
                   help="with --his_cache_refresh: train the first N steps "
                        "with full history encoding (gradients through "
                        "history) before switching to the cache — from "
                        "scratch the candidate tower otherwise aligns to "
                        "frozen random interests and never learns semantics")
    p.add_argument("--fused_kernels", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the hand-written kernels; on the card they always "
                        "run (--no-fused_kernels is refused there)")
    p.add_argument("--attn_fp32", action=argparse.BooleanOptionalAction,
                   default=True,
                   help=_TPU_ONLY + " (the port's mha kernels keep the "
                        "softmax in fp32)")
    p.add_argument("--gelu_approx", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tanh-approximate gelu (default: auto — on for bf16 "
                        "compute, off for fp32)")
    p.add_argument("--compilation_cache_dir", type=str, default=None,
                   help=_TPU_ONLY)
    p.add_argument("--rng_impl", type=str, default=None,
                   choices=["threefry2x32", "rbg"], help=_TPU_ONLY)


def _add_model(p: argparse.ArgumentParser):
    p.add_argument("--apply_reduce_dim", action="store_true")
    p.add_argument("--use_sapo", action="store_true")
    p.add_argument("--freeze_transformer", action="store_true")
    p.add_argument("--word_embed_dim", type=int, default=256)
    p.add_argument("--category_embed_dim", type=int, default=100)
    p.add_argument("--combine_type", type=str, default="linear",
                   choices=["linear", "lstm", "pre-concat"])
    # every subcommand takes the lstm combine's depth, so that a model of
    # several layers evaluates and serves (the JAX package's train parser
    # alone has them: its eval and serve build one layer)
    p.add_argument("--lstm_num_layers", type=int, default=1)
    p.add_argument("--lstm_dropout", type=float, default=0.0)
    p.add_argument("--use_category_bias", action="store_true")
    p.add_argument("--num_context_codes", type=int, default=32)
    p.add_argument("--context_code_dim", type=int, default=200)
    p.add_argument("--score_type", type=str, default="weighted",
                   choices=["mean", "max", "weighted"])
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--pretrained_embedding", type=str, default=None,
                   help="PLM weights: a local HF directory (as "
                        "--hf_checkpoint); a hub name trains from random init")


def add_train_arguments(p: argparse.ArgumentParser):
    _add_common(p)
    _add_model(p)
    p.add_argument("--data_name", nargs="*", default=None, action=_JoinWords,
                   type=str, metavar="WORD")
    p.add_argument("--train_behaviors_path", type=str)
    p.add_argument("--train_news_path", type=str)
    p.add_argument("--eval_behaviors_path", type=str)
    p.add_argument("--eval_news_path", type=str)
    p.add_argument("--augmentations", nargs="*", default=None,
                   help="augmented news variants: <aug>_news.tsv beside "
                        "each news.tsv")
    p.add_argument("--augmentation_mode", type=str, default="base",
                   choices=["base", "hard", "unbert"],
                   help="hard: the hard sampler mode; base and unbert: the "
                        "base mode (UnBERT's sampler draws one candidate a "
                        "visit, whatever the mode)")
    p.add_argument("--online", type=int, default=0, choices=[0, 1])
    p.add_argument("--fast_eval", action="store_true")
    p.add_argument("--pretrained_model_path", type=str, default=None,
                   help="warm start from a port checkpoint: a whole model, "
                        "or a pretrain run's news encoder")
    p.add_argument("--unbert_news_layers", type=int, default=None,
                   help="UnBERT news-level encoder depth (default: the "
                        "PLM's depth, as model_unbert.py:70)")
    p.add_argument("--unbert_news_mode", type=str, default="nseg",
                   choices=["nseg", "mean", "attention"],
                   help="UnBERT news aggregation (reference: "
                        "model_unbert.py:160-200)")
    p.add_argument("--unisrec_train_all", action="store_true",
                   help="UniSRec: train every parameter, not the MoE "
                        "adaptor alone (--freeze_transformer still freezes "
                        "the PLM)")
    p.add_argument("--unisrec_pretrained_path", type=str, default=None,
                   help="UniSRec: graft a RecBole-layout or full-layout "
                        "UniSRec .pth into the model (strict=False)")
    p.add_argument("--train_path", type=str, default="train")
    p.add_argument("--tensorboard_path", type=str, default="runs")
    p.add_argument("--npratio", type=int, default=4)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--dataloader_drop_last", action="store_true",
                   help="accepted for config compatibility: batches are "
                        "fixed-shape index arrays")
    p.add_argument("--dataloader_num_workers", type=int, default=0,
                   help="accepted for config compatibility; ignored")
    p.add_argument("--dataloader_pin_memory", action="store_true",
                   help="accepted for config compatibility; ignored")
    p.add_argument("--max_steps", type=int, default=None,
                   help="the schedule's total updates (does not stop the loop)")
    p.add_argument("--fp16", action="store_true",
                   help="ignored: mixed precision is --compute_dtype bfloat16")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--warmup_steps", type=int, default=None)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--logging_steps", type=int, default=200)
    p.add_argument("--eval_steps", type=int, default=100000)
    p.add_argument("--resume_from", type=str, default=None,
                   help="port checkpoint to fully resume (params, optimizer, "
                        "step)")


def add_eval_arguments(p: argparse.ArgumentParser):
    _add_common(p)
    _add_model(p)
    p.add_argument("--saved_model_path", type=str,
                   help="port checkpoint (<run_dir>/ckpt/<name>) to evaluate "
                        "or serve")
    p.add_argument("--data_name", nargs="*", default=None, action=_JoinWords,
                   type=str, metavar="WORD")
    p.add_argument("--eval_behaviors_path", type=str)
    p.add_argument("--eval_news_path", type=str)
    p.add_argument("--fast_eval", action="store_true")
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--dataloader_num_workers", type=int, default=0,
                   help="accepted for config compatibility; ignored")
    p.add_argument("--dataloader_pin_memory", action="store_true",
                   help="accepted for config compatibility; ignored")
    p.add_argument("--eval_path", type=str, default="eval")
    p.add_argument("--npratio", type=int, default=4)


def plm_config(preset: str, vocab_size: Optional[int] = None,
               gelu_approx: Optional[bool] = None,
               remat: bool = False, remat_policy: str = "") -> PLMConfig:
    if preset == "roberta_base":
        cfg = PLMConfig.roberta_base()
    elif preset == "bert_base":
        cfg = PLMConfig.bert_base()
    elif preset == "small":
        cfg = dc.replace(PLMConfig.bert_base(), hidden_size=256, num_layers=4,
                         num_heads=8, intermediate_size=1024)
    elif preset == "tiny":
        cfg = PLMConfig.tiny()
    else:
        raise ValueError(f"unknown plm preset {preset!r}")
    if vocab_size is not None:
        cfg = dc.replace(cfg, vocab_size=vocab_size)
    if gelu_approx is not None:
        cfg = dc.replace(cfg, gelu_approx=gelu_approx)
    if remat:
        cfg = dc.replace(cfg, remat=True, remat_policy=remat_policy)
    return cfg
