"""One command: MIND archive -> prepared splits -> train -> standalone eval.

The port's counterpart of the JAX package's ``tools/turnkey_mind.py``, over
the port's ``Trainer``, with the same flags and summary line. It accepts a
.zip archive or a directory holding ``behaviors.tsv`` + ``news.tsv`` in
either the raw MIND column order or the reference's derived order (told
apart by ``prepare_mind``), then:

  1. extracts it (if a zip) and finds the TSVs;
  2. ``prepare_mind`` -> train/ valid/ splits + user2id/category2id;
  3. trains the Miner on the train split, evaluating on valid;
  4. runs a standalone eval from ``bestAucModel`` (else ``finalModel``)
     with ``--save_eval_result`` (preds.pkl + per-impression metric dumps,
     the reference's eval artifacts).

It prints one JSON summary line. It runs on ``--device`` (default ``cuda``:
bf16 and the hand-written kernels; ``cpu``: float32 and the kernels' plain
versions). The defaults are a small drill (tiny tower, hash tokenizer); for
the real corpus pass the production flags of ``RUNBOOK_MIND.md``:

  python -m miner_tpu_torch.tools.turnkey_mind --archive MINDsmall.zip \\
      --out /data/mind --plm_preset roberta_base \\
      --pretrained_tokenizer /ckpts/roberta-base \\
      --hf_checkpoint /ckpts/roberta-base \\
      --title_len 32 --sapo_len 128 --his_len 50 --batch 42 --accum 3 \\
      --epochs 5 --lr 2e-5
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
import zipfile
from typing import List, Optional

METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]


def _find(root: str, name: str) -> str:
    hits = sorted(glob.glob(os.path.join(root, "**", name), recursive=True))
    if not hits:
        raise FileNotFoundError(f"no {name} under {root}")
    return hits[0]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archive", required=True,
                    help=".zip archive or directory with behaviors.tsv + "
                         "news.tsv (raw MIND or reference-derived layout)")
    ap.add_argument("--out", required=True, help="work/output directory")
    ap.add_argument("--valid_impressions", type=int, default=2500)
    ap.add_argument("--plm_preset", default="tiny")
    ap.add_argument("--pretrained_tokenizer", default="hash:30522",
                    help="HF tokenizer directory (local files only), or "
                         "hash:<vocab> for the dependency-free hash tokenizer")
    ap.add_argument("--hf_checkpoint", default=None,
                    help="transformers-format checkpoint dir to warm-start "
                         "the PLM tower (e.g. a local roberta-base)")
    ap.add_argument("--title_len", type=int, default=16)
    ap.add_argument("--sapo_len", type=int, default=24)
    ap.add_argument("--his_len", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=36)
    ap.add_argument("--compute_dtype", default=None,
                    help="default: bfloat16 on a card, float32 on the CPU")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def default_dtype(args) -> str:
    """``--compute_dtype``, else bfloat16 on a card and float32 on the CPU."""
    from miner_tpu_torch.utils import resolve_device

    return args.compute_dtype or (
        "bfloat16" if resolve_device(args.device).type == "cuda" else "float32")


def common_argv(args, data: str, dtype: str) -> List[str]:
    """The flags the train and eval runs share."""
    return [
        "--model_name", "Miner",
        "--pretrained_tokenizer", args.pretrained_tokenizer,
        "--user2id_path", os.path.join(data, "user2id.json"),
        "--category2id_path", os.path.join(data, "category2id.json"),
        "--eval_news_path", os.path.join(data, "valid", "news.tsv"),
        "--max_title_length", str(args.title_len),
        "--max_sapo_length", str(args.sapo_len),
        "--his_length", str(args.his_len),
        "--seed", str(args.seed),
        "--plm_preset", args.plm_preset,
        "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
        "--word_embed_dim", "256", "--category_embed_dim", "100",
        "--num_context_codes", "32", "--context_code_dim", "200",
        "--score_type", "weighted",
        "--compute_dtype", dtype,
        "--metrics", *METRICS,
        *(["--device", args.device] if args.device else []),
    ]


def train_argv(args, data: str, train_dir: str, dtype: str) -> List[str]:
    """The port's ``train`` argv, as the JAX tool builds its own."""
    argv = ["train", *common_argv(args, data, dtype),
            "--train_behaviors_path", os.path.join(data, "train", "behaviors.tsv"),
            "--train_news_path", os.path.join(data, "train", "news.tsv"),
            "--eval_behaviors_path", os.path.join(data, "valid", "behaviors.tsv"),
            "--npratio", "4",
            "--train_batch_size", str(args.batch),
            "--gradient_accumulation_steps", str(args.accum),
            "--num_train_epochs", str(args.epochs),
            "--learning_rate", str(args.lr),
            "--train_path", train_dir]
    if args.hf_checkpoint:
        argv += ["--hf_checkpoint", args.hf_checkpoint]
    return argv


def eval_argv(args, data: str, ckpt: str, eval_dir: str, dtype: str) -> List[str]:
    """The standalone ``eval`` argv: ``ckpt`` scored on the valid split
    with the artifact dumps."""
    return ["eval", *common_argv(args, data, dtype),
            "--eval_behaviors_path", os.path.join(data, "valid", "behaviors.tsv"),
            "--saved_model_path", ckpt,
            "--eval_batch_size", "64",
            "--save_eval_result",
            "--eval_path", eval_dir]


def main(argv: Optional[List[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    t_all = time.time()
    os.makedirs(args.out, exist_ok=True)

    # ---- 1. extract / locate ------------------------------------------
    src = args.archive
    if zipfile.is_zipfile(src):
        extract_dir = os.path.join(args.out, "raw")
        with zipfile.ZipFile(src) as z:
            z.extractall(extract_dir)
        src = extract_dir
        print(f"extracted {args.archive} -> {extract_dir}", flush=True)
    raw_behaviors = _find(src, "behaviors.tsv")
    raw_news = _find(src, "news.tsv")

    # ---- 2. prepare splits + id maps ----------------------------------
    from miner_tpu_torch.tools import prepare_mind

    data = os.path.join(args.out, "data")
    prepare_mind.main([
        "--raw_behaviors", raw_behaviors, "--raw_news", raw_news,
        "--out_dir", data, "--valid_impressions",
        str(args.valid_impressions), "--seed", str(args.seed),
    ])

    # ---- 3. train ------------------------------------------------------
    from miner_tpu_torch.config import make_parser as trainer_parser
    from miner_tpu_torch.training.trainer import Trainer

    dtype = default_dtype(args)
    train_dir = os.path.join(args.out, "train_out")
    t0 = time.time()
    run = Trainer(trainer_parser().parse_args(train_argv(args, data, train_dir, dtype))).train()
    train_s = time.time() - t0

    # best-AUC checkpoint if eval selected one, else the final model
    ckpt = os.path.join(run.run_dir, "ckpt", "bestAucModel")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(run.run_dir, "ckpt", "finalModel")
    del run  # the trained model's device memory, before the eval builds its own

    # ---- 4. standalone eval with artifact dumps ------------------------
    eval_dir = os.path.join(args.out, "eval_out")
    t0 = time.time()
    scores = Trainer(trainer_parser().parse_args(
        eval_argv(args, data, ckpt, eval_dir, dtype))).eval()
    eval_s = time.time() - t0
    erun = sorted(glob.glob(os.path.join(eval_dir, "*")))[-1]

    summary = {
        "data_dir": data,
        "checkpoint": ckpt,
        "scores": scores,
        "preds_pkl": os.path.join(erun, "preds.pkl"),
        "train_s": round(train_s, 1),
        "eval_s": round(eval_s, 1),
        "total_s": round(time.time() - t_all, 1),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
