"""At-scale convergence runs on the planted synthetic corpus, on the port.

The port's counterpart of the JAX package's ``tools/scale_convergence.py``
(the same flags, corpus, recipes and per-epoch table): trains the Miner,
UnBERT, Fastformer or UniSRec for N epochs on the 60,000-news /
50,000-line corpus of ``synth_mind`` (seed 11, histories of 30-50 news,
the corpus the JAX package's SCALE tables were read on) through the port's
``Trainer``, then prints the per-epoch eval metrics as a markdown table and
the examples/s of the run.

    python -m miner_tpu_torch.tools.scale_convergence --model miner  [--epochs 4] [--dtype bf16]
    python -m miner_tpu_torch.tools.scale_convergence --model unbert [--epochs 3]
    python -m miner_tpu_torch.tools.scale_convergence --model fastformer
    python -m miner_tpu_torch.tools.scale_convergence --model unisrec

Fastformer and UniSRec run recipes fit for a tower trained from scratch: no
--freeze_transformer, and UniSRec with --unisrec_train_all (a frozen
randomly initialised PLM cannot learn the planted text signal).

The corpus is generated under --out if absent.
"""
from __future__ import annotations

import argparse
import csv
import os
import time
from typing import List, Optional

METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]
MODEL_NAME = {"miner": "Miner", "unbert": "unbert", "fastformer": "fastformer",
              "unisrec": "unisrec"}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=list(MODEL_NAME), required=True)
    ap.add_argument("--out", default="scale_convergence",
                    help="work directory: the corpus under data/, the runs beside it")
    ap.add_argument("--news", type=int, default=60000)
    ap.add_argument("--events", type=int, default=50000)
    ap.add_argument("--eval_lines", type=int, default=5000)
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: 3 for unbert, 4 for the others")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                    help="fp32 passes --compute_dtype float32 and keeps the "
                         "hand-written kernels on (their fp32 routes): the port "
                         "refuses --no-fused_kernels on a card")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--legacy_history_layout", action="store_true",
                    help="run on the reference's pads-first history rows "
                         "(for layout A/Bs)")
    ap.add_argument("--pretrained_embedding", default=None,
                    help="transformers-format checkpoint dir to warm-start "
                         "the PLM tower (at-scale warm-start legs)")
    ap.add_argument("--stop_after_epochs", type=int, default=None,
                    help="train the first N epochs of the --epochs schedule and "
                         "stop (the learning rate as in the full run: its "
                         "warmup and decay span --epochs), e.g. epoch 0 of the "
                         "4-epoch recipe whose epoch-0 auc the tables give")
    ap.add_argument("--tag", default="", help="suffix for the run dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--parse_only", action="store_true",
                    help="build + parse the trainer argv and exit (wiring "
                         "check, no corpus/training)")
    return ap


def train_events(behaviors_path: str) -> int:
    """The training events of a behaviors file as ``BehaviorsLog`` counts
    them: one a positive of each line that also has a negative."""
    n = 0
    with open(behaviors_path, encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 5:
                continue
            labels = [b.rpartition("-")[2] for b in cols[4].split()]
            pos = labels.count("1")
            if pos and len(labels) > pos:
                n += pos
    return n


def trainer_argv(args, data: str, train_dir: str) -> List[str]:
    """The port's trainer argv for ``args.model``: the JAX tool's, with
    ``--device`` and without ``--no-fused_kernels``; under
    ``--stop_after_epochs N``, N epochs with the schedule's updates
    (``--max_steps``) those of the whole run (the Miner, Fastformer and
    UniSRec: an update a batch of the epoch's events)."""
    epochs = args.epochs or (3 if args.model == "unbert" else 4)
    argv = [
        "train" if args.model == "miner" else "train_fastformer",
        "--model_name", MODEL_NAME[args.model],
        "--pretrained_tokenizer", "hash:30522",
        "--user2id_path", os.path.join(data, "user2id.json"),
        "--category2id_path", os.path.join(data, "category2id.json"),
        "--train_behaviors_path", os.path.join(data, "behaviors.tsv"),
        "--train_news_path", os.path.join(data, "news.tsv"),
        "--eval_behaviors_path", os.path.join(data, "eval_behaviors.tsv"),
        "--eval_news_path", os.path.join(data, "news.tsv"),
        "--max_title_length", "32",
        "--max_sapo_length", "2",
        "--his_length", "50",
        "--seed", str(args.seed),
        "--plm_preset", "small",
        "--npratio", "4",
        "--online", "1",
        "--train_batch_size", str(args.batch),
        "--eval_batch_size", "512",
        "--num_train_epochs", str(epochs),
        "--learning_rate", str(args.lr),
        "--logging_steps", "500",
        "--metrics", *METRICS,
        "--train_path", train_dir,
    ]
    if args.model in ("miner", "unbert"):
        # the Miner / UnBERT recipe of the JAX tables (unbert ignores the
        # Miner-only flags)
        argv += ["--apply_reduce_dim", "--use_category_bias",
                 "--word_embed_dim", "256",
                 "--category_embed_dim", "100",
                 "--num_context_codes", "32",
                 "--context_code_dim", "200",
                 "--score_type", "weighted"]
    if args.model == "unbert":
        argv += ["--unbert_news_layers", "4"]
    if args.model == "fastformer":
        # config/train_fastformer.txt's recipe minus --freeze_transformer
        argv += ["--apply_reduce_dim", "--word_embed_dim", "256",
                 "--combine_type", "linear"]
    if args.model == "unisrec":
        # config/train_unisrec.txt's recipe with --unisrec_train_all
        argv += ["--combine_type", "pre-concat", "--unisrec_train_all"]
    if args.dtype == "fp32":
        argv += ["--compute_dtype", "float32"]
    if args.legacy_history_layout:
        argv += ["--legacy_history_layout"]
    if args.pretrained_embedding:
        argv += ["--pretrained_embedding", args.pretrained_embedding]
    if args.device:
        argv += ["--device", args.device]
    if args.stop_after_epochs:
        if args.model == "unbert":
            raise SystemExit("--stop_after_epochs: UnBERT's epoch is its packed rows, "
                             "not the events; run its whole schedule")
        steps = train_events(os.path.join(data, "behaviors.tsv")) // args.batch
        argv += ["--num_train_epochs", str(args.stop_after_epochs),
                 "--max_steps", str(steps * epochs)]
    return argv


def make_corpus(args, data: str) -> None:
    """The at-scale corpus under ``data`` (the JAX tool's parameters)."""
    from miner_tpu_torch.tools.synth_mind import make_synth_mind

    t0 = time.time()
    make_synth_mind(data, n_news=args.news, n_users=args.events // 10,
                    n_train_lines=args.events, n_eval_lines=args.eval_lines,
                    hist_len=(30, 50))
    print(f"corpus generated in {time.time() - t0:.0f}s", flush=True)


def epoch_rows(run_dir: str) -> dict:
    """The last eval row of each epoch of a run's ``eval.csv``, by epoch."""
    with open(os.path.join(run_dir, "eval.csv")) as f:
        rows = list(csv.DictReader(f))
    return {int(float(r["epoch"])): r for r in rows}


def main(argv: Optional[List[str]] = None) -> Optional[dict]:
    args = make_parser().parse_args(argv)
    from miner_tpu_torch.config import make_parser as trainer_parser

    data = os.path.join(args.out, "data")
    train_dir = os.path.join(args.out, f"conv_{args.model}{args.tag}")
    if args.parse_only:
        parsed = trainer_parser().parse_args(trainer_argv(args, data, train_dir))
        print(f"parse ok: mode={parsed.mode} model_name={parsed.model_name}")
        return None
    if not os.path.exists(os.path.join(data, "category2id.json")):  # its last file
        make_corpus(args, data)
    argv_ = trainer_argv(args, data, train_dir)

    from miner_tpu_torch.training.trainer import Trainer

    epochs = args.epochs or (3 if args.model == "unbert" else 4)
    trainer = Trainer(trainer_parser().parse_args(argv_))
    t0 = time.time()
    run = trainer.train()
    train_s = time.time() - t0
    rd = run.run_dir
    by_epoch = epoch_rows(rd)
    # the epochs' examples over their time (epoch.csv: each epoch's seconds,
    # its eval included), the batches actually taken
    with open(os.path.join(rd, "epoch.csv")) as f:
        epoch_s = [float(r["seconds"]) for r in csv.DictReader(f)]
    examples = run.step * trainer.args.train_batch_size
    eps = examples / sum(epoch_s) if epoch_s else float("nan")
    # the trainer's own rate over each --logging_steps window, evals apart
    rates = []
    if os.path.exists(os.path.join(rd, "throughput.csv")):
        with open(os.path.join(rd, "throughput.csv")) as f:
            rates = sorted(float(r["examples_per_sec"]) for r in csv.DictReader(f))
    train_eps = rates[len(rates) // 2] if rates else float("nan")
    stop = (f", stopped after {args.stop_after_epochs}" if args.stop_after_epochs else "")
    print(f"\n{args.model} at-scale convergence ({epochs} epochs{stop}, "
          f"{args.dtype}, seed {args.seed}, {train_s:.0f}s train, "
          f"layout={'legacy' if args.legacy_history_layout else 'clicks-first'})")
    print("| epoch | " + " | ".join(METRICS) + " |")
    print("|---|" + "---|" * len(METRICS))
    for ep in sorted(by_epoch):
        r = by_epoch[ep]
        print("| " + str(ep) + " | "
              + " | ".join(f"{float(r[m]):.4f}" for m in METRICS) + " |")
    print(f"{examples} examples in {sum(epoch_s):.1f} s of epochs (evals included): "
          f"{eps:.1f} examples/s; while training {train_eps:.1f} examples/s (median of "
          f"{len(rates)} windows of --logging_steps); epochs "
          f"{[round(s, 1) for s in epoch_s]} s")
    print(f"run dir: {rd}")
    return {"run_dir": rd, "train_s": train_s, "epoch_s": epoch_s,
            "examples_per_s": eps, "train_examples_per_s": train_eps, "steps": run.step,
            "epochs": {ep: {m: float(r[m]) for m in METRICS} for ep, r in by_epoch.items()}}


if __name__ == "__main__":
    main()
