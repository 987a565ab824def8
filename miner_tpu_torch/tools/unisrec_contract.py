"""UniSRec's pretrain -> export -> finetune contract on the port.

The port's counterpart of the JAX package's ``tools/unisrec_contract.py``.
The reference finetunes UniSRec from a pretrained RecBole checkpoint with
all but the MoE adaptor frozen; none can be fetched here, so the artifact
is made in place and the whole contract is run:

  stage A  UniSRec trained with ``--unisrec_train_all`` (optionally its PLM
           warm-started from a transformers-format directory,
           ``--stage_a_pretrained_embedding``; ``--probe`` stops here);
  stage B  its ``finalModel`` exported to the reference's RecBole layout
           (``export_recbole``), the artifact ``--unisrec_pretrained_path``
           takes;
  stage C  finetuned from the artifact under the MoE-only freeze; with
           ``--stage_c_baseline`` first one epoch at lr 0 under the same
           freeze, the artifact's own eval, the line adaptation is read
           against. ``--stage_c_data`` (generated with
           ``--stage_c_topics`` / ``--stage_c_events`` if absent) finetunes
           on another corpus.

    python -m miner_tpu_torch.tools.unisrec_contract --out scale_smoke \\
        --stage_a_lr 3e-4 --stage_a_epochs 4 --stage_c_epochs 2 [--stage_c_baseline]

On a card in bf16 with the hand-written kernels, the JAX tool's default
compute type (``--dtype fp32`` for float32); ``--device cpu`` runs the plain
versions. Each stage prints its per-epoch eval table; ``--report`` appends
them to a markdown file.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import time
from typing import List, Optional, Sequence

METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]


def stage_argv(data: str, train_dir: str, epochs: int, lr: float, seed: int, batch: int,
               plm_preset: str = "small", device: Optional[str] = None, dtype: str = "bf16",
               extra: Sequence[str] = ()) -> List[str]:
    """The JAX tool's ``_argv`` (``train_fastformer --model_name unisrec``
    over pre-concatenated titles of 32 + 2 - 1 tokens) with ``--device``
    and, for ``--dtype fp32``, ``--compute_dtype float32``."""
    argv = [
        "train_fastformer",
        "--model_name", "unisrec",
        "--pretrained_tokenizer", "hash:30522",
        "--user2id_path", os.path.join(data, "user2id.json"),
        "--category2id_path", os.path.join(data, "category2id.json"),
        "--train_behaviors_path", os.path.join(data, "behaviors.tsv"),
        "--train_news_path", os.path.join(data, "news.tsv"),
        "--eval_behaviors_path", os.path.join(data, "eval_behaviors.tsv"),
        "--eval_news_path", os.path.join(data, "news.tsv"),
        "--max_title_length", "32", "--max_sapo_length", "2",
        "--his_length", "50", "--seed", str(seed),
        "--plm_preset", plm_preset, "--npratio", "4", "--online", "1",
        "--combine_type", "pre-concat",
        "--train_batch_size", str(batch), "--eval_batch_size", "512",
        "--num_train_epochs", str(epochs), "--learning_rate", str(lr),
        "--logging_steps", "500", "--metrics", *METRICS,
        "--train_path", train_dir,
        *extra,
    ]
    if dtype == "fp32":
        argv += ["--compute_dtype", "float32"]
    if device:
        argv += ["--device", device]
    return argv


def run_stage(argv: Sequence[str]) -> float:
    """Train one stage through the port's ``Trainer``; its seconds."""
    from miner_tpu_torch.config import make_parser
    from miner_tpu_torch.training.trainer import Trainer

    t0 = time.time()
    Trainer(make_parser().parse_args(list(argv))).train()
    return time.time() - t0


def epoch_rows(train_dir: str):
    """The newest run under ``train_dir`` and its last eval row by epoch."""
    rd = sorted(glob.glob(os.path.join(train_dir, "*")))[-1]
    with open(os.path.join(rd, "eval.csv")) as f:
        rows = list(csv.DictReader(f))
    return rd, {int(float(r["epoch"])): r for r in rows}


def table(by_epoch: dict) -> str:
    out = ["| epoch | " + " | ".join(METRICS) + " |", "|---|" + "---|" * len(METRICS)]
    for ep in sorted(by_epoch):
        r = by_epoch[ep]
        out.append("| " + str(ep) + " | " + " | ".join(f"{float(r[m]):.4f}" for m in METRICS)
                   + " |")
    return "\n".join(out)


def export_recbole(ckpt: str, pth_path: str) -> int:
    """A port checkpoint of UniSRec -> the reference's RecBole-layout state
    dict (``unisrec_pretained_state_dict.pth``'s class of artifact), written
    to ``pth_path``. Returns the number of tensors."""
    import torch

    from miner_tpu_torch.models.hf_import import export_unisrec_state_dict
    from miner_tpu_torch.training import checkpoint

    sd = export_unisrec_state_dict(checkpoint.load(ckpt)["params"])
    torch.save({k: v.detach().cpu().contiguous().clone() for k, v in sd.items()}, pth_path)
    return len(sd)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="scale_smoke")
    ap.add_argument("--news", type=int, default=60000)
    ap.add_argument("--events", type=int, default=50000)
    ap.add_argument("--eval_lines", type=int, default=5000)
    ap.add_argument("--stage_a_lr", type=float, default=3e-4)
    ap.add_argument("--stage_a_epochs", type=int, default=4)
    ap.add_argument("--stage_c_lr", type=float, default=1e-4)
    ap.add_argument("--stage_c_epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--probe", action="store_true", help="stage A only (lr probing)")
    ap.add_argument("--stage_a_ckpt", default=None,
                    help="skip stage A; export and finetune from this finalModel")
    ap.add_argument("--tag", default="")
    ap.add_argument("--plm_preset", default=None,
                    help="tower preset override (default small; tiny for wiring checks)")
    ap.add_argument("--stage_a_pretrained_embedding", default=None,
                    help="warm-start stage A's PLM tower from a transformers-format "
                         "checkpoint dir (e.g. warmstart_ab.export_hf_checkpoint's)")
    ap.add_argument("--report", default=None, help="append the markdown summary to this file")
    ap.add_argument("--topics", default=None,
                    help="comma-separated topic indices of the main corpus, e.g. 0,1,2,3")
    ap.add_argument("--stage_c_data", default=None,
                    help="finetune stage C on this corpus instead (generated if absent)")
    ap.add_argument("--stage_c_topics", default=None,
                    help="topic indices for generating --stage_c_data, e.g. 4,5,6,7")
    ap.add_argument("--stage_c_events", type=int, default=None,
                    help="train lines of the stage C corpus (default: --events)")
    ap.add_argument("--stage_c_baseline", action="store_true",
                    help="before stage C, the artifact's own eval on the finetune corpus "
                         "(1 epoch at lr 0 under the same freeze)")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    preset = args.plm_preset or "small"

    def topic_list(spec):
        return [int(x) for x in spec.split(",")] if spec else None

    def argv_(data, train_dir, epochs, lr, extra=()):
        return stage_argv(data, train_dir, epochs, lr, args.seed, args.batch, preset,
                          args.device, args.dtype, extra)

    from miner_tpu_torch.tools.synth_mind import make_synth_mind

    data = os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(data, "behaviors.tsv")):
        t0 = time.time()
        make_synth_mind(data, n_news=args.news, n_users=args.events // 10,
                        n_train_lines=args.events, n_eval_lines=args.eval_lines,
                        hist_len=(30, 50), topics=topic_list(args.topics))
        print(f"corpus generated in {time.time() - t0:.0f}s", flush=True)
    c_data = data
    if args.stage_c_data:
        c_data = args.stage_c_data
        if not os.path.exists(os.path.join(c_data, "behaviors.tsv")):
            t0 = time.time()
            c_events = args.stage_c_events or args.events
            make_synth_mind(c_data, n_news=args.news, n_users=c_events // 10,
                            n_train_lines=c_events, n_eval_lines=args.eval_lines,
                            hist_len=(30, 50), topics=topic_list(args.stage_c_topics),
                            seed=23)
            print(f"stage-C corpus generated in {time.time() - t0:.0f}s", flush=True)

    report, result = [], {}
    if args.stage_a_ckpt:
        a_ckpt = args.stage_a_ckpt
    else:
        a_dir = os.path.join(args.out, f"unisrec_a_lr{args.stage_a_lr}{args.tag}")
        a_extra = ("--unisrec_train_all",)
        if args.stage_a_pretrained_embedding:
            a_extra += ("--pretrained_embedding", args.stage_a_pretrained_embedding)
        secs = run_stage(argv_(data, a_dir, args.stage_a_epochs, args.stage_a_lr, a_extra))
        rd, rows = epoch_rows(a_dir)
        result["a"] = dict(run_dir=rd, rows=rows, seconds=secs)
        print(f"stage A (train_all, lr {args.stage_a_lr}, {args.stage_a_epochs} ep, "
              f"{secs:.0f}s): auc {float(rows[max(rows)]['auc']):.4f}")
        print(table(rows), flush=True)
        report += [f"\n### stage A — from-scratch `--unisrec_train_all` (lr {args.stage_a_lr}, "
                   f"{args.stage_a_epochs} ep, {secs:.0f}s)\n", table(rows)]
        if args.probe:
            if args.report:
                with open(args.report, "a") as f:
                    f.write("\n".join(report) + "\n")
            return result
        a_ckpt = os.path.join(rd, "ckpt", "finalModel")

    pth = os.path.join(args.out, "unisrec_pretained_state_dict.pth")
    n = export_recbole(a_ckpt, pth)
    result["exported"] = n
    print(f"stage B: exported {n} tensors -> {pth} (RecBole layout)", flush=True)
    report += [f"\n### stage B — RecBole-layout export: {n} tensors\n"]

    shifted = " [domain-shifted corpus]" if c_data != data else ""
    if args.stage_c_baseline:
        # the artifact's own function on the finetune corpus: 1 epoch at
        # lr 0 under the same freeze, nothing moves
        b_dir = os.path.join(args.out, f"unisrec_cbase{args.tag}")
        secs = run_stage(argv_(c_data, b_dir, 1, 0.0, ("--unisrec_pretrained_path", pth)))
        rd, brows = epoch_rows(b_dir)
        result["baseline"] = dict(run_dir=rd, rows=brows, seconds=secs)
        print(f"stage C baseline (artifact function on finetune corpus, lr 0, {secs:.0f}s): "
              f"auc {float(brows[max(brows)]['auc']):.4f}", flush=True)
        report += [f"\n### stage C baseline — artifact function on the finetune "
                   f"corpus{shifted} (lr 0, {secs:.0f}s)\n", table(brows)]

    c_dir = os.path.join(args.out, f"unisrec_c_lr{args.stage_c_lr}{args.tag}")
    secs = run_stage(argv_(c_data, c_dir, args.stage_c_epochs, args.stage_c_lr,
                           ("--unisrec_pretrained_path", pth)))
    rd, rows = epoch_rows(c_dir)
    result["c"] = dict(run_dir=rd, rows=rows, seconds=secs)
    print(f"stage C (MoE-only freeze from artifact, lr {args.stage_c_lr}, "
          f"{args.stage_c_epochs} ep, {secs:.0f}s): auc {float(rows[max(rows)]['auc']):.4f}")
    print(table(rows), flush=True)
    report += [f"\n### stage C — finetune under the reference freeze (MoE-only, "
               f"lr {args.stage_c_lr}, {args.stage_c_epochs} ep, {secs:.0f}s){shifted}\n",
               table(rows)]
    if args.report:
        with open(args.report, "a") as f:
            f.write("\n".join(report) + "\n")
        print(f"report appended -> {args.report}")
    return result


if __name__ == "__main__":
    main()
