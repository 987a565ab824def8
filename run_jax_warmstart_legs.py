#!/usr/bin/env python3
"""The JAX package's arms of the warm-start A/B, from any donor tower.

    python -m miner_tpu_torch.tools.warmstart_ab --out ws --artifact domain --arms
    JAX_PLATFORMS=cpu python run_jax_warmstart_legs.py --out ws --train_donor --seeds
    JAX_PLATFORMS=cpu python run_jax_warmstart_legs.py --out ws --donor ws/hf_domain \\
        --label port --seeds 13 14 15 [--arms warm cold]

Run it where JAX is installed (it imports the JAX package, as
``convert_jax_checkpoint.py`` does; the port never does). It trains through
the JAX tool's own ``_common_argv`` and ``run_cli``
(``tools/warmstart_ab.py``), at that tool's geometry and finetune recipe
(the tiny tower, 1 epoch at lr 5e-4, batch 32, float32 on the plain
versions), on the corpus the port's tool wrote under ``--out/data``:

- ``--train_donor``: JAX's domain donor, the JAX tool's stage 1 (a Miner,
  ``--pretrain_epochs`` epochs at ``--seed 1``, or ``--donor_seed``, on
  ``--out/domain_data``), into ``--out/jax_domain_pre``; its eval after
  each epoch is printed and its tower exported to ``--out/jax_hf_domain``
  (the JAX tool's ``export_hf_checkpoint``). ``convert_jax_checkpoint.py``
  turns it into a port checkpoint: written to a port tool's ``--out`` as
  ``domain_pre/train/<run>/ckpt/finalModel`` (its ``eval.csv`` copied
  beside ``ckpt/``), it is that tool's donor.
- ``--donor DIR``: each seed's warm arm (``--pretrained_embedding DIR``, a
  transformers-format directory: the port's ``export_hf_checkpoint`` writes
  JAX's format) and cold arm, into ``--out/jax-<label>_<arm>_<seed>``.

The rows print in the port tool's table format; a run already finished
(its ``eval.csv`` holds an epoch) is read, not trained again.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]


def miner_extra(jax_ws):
    """The JAX tool's Miner flags (``miner_extra`` of its ``main``)."""
    return ("--model_name", "Miner", "--use_category_bias",
            "--category_embed_dim", str(jax_ws.D_CAT),
            "--num_context_codes", str(jax_ws.K), "--context_code_dim", str(jax_ws.P_DIM),
            "--score_type", "weighted", "--metrics", *METRICS)


def eval_rows(run_out):
    runs = sorted(glob.glob(os.path.join(run_out, "train", "*", "eval.csv")))
    if not runs:
        return []
    with open(runs[-1]) as f:
        return [{k: float(v) for k, v in r.items() if v not in (None, "")}
                for r in csv.DictReader(f)]


def train_donor(args, jax_ws) -> str:
    """JAX's domain donor: trained (or reused), printed, exported."""
    pre_out = os.path.join(args.out, "jax_domain_pre")
    if not eval_rows(pre_out):
        shutil.rmtree(pre_out, ignore_errors=True)
        secs = jax_ws.run_cli(jax_ws._common_argv(
            os.path.join(args.out, "domain_data"), pre_out, "train", args.pretrain_epochs,
            args.finetune_lr, seed=args.donor_seed, extra=miner_extra(jax_ws)))
        print(f"JAX domain pretrain done in {secs:.0f}s", flush=True)
    rows = eval_rows(pre_out)
    print("JAX donor eval by epoch: " + "; ".join(
        f"epoch {int(r['epoch'])} auc {r['auc']:.4f} group_auc {r['group_auc']:.4f}"
        for r in rows), flush=True)
    run_dir = jax_ws.latest_run_dir(pre_out)
    hf_dir = jax_ws.export_hf_checkpoint(os.path.join(run_dir, "ckpt", "finalModel"),
                                         os.path.join(args.out, "jax_hf_domain"))
    print(f"exported transformers-format checkpoint -> {hf_dir}", flush=True)
    return hf_dir


def run_arms(args, jax_ws):
    rows = []
    data_dir = os.path.join(args.out, "data")
    for seed in args.seeds:
        for arm in args.arms:
            extra = miner_extra(jax_ws)
            if arm == "warm":
                extra += ("--pretrained_embedding", os.path.abspath(args.donor))
            label = f"jax-{args.label}_{arm}" if arm == "warm" else "jax_cold"
            run_out = os.path.join(args.out, f"{label}_{seed}")
            if eval_rows(run_out):
                secs = float("nan")
            else:
                shutil.rmtree(run_out, ignore_errors=True)
                secs = jax_ws.run_cli(jax_ws._common_argv(
                    data_dir, run_out, "train", args.finetune_epochs, args.finetune_lr,
                    seed=seed, extra=extra))
            rows.append((f"{label} seed={seed}", eval_rows(run_out)[-1], secs))
            print(rows[-1], flush=True)
    lines = [f"miner_tpu (CPU fp32), warm from {args.donor}: finetune "
             f"{args.finetune_epochs} ep @ lr {args.finetune_lr}, batch {jax_ws.BATCH}\n",
             "| run | " + " | ".join(METRICS) + " | train s |",
             "|---|" + "---|" * (len(METRICS) + 1)]
    for label, scores, secs in rows:
        lines.append("| " + label + " | " + " | ".join(
            f"{scores.get(m, float('nan')):.4f}" for m in METRICS) + f" | {secs:.0f} |")
    print("\n".join(lines), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="the port tool's --out (its corpora in data/ and domain_data/)")
    ap.add_argument("--train_donor", action="store_true")
    ap.add_argument("--donor_seed", type=int, default=1,
                    help="with --train_donor: its training --seed (the JAX tool's: 1)")
    ap.add_argument("--donor", default=None, help="a transformers-format tower directory")
    ap.add_argument("--label", default="donor", help="names the warm runs' directories")
    ap.add_argument("--seeds", type=int, nargs="*", default=[13, 14, 15])
    ap.add_argument("--arms", nargs="*", choices=["warm", "cold"], default=["warm", "cold"])
    ap.add_argument("--pretrain_epochs", type=int, default=2)
    ap.add_argument("--finetune_epochs", type=int, default=1)
    ap.add_argument("--finetune_lr", type=float, default=5e-4)
    args = ap.parse_args(argv)
    if "warm" in args.arms and args.seeds and not args.donor and not args.train_donor:
        raise SystemExit("the warm arm needs --donor DIR (or --train_donor)")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tools import warmstart_ab as jax_ws

    result = {}
    if args.train_donor:
        result["hf_dir"] = train_donor(args, jax_ws)
        args.donor = args.donor or result["hf_dir"]
    if args.seeds and args.arms:
        result["rows"] = run_arms(args, jax_ws)
    return result


if __name__ == "__main__":
    main()
