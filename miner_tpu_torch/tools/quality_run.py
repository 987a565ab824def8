"""The quality protocol's port leg: the Miner trained on the planted corpus.

The port's counterpart of ``run_ours`` and the presets of the JAX package's
``tools/quality_run.py``: the same corpus (``synth_mind``), geometry and
recipe, trained through the port's ``Trainer`` once a seed, each run scored
by the held-out ranking metrics of its last eval. A run counts as learned
when its final auc is at least 0.55 (``LEARNED_AUC``, the rule of the JAX
package's paired-seed protocol: the distribution is bimodal). It prints one
row a seed and the learned count, and with ``--fisher_against`` the
two-sided Fisher exact test of that count against another's.

    python -m miner_tpu_torch.tools.quality_run --preset mid --epochs 2 \\
        --events 12500 --eval_lines 5000 --seeds 301 302 303 304 305 306 307 308 \\
        --fisher_against "reference torch=5/8" "miner_tpu=4/8"

(the JAX package's round-4 protocol, each seed the init and the data and
dropout streams of its run). The reference-torch leg of the JAX tool needs
the reference repository and is not ported; ``--init_ckpt`` starts every
seed from one port checkpoint instead (for example a JAX run's, through
``convert_jax_checkpoint.py``), the shared-init protocol.
"""
from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import time
from typing import List, Optional, Sequence

METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]
LEARNED_AUC = 0.55

# the shared geometry and recipe; ``mid`` is the JAX package's mid-scale
# protocol (H = 20, B = 64, lr 1e-3, wed 128 / K 32 / P 200 / cat 100)
PRESETS = {
    "tiny": dict(LT=16, H=10, NPRATIO=4, D_WORD=64, K=8, P_DIM=32, D_CAT=16, LR=5e-4,
                 EPOCHS=4, BATCH=32, WD=0.01, CLIP=1.0, WARMUP_RATIO=0.1, VOCAB=2000,
                 SEED=13, PLM_PRESET="tiny"),
}
PRESETS["mid"] = dict(PRESETS["tiny"], LT=32, H=20, D_WORD=128, K=32, P_DIM=200,
                      D_CAT=100, LR=1e-3, EPOCHS=1, BATCH=64, VOCAB=30522, SEED=101)


def train_argv(g: dict, data_dir: str, out_dir: str, extra: Sequence[str] = ()) -> List[str]:
    """The train argv of geometry ``g`` (a ``PRESETS`` entry), as the JAX
    tool's ``_argv``."""
    return [
        "train",
        "--model_name", "Miner",
        "--pretrained_tokenizer", f"hash:{g['VOCAB']}",
        "--user2id_path", os.path.join(data_dir, "user2id.json"),
        "--category2id_path", os.path.join(data_dir, "category2id.json"),
        "--train_behaviors_path", os.path.join(data_dir, "behaviors.tsv"),
        "--train_news_path", os.path.join(data_dir, "news.tsv"),
        "--eval_behaviors_path", os.path.join(data_dir, "eval_behaviors.tsv"),
        "--eval_news_path", os.path.join(data_dir, "news.tsv"),
        "--max_title_length", str(g["LT"]),
        "--max_sapo_length", "24",
        "--his_length", str(g["H"]),
        "--seed", str(g["SEED"]),
        "--plm_preset", g["PLM_PRESET"],
        "--apply_reduce_dim",
        "--use_sapo",
        "--use_category_bias",
        "--word_embed_dim", str(g["D_WORD"]),
        "--category_embed_dim", str(g["D_CAT"]),
        "--num_context_codes", str(g["K"]),
        "--context_code_dim", str(g["P_DIM"]),
        "--score_type", "weighted",
        "--npratio", str(g["NPRATIO"]),
        "--train_batch_size", str(g["BATCH"]),
        "--eval_batch_size", "64",
        "--num_train_epochs", str(g["EPOCHS"]),
        "--learning_rate", str(g["LR"]),
        "--warmup_ratio", str(g["WARMUP_RATIO"]),
        "--weight_decay", str(g["WD"]),
        "--max_grad_norm", str(g["CLIP"]),
        "--logging_steps", "50",
        "--metrics", *METRICS,
        "--train_path", os.path.join(out_dir, "train"),
        *extra,
    ]


def leg_extra(device: str, dtype: str, init_ckpt: Optional[str] = None,
              seed: Optional[int] = None) -> List[str]:
    """The flags of one run: the JAX tool's ``run_ours`` extras on the
    port. On the CPU float32 and the plain versions (JAX's CPU leg); on a
    card bf16 with the hand-written kernels, or float32 at full float32
    matmul precision (JAX's fp32 TPU leg; the port keeps its kernels on,
    in their fp32 routes)."""
    if device == "cpu":
        extra = ["--compute_dtype", "float32", "--no-fused_kernels", "--device", "cpu"]
    elif dtype == "fp32":
        extra = ["--compute_dtype", "float32", "--matmul_precision", "float32"]
    else:
        extra = []
    if device not in ("cpu", "cuda"):
        extra += ["--device", device]
    if init_ckpt:
        extra += ["--pretrained_model_path", init_ckpt]
    if seed is not None:
        # the data order and dropout streams, and (without --init_ckpt) the init
        extra += ["--seed", str(seed)]
    return extra


def run_leg(g: dict, data_dir: str, out_dir: str, extra: Sequence[str]):
    """Train one run; its last eval row's metrics and the train seconds."""
    from miner_tpu_torch.config import make_parser
    from miner_tpu_torch.training.trainer import Trainer

    args = make_parser().parse_args(train_argv(g, data_dir, out_dir, extra))
    t0 = time.time()
    run = Trainer(args).train()
    train_s = time.time() - t0
    del run
    rd = sorted(glob.glob(os.path.join(out_dir, "train", "*")))[-1]
    with open(os.path.join(rd, "eval.csv")) as f:
        last = list(csv.DictReader(f))[-1]
    return {k: float(last[k]) for k in METRICS if k in last}, train_s


def fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """Two-sided Fisher exact p of the 2x2 table [[a, b], [c, d]]: the
    tables of the same margins no more likely than the one observed."""
    r1, c1, n = a + b, a + c, a + b + c + d

    def p(x: int) -> float:
        return math.comb(c1, x) * math.comb(n - c1, r1 - x) / math.comb(n, r1)

    seen = p(a)
    lo, hi = max(0, r1 + c1 - n), min(r1, c1)
    return min(1.0, sum(p(x) for x in range(lo, hi + 1) if p(x) <= seen * (1 + 1e-7)))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="quality_run",
                    help="work directory: the corpus under data/, a run a seed beside it")
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="one run a seed (its --seed: init, data order, dropout); "
                         "default: one run at the preset's seed")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default=None,
                    help="default: bf16 on a card, fp32 on the CPU (the only type there)")
    ap.add_argument("--init_ckpt", default=None,
                    help="a port checkpoint every seed starts from (--pretrained_model_path)")
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--news", type=int, default=1200)
    ap.add_argument("--eval_lines", type=int, default=800)
    ap.add_argument("--plm_preset", default=None, help="override the tower preset")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--fisher_against", nargs="*", default=(), metavar="NAME=L/N",
                    help="learned counts to test the port's against (Fisher exact, "
                         "two-sided), e.g. 'miner_tpu=4/8'")
    ap.add_argument("--report", default=None, help="append the rows to this markdown file")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    g = dict(PRESETS[args.preset])
    if args.plm_preset:
        g["PLM_PRESET"] = args.plm_preset
    if args.epochs is not None:
        g["EPOCHS"] = args.epochs
    device = args.device or "cuda"
    cpu = device == "cpu"
    if cpu and args.dtype == "bf16":
        raise SystemExit("--dtype bf16 needs a card: the CPU leg is float32")
    dtype = args.dtype or ("fp32" if cpu else "bf16")

    from miner_tpu_torch.tools.synth_mind import make_synth_mind

    data_dir = os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(data_dir, "category2id.json")):  # its last file
        # histories >= H, so no pad entries (as the JAX tool)
        make_synth_mind(data_dir, n_news=args.news, n_train_lines=args.events,
                        n_users=max(300, args.events // 10),
                        n_eval_lines=args.eval_lines, hist_len=(g["H"], g["H"] + 4))
        print(f"synth corpus at {data_dir}", flush=True)

    label = f"miner_tpu_torch ({'CPU fp32' if cpu else 'card ' + dtype}) [{args.preset}/" \
            f"{g['PLM_PRESET']}, {g['EPOCHS']} epochs]" + (" shared-init" if args.init_ckpt else "")
    rows = []
    for seed in (args.seeds or [None]):
        out_dir = os.path.join(args.out, f"ours_seed{seed}" if seed is not None else "ours")
        scores, secs = run_leg(g, data_dir, out_dir,
                               leg_extra(device, dtype, args.init_ckpt, seed))
        learned = scores.get("auc", 0.0) >= LEARNED_AUC
        rows.append((seed, scores, secs, learned))
        print(f"| {label} | seed {seed if seed is not None else g['SEED']} | "
              + " | ".join(f"{scores.get(m, float('nan')):.4f}" for m in METRICS)
              + f" | {secs:.0f} s | {'learned' if learned else 'stuck'} |", flush=True)
    n_learned = sum(r[3] for r in rows)
    lines = [f"{label}: learned {n_learned} of {len(rows)} (final auc >= {LEARNED_AUC})"]
    fisher = {}
    for spec in args.fisher_against:
        name, frac = spec.rsplit("=", 1)
        k, n = (int(x) for x in frac.split("/"))
        fisher[name] = fisher_exact(n_learned, len(rows) - n_learned, k, n - k)
        lines.append(f"Fisher exact (two-sided) against {name} ({k}/{n} learned): "
                     f"p = {fisher[name]:.4f}")
    print("\n".join(lines), flush=True)
    if args.report:
        with open(args.report, "a") as f:
            f.write("| run | seed | " + " | ".join(METRICS) + " | train s | outcome |\n"
                    + "|---|---|" + "---|" * (len(METRICS) + 2) + "\n")
            for seed, scores, secs, learned in rows:
                f.write(f"| {label} | {seed} | "
                        + " | ".join(f"{scores.get(m, float('nan')):.4f}" for m in METRICS)
                        + f" | {secs:.0f} | {'learned' if learned else 'stuck'} |\n")
            f.write("\n".join(lines) + "\n")
    return {"rows": rows, "learned": n_learned, "fisher": fisher}


if __name__ == "__main__":
    main()
