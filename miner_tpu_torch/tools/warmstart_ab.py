"""Warm-start A/B on the port: a pretrained PLM tower against a random one
at equal steps.

The port's counterpart of the JAX package's ``tools/warmstart_ab.py``. The
reference warm-starts its news tower from a pretrained transformers
checkpoint; none can be fetched here, so the artifact is made in place:

  1. a news tower is trained (``--artifact``):
       contrastive  the ``pretrain`` subcommand (the contrastive objective;
                    its identity augmentation file ``enhanced_text_news.tsv``
                    is the corpus's ``news.tsv``). The JAX package found it
                    collapses a random tower: kept as its negative finding;
       domain       a Miner trained on a DISJOINT corpus (the same generator
                    at ``--domain_seed``): the in-place stand-in for a tower
                    pretrained on a large corpus;
  2. its tower is exported to a transformers-format directory
     (``pytorch_model.bin``, ``bert.``-prefixed keys:
     ``export_hf_checkpoint``), the artifact ``--pretrained_embedding``
     takes;
  3. the Miner trains on the A/B corpus once warm (``--pretrained_embedding``)
     and once cold, at equal steps, for each of ``--seeds``;
  4. the last eval row of each run is printed, and with ``--report``
     appended to that markdown file (none by default).

    python -m miner_tpu_torch.tools.warmstart_ab --out warmstart --artifact domain \\
        [--seeds 13 14 15] [--dtype fp32] [--device cpu]

On a card the runs train in bf16 with the hand-written kernels, or with
``--dtype fp32`` in float32 on their fp32 routes; on the CPU (``--device
cpu``) in float32 on the plain versions, the JAX tool's flags.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import shutil
import time
from typing import List, Optional, Sequence

from miner_tpu_torch.tools.quality_run import leg_extra

# the tiny preset's shared geometry (quality_run's tiny protocol)
LT, H, NPRATIO = 16, 10, 4
D_WORD, K, P_DIM, D_CAT = 64, 8, 32, 16
BATCH, VOCAB = 32, 2000
METRICS = ["auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"]
MINER_EXTRA = (
    "--model_name", "Miner", "--use_category_bias",
    "--category_embed_dim", str(D_CAT),
    "--num_context_codes", str(K), "--context_code_dim", str(P_DIM),
    "--score_type", "weighted",
    "--metrics", *METRICS,
)


def common_argv(data_dir: str, out_dir: str, mode: str, epochs: int, lr: float, seed: int,
                device: str, dtype: str, extra: Sequence[str] = ()) -> List[str]:
    """The JAX tool's ``_common_argv`` with its CPU flags (``--compute_dtype
    float32 --no-fused_kernels``) replaced by the device's
    (``quality_run.leg_extra``)."""
    return [
        mode,
        "--pretrained_tokenizer", f"hash:{VOCAB}",
        "--user2id_path", os.path.join(data_dir, "user2id.json"),
        "--category2id_path", os.path.join(data_dir, "category2id.json"),
        "--train_behaviors_path", os.path.join(data_dir, "behaviors.tsv"),
        "--train_news_path", os.path.join(data_dir, "news.tsv"),
        "--eval_behaviors_path", os.path.join(data_dir, "eval_behaviors.tsv"),
        "--eval_news_path", os.path.join(data_dir, "news.tsv"),
        "--max_title_length", str(LT), "--max_sapo_length", "24",
        "--his_length", str(H), "--seed", str(seed),
        "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
        "--word_embed_dim", str(D_WORD),
        "--npratio", str(NPRATIO),
        "--train_batch_size", str(BATCH), "--eval_batch_size", "64",
        "--num_train_epochs", str(epochs), "--learning_rate", str(lr),
        "--warmup_ratio", "0.1", "--weight_decay", "0.01",
        "--max_grad_norm", "1.0", "--logging_steps", "50",
        *leg_extra(device, dtype),
        "--train_path", os.path.join(out_dir, "train"),
        *extra,
    ]


def run_cli(argv: Sequence[str]) -> float:
    """Train one run through the port's ``Trainer``; its seconds."""
    from miner_tpu_torch.config import make_parser
    from miner_tpu_torch.training.trainer import Trainer

    args = make_parser().parse_args(list(argv))
    t0 = time.time()
    Trainer(args).train()
    return time.time() - t0


def latest_run_dir(out_dir: str) -> str:
    return sorted(glob.glob(os.path.join(out_dir, "train", "*")))[-1]


def export_hf_checkpoint(ckpt: str, hf_dir: str) -> str:
    """A port checkpoint's PLM tower -> a transformers-format directory
    (``pytorch_model.bin``, ``bert.``-prefixed keys) that
    ``--pretrained_embedding`` takes. A pretrain run's checkpoint roots at
    the news encoder (``plm.*``), a whole model's nests it under
    ``news_encoder.plm.*``."""
    import torch

    from miner_tpu_torch.models.hf_import import export_plm_state_dict
    from miner_tpu_torch.training import checkpoint

    params = checkpoint.load(ckpt)["params"]
    root = "plm." if any(k.startswith("plm.") for k in params) else "news_encoder.plm."
    plm = {k[len(root):]: v for k, v in params.items() if k.startswith(root)}
    if not plm:
        raise ValueError(f"{ckpt}: no PLM tower under plm.* or news_encoder.plm.*")
    sd = export_plm_state_dict(plm, prefix="bert.")
    os.makedirs(hf_dir, exist_ok=True)
    torch.save({k: v.detach().cpu().contiguous().clone() for k, v in sd.items()},
               os.path.join(hf_dir, "pytorch_model.bin"))
    return hf_dir


def final_eval_row(out_dir: str) -> dict:
    with open(os.path.join(latest_run_dir(out_dir), "eval.csv")) as f:
        last = list(csv.DictReader(f))[-1]
    return {k: float(last[k]) for k in METRICS if k in last}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="warmstart")
    ap.add_argument("--report", default=None,
                    help="append the markdown table to this file (default: none)")
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--news", type=int, default=1200)
    ap.add_argument("--eval_lines", type=int, default=800)
    ap.add_argument("--pretrain_epochs", type=int, default=2)
    ap.add_argument("--pretrain_lr", type=float, default=5e-4)
    ap.add_argument("--finetune_epochs", type=int, default=1)
    ap.add_argument("--finetune_lr", type=float, default=5e-4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[13, 14, 15])
    ap.add_argument("--artifact", choices=["contrastive", "domain"], default="contrastive")
    ap.add_argument("--domain_seed", type=int, default=77,
                    help="generator seed for the disjoint pretraining corpus "
                         "(--artifact domain)")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default=None,
                    help="default: bf16 on a card, fp32 on the CPU (the only type there)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _done_run(out_dir: str) -> bool:
    """Whether a finished run (its ``finalModel`` written) is under
    ``out_dir``; half-written run directories of a killed attempt go."""
    done = [d for d in glob.glob(os.path.join(out_dir, "train", "*"))
            if os.path.isfile(os.path.join(d, "ckpt", "finalModel"))]
    for stale in set(glob.glob(os.path.join(out_dir, "train", "*"))) - set(done):
        shutil.rmtree(stale)
    return bool(done)


def main(argv: Optional[List[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    device = args.device or "cuda"
    if device == "cpu" and args.dtype == "bf16":
        raise SystemExit("--dtype bf16 needs a card: the CPU runs are float32")
    dtype = args.dtype or ("fp32" if device == "cpu" else "bf16")

    from miner_tpu_torch.tools.synth_mind import make_synth_mind

    def corpus(root, seed=None):
        if not os.path.exists(os.path.join(root, "behaviors.tsv")):
            make_synth_mind(root, n_news=args.news, n_train_lines=args.events,
                            n_users=max(300, args.events // 10),
                            n_eval_lines=args.eval_lines, hist_len=(H, H + 4),
                            **({} if seed is None else {"seed": seed}))

    data_dir = os.path.join(args.out, "data")
    corpus(data_dir)
    # the pretrain dataset reads a sibling {aug}_news.tsv; the identity one
    # (its term weighs 0.001 in the objective)
    aug = os.path.join(data_dir, "enhanced_text_news.tsv")
    if not os.path.exists(aug):
        shutil.copy(os.path.join(data_dir, "news.tsv"), aug)

    def argv_(data, out, mode, epochs, lr, seed, extra=()):
        return common_argv(data, out, mode, epochs, lr, seed, device, dtype, extra)

    if args.artifact == "contrastive":
        pre_out = os.path.join(args.out, "pre")
        if not _done_run(pre_out):
            secs = run_cli(argv_(data_dir, pre_out, "pretrain", args.pretrain_epochs,
                                 args.pretrain_lr, 1,
                                 ("--augmentations", "enhanced_text", "--online", "1",
                                  "--evaluation_info", "loss")))
            print(f"pretrain done in {secs:.0f}s", flush=True)
        hf_dir = os.path.join(args.out, "hf_ckpt")
    else:
        # a Miner trained on a disjoint corpus donates its tower
        dom_data = os.path.join(args.out, "domain_data")
        corpus(dom_data, args.domain_seed)
        pre_out = os.path.join(args.out, "domain_pre")
        if not _done_run(pre_out):
            secs = run_cli(argv_(dom_data, pre_out, "train", args.pretrain_epochs,
                                 args.finetune_lr, 1, MINER_EXTRA))
            print(f"domain pretrain done in {secs:.0f}s", flush=True)
        hf_dir = os.path.join(args.out, "hf_domain")
    export_hf_checkpoint(os.path.join(latest_run_dir(pre_out), "ckpt", "finalModel"), hf_dir)
    print(f"exported transformers-format checkpoint -> {hf_dir}", flush=True)

    rows = []
    for seed in args.seeds:
        for label, extra in ((f"warm-{args.artifact}",
                              MINER_EXTRA + ("--pretrained_embedding", hf_dir)),
                             ("cold", MINER_EXTRA)):
            run_out = os.path.join(args.out, f"{label}_{seed}")
            secs = run_cli(argv_(data_dir, run_out, "train", args.finetune_epochs,
                                 args.finetune_lr, seed, extra))
            rows.append((f"{label} seed={seed}", final_eval_row(run_out), secs))
            print(rows[-1], flush=True)

    lines = [f"miner_tpu_torch ({'CPU fp32' if device == 'cpu' else 'card ' + dtype}), "
             f"--artifact {args.artifact}: {args.events} train lines, {args.eval_lines} eval "
             f"impressions; pretrain {args.pretrain_epochs} ep; finetune "
             f"{args.finetune_epochs} ep @ lr {args.finetune_lr}, batch {BATCH}\n",
             "| run | " + " | ".join(METRICS) + " | train s |",
             "|---|" + "---|" * (len(METRICS) + 1)]
    for label, scores, secs in rows:
        lines.append("| " + label + " | " + " | ".join(
            f"{scores.get(m, float('nan')):.4f}" for m in METRICS) + f" | {secs:.0f} |")
    print("\n".join(lines), flush=True)
    if args.report:
        with open(args.report, "a") as f:
            f.write("\n".join(lines) + "\n")
        print(f"report -> {args.report}")
    return {"hf_dir": hf_dir, "rows": rows}


if __name__ == "__main__":
    main()
