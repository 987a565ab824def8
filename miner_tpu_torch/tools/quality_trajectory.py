"""Per-step trajectories of the quality protocol: the port against itself
under another dropout stream, and against the JAX package, run for run.

The port's counterpart of the JAX package's ``tools/quality_trajectory.py``.
The mid protocol's learn-or-stuck outcome is a coin flip in every
framework, so counting outcomes cannot tell two frameworks apart; a
shared-init pair can. Two legs of the port train the Miner from ONE init
on ONE data order (both seeded by ``--init_seed``) and differ only in
their dropout stream (offset 0 for ``port-A``, 777 for ``port-B``, the JAX
tool's ``JAX_DROPOUT_KEY``), each logging every step's loss and global
gradient norm before the clip (``steps_<leg>.jsonl``) and ending with an
eval (``result_<leg>.json``). ``analyze`` then sets the cross-framework
divergence (``port-A`` against the JAX tool's ``jax-A``, from the same
init) against the within-framework, dropout-only one (``port-A`` against
``port-B``, ``jax-A`` against ``jax-B``): if the cross curve sits inside
the within band, the frameworks are as alike as two dropout streams.

    python -m miner_tpu_torch.tools.quality_trajectory --out traj --init_seed 301 \\
        [--legs port-A,port-B] [--dtype fp32] [--device cpu] [--analyze]

The legs play the role of the JAX tool's reference-torch legs, which need
the reference repository and are not ported. The JAX legs come from the
same init through the reference layout: ``--export_init FILE`` writes the
legs' init as a reference state dict (``export_to_reference``), the JAX
package's ``tools/import_reference_checkpoint.py --num_layers 2`` makes it
an Orbax checkpoint, and ``run_jax_trajectory_legs.py`` (at the
repository's root, where JAX is installed) runs ``run_jax_leg`` from it on
the corpus under ``--out``; ``analyze`` reads its ``steps_jax-*.jsonl``.
The init comes from ``--init_ckpt`` (a port checkpoint) or else from
``--init_seed``. The protocol is the JAX tool's: ``quality_run``'s mid
preset, 2 epochs, the corpus of 12,500 lines and 5,000 eval impressions.
On a card the legs run in float32 on the kernels' fp32 routes (``--dtype
bf16`` for bf16); on the CPU (``--device cpu``) in float32 on the plain
versions.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from miner_tpu_torch.tools import quality_run as qr

# the dropout stream of each leg (the JAX tool's JAX_DROPOUT_KEY); the data
# order is the pair seed for both
DROPOUT_OFFSET = {"A": 0, "B": 777}
PORT_LEGS = ("port-A", "port-B")
EPOCHS = 2  # the JAX tool's protocol (its main sets quality_run.EPOCHS = 2)
ALL_LEGS = ("port-A", "jax-A", "port-B", "jax-B")
PAIRS = (("port-A", "jax-A", "cross-framework"),
         ("port-A", "port-B", "within-port (dropout only)"),
         ("jax-A", "jax-B", "within-jax (dropout only)"),
         ("port-B", "jax-B", "cross-framework (B streams)"))


def log_path(out: str, leg: str) -> str:
    return os.path.join(out, f"steps_{leg}.jsonl")


def result_path(out: str, leg: str) -> str:
    return os.path.join(out, f"result_{leg}.json")


def geometry(init_seed: int, preset: str = "mid") -> dict:
    """The protocol's geometry and recipe: ``quality_run``'s ``preset``
    (the mid one) for ``EPOCHS`` epochs, its seed the pair's."""
    return dict(qr.PRESETS[preset], EPOCHS=EPOCHS, SEED=init_seed)


def load_data(data_dir: str, g: dict, device: torch.device):
    """The corpus as the JAX leg loads it: the store (hash tokenizer, sapo
    of 24), the train and eval logs, and the token table on ``device``."""
    from miner_tpu_torch.data import HashTokenizer, NewsStore, NewsTable
    from miner_tpu_torch.data.behaviors import BehaviorsLog

    tok = HashTokenizer(vocab_size=g["VOCAB"])
    with open(os.path.join(data_dir, "category2id.json")) as f:
        cat2id = json.load(f)
    with open(os.path.join(data_dir, "user2id.json")) as f:
        user2id = json.load(f)
    store = NewsStore.from_tsv(os.path.join(data_dir, "news.tsv"), tok, cat2id, g["LT"], 24)
    log = BehaviorsLog.from_tsv(os.path.join(data_dir, "behaviors.tsv"), store, user2id, g["H"])
    eval_log = BehaviorsLog.from_tsv(os.path.join(data_dir, "eval_behaviors.tsv"), store,
                                     user2id, g["H"])
    return store, log, eval_log, NewsTable.from_store(store, use_sapo=True, device=device)


def build_model(store, g: dict, dtype: torch.dtype = torch.float32):
    """The JAX leg's Miner (tools/quality_trajectory.py:199-214): the tiny
    tower, reduce_dim to the preset's width, sapo with the linear combine,
    dropout 0.2, category bias over ``store.flat_category().max() + 1``
    rows, weighted scoring; computing in ``dtype``."""
    from miner_tpu_torch.config import plm_config
    from miner_tpu_torch.models import Miner, NewsEncoder

    plm = plm_config("tiny", vocab_size=g["VOCAB"], gelu_approx=dtype == torch.bfloat16)
    encoder = NewsEncoder(plm, apply_reduce_dim=True, word_embed_dim=g["D_WORD"],
                          use_sapo=True, combine_type="linear", dropout=0.2, dtype=dtype)
    return Miner(encoder, use_category_bias=True, num_context_codes=g["K"],
                 context_code_dim=g["P_DIM"], score_type="weighted",
                 num_categories=int(store.flat_category().max()) + 1,
                 category_embed_dim=g["D_CAT"], category_pad_id=store.category_pad_id,
                 dropout=0.2, dtype=dtype)


def initial_model(store, g: dict, init_seed: int, init_ckpt: Optional[str] = None,
                  dtype: torch.dtype = torch.float32):
    """The legs' shared init: ``init_ckpt``'s parameters (loaded strictly)
    or fresh weights from ``init_seed``."""
    from miner_tpu_torch.training import checkpoint

    model = build_model(store, g, dtype)
    model.reset_parameters(torch.Generator().manual_seed(init_seed))
    if init_ckpt:
        model.load_state_dict(checkpoint.load(init_ckpt)["params"], strict=True)
    return model


def run_leg(data_dir: str, out: str, leg: str, init_seed: int, init_ckpt: Optional[str] = None,
            device: Optional[str] = None, dtype: str = "fp32", preset: str = "mid",
            max_steps: Optional[int] = None,
            deterministic: bool = False, eval_: bool = True) -> dict:
    """One leg (the JAX tool's ``run_jax_leg`` on the port): the shared
    init, the pair seed's data order (``OfflineSampler``, the shuffled
    ``Batcher``), each step ``NewsTable.lookup``, the Miner with the leg's
    dropout stream (none when ``deterministic``), ``losses.miner_loss`` and
    the port's optimizer (clip, AdamW, linear warmup) at the preset's
    recipe; each step's ``{"step", "loss", "gnorm"}`` (the norm before the
    clip) to ``steps_<leg>.jsonl``; then the eval over ``EvalSampler``
    batches of 64 into ``result_<leg>.json``. ``max_steps`` stops the
    training there (the schedule stays the whole run's). Returns the result
    with the step log."""
    from miner_tpu_torch.data.batcher import Batcher
    from miner_tpu_torch.data.samplers import EvalSampler, OfflineSampler
    from miner_tpu_torch.evaluation.evaluator import ImpressionEvaluator
    from miner_tpu_torch.models.dropout import DropoutRNG
    from miner_tpu_torch.training import losses
    from miner_tpu_torch.training.optim import Optimizer
    from miner_tpu_torch.utils import resolve_device

    g = geometry(init_seed, preset)
    dev = resolve_device(device)
    compute = torch.bfloat16 if dtype == "bf16" else torch.float32
    store, log, eval_log, table = load_data(data_dir, g, dev)
    sampler = OfflineSampler(log, store, g["NPRATIO"], seed=init_seed)
    batcher = Batcher(g["BATCH"], drop_last=True, shuffle=True, seed=init_seed)
    model = initial_model(store, g, init_seed, init_ckpt, compute).to(dev)
    total = batcher.num_batches(log.num_events) * g["EPOCHS"]
    opt = Optimizer(model.named_parameters(), learning_rate=g["LR"], total_steps=total,
                    warmup_steps=int(total * g["WARMUP_RATIO"]), weight_decay=g["WD"],
                    max_grad_norm=g["CLIP"])
    stream = init_seed + DROPOUT_OFFSET[leg[-1]]

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    os.makedirs(out, exist_ok=True)
    steps = []
    t0 = time.time()
    model.train()
    with open(log_path(out, leg), "w") as f:
        for epoch in range(g["EPOCHS"]):
            block = sampler.sample_epoch(epoch)
            for batch in batcher.batches(block, epoch):
                if len(steps) == max_steps:
                    break
                rng = None if deterministic else DropoutRNG(stream, len(steps), dev)
                mb = table.lookup(idx(batch["cand_idx"]), idx(batch["his_idx"]))
                interests, logits = model(mb, rng)
                loss = losses.miner_loss(interests, logits,
                                         torch.as_tensor(batch["label"], device=dev))
                loss.backward()
                opt.step()
                row = {"step": len(steps), "loss": float(loss.detach()),
                       "gnorm": float(opt.grad_norm)}
                steps.append(row)
                f.write(json.dumps(row) + "\n")
                if len(steps) % 100 == 0:
                    print(f"[{leg}] step {len(steps)}/{total} loss {row['loss']:.4f}",
                          flush=True)
    train_s = time.time() - t0
    result = {"leg": leg, "steps": len(steps), "train_s": round(train_s, 1)}
    if eval_:
        model.eval()
        evaluator = ImpressionEvaluator(eval_log.eval_targets_by_impression())
        eb = Batcher(64, drop_last=False, shuffle=False)
        with torch.no_grad():
            for batch in eb.batches(EvalSampler(eval_log).sample_all()):
                valid = int(batch.pop("valid"))
                _, logits = model(table.lookup(idx(batch["cand_idx"]), idx(batch["his_idx"])))
                evaluator.eval_batch(logits.float().cpu().numpy(), batch["impression_id"],
                                     valid=valid)
        result["scores"] = evaluator.compute_scores(["auc", "group_auc", "mrr"])
    with open(result_path(out, leg), "w") as f:
        json.dump(result, f)
    print(f"[{leg}] final {result.get('scores')} ({result['steps']} steps, {train_s:.1f} s)",
          flush=True)
    return dict(result, log=steps)


def export_init(data_dir: str, path: str, init_seed: int, init_ckpt: Optional[str] = None,
                preset: str = "mid") -> int:
    """The legs' shared init as a reference-format state dict (the
    ``export_to_reference`` of the Miner) at ``path``; the number of
    tensors. The JAX package's ``tools/import_reference_checkpoint.py``
    reads it back."""
    from miner_tpu_torch.tools.export_to_reference import export

    g = geometry(init_seed, preset=preset)
    store, *_ = load_data(data_dir, g, torch.device("cpu"))
    sd = export(initial_model(store, g, init_seed, init_ckpt).state_dict(), "miner")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)
    return len(sd)


def analyze(out: str, legs=ALL_LEGS) -> dict:
    """The divergence of each pair's loss curves (the JAX tool's
    ``analyze``): for each pair whose two logs are under ``out``, the first
    step where |dloss| passes 1e-3, 1e-2 and 1e-1, its mean over the first
    50 steps and over the last 100; and each leg's final scores. Written to
    ``analysis.json``."""
    traces, results = {}, {}
    for leg in legs:
        path = log_path(out, leg)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            traces[leg] = np.array([json.loads(line)["loss"] for line in f])
        rp = result_path(out, leg)
        if os.path.exists(rp):
            with open(rp) as f:
                results[leg] = json.load(f)

    def first_crossing(a, b, thresholds=(1e-3, 1e-2, 1e-1)):
        n = min(len(a), len(b))
        d = np.abs(a[:n] - b[:n])
        crossed = {}
        for t in thresholds:
            where = np.nonzero(d > t)[0]
            crossed[t] = int(where[0]) if len(where) else None
        return crossed, d

    report = {"results": {k: v.get("scores") for k, v in results.items()}, "divergence": {}}
    for a, b, label in PAIRS:
        if a not in traces or b not in traces:
            continue
        cross, d = first_crossing(traces[a], traces[b])
        report["divergence"][f"{a} vs {b}"] = {
            "label": label,
            "first_step_absdloss_gt": {str(k): v for k, v in cross.items()},
            "mean_absdloss_first50": round(float(d[:50].mean()), 6),
            "mean_absdloss_last100": round(float(d[-100:].mean()), 4),
            "n_steps": len(d),
        }
    print(json.dumps(report, indent=2))
    with open(os.path.join(out, "analysis.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="traj")
    ap.add_argument("--init_seed", type=int, default=301,
                    help="the pair's seed: the init (without --init_ckpt) and the data order")
    ap.add_argument("--init_ckpt", default=None, help="a port checkpoint both legs start from")
    ap.add_argument("--legs", default="port-A,port-B")
    ap.add_argument("--analyze", action="store_true",
                    help="only run the divergence analysis on the logs under --out")
    ap.add_argument("--export_init", default=None, metavar="FILE",
                    help="write the legs' init as a reference-format state dict and stop")
    ap.add_argument("--events", type=int, default=12500, help="train lines of the corpus")
    ap.add_argument("--news", type=int, default=1200)
    ap.add_argument("--eval_lines", type=int, default=5000)
    ap.add_argument("--max_steps", type=int, default=None,
                    help="stop each leg after this many steps (the schedule of the whole run)")
    ap.add_argument("--preset", choices=list(qr.PRESETS), default="mid",
                    help="quality_run's geometry (tiny for wiring checks)")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="fp32")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    args = make_parser().parse_args(argv)
    if args.analyze:
        return analyze(args.out)
    if args.device == "cpu" and args.dtype == "bf16":
        raise SystemExit("--dtype bf16 needs a card: the CPU legs are float32")
    legs = [x.strip() for x in args.legs.split(",") if x.strip()]
    bad = [leg for leg in legs if leg not in PORT_LEGS]
    if bad:
        raise SystemExit(f"--legs {bad}: this tool runs {PORT_LEGS}; the JAX legs run in the "
                         "JAX package (run_jax_trajectory_legs.py)")
    data_dir = os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(data_dir, "category2id.json")):  # its last file
        from miner_tpu_torch.tools.synth_mind import make_synth_mind

        # the JAX tool's corpus recipe (histories of 20-24)
        make_synth_mind(data_dir, n_news=args.news, n_train_lines=args.events,
                        n_users=args.events // 10, n_eval_lines=args.eval_lines,
                        hist_len=(20, 24))
        print(f"corpus at {data_dir}", flush=True)
    if args.export_init:
        n = export_init(data_dir, args.export_init, args.init_seed, args.init_ckpt,
                        args.preset)
        print(f"wrote the shared init ({n} tensors, reference layout) to {args.export_init}")
        return {"exported": n}
    runs = {}
    for leg in legs:
        runs[leg] = run_leg(data_dir, args.out, leg, args.init_seed, args.init_ckpt,
                            args.device, args.dtype, args.preset, args.max_steps)
    runs["analysis"] = analyze(args.out)
    return runs


if __name__ == "__main__":
    main()
