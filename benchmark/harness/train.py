"""The runner of ``train`` traffic: the port's training step, fed as
``Trainer.train`` feeds it.

Set-up: the corpus from the seed, the port's ``Trainer`` with the
configuration's flags, its store, behaviors log, sampler, device table and
shuffled ``Batcher``; the weights made on the card from the seed
(``harness/weights.py``); the port's optimizer. Then the check's micro-batches:
the first ``check_updates`` optimizer steps go through ``train_step`` on the
rows the sampler feeds (every shape the window uses, so every kernel is
built and compiled here), their losses, each leaf's first gradient as AdamW
holds it (its first moment / (1 - beta1) after one step) and the parameters
after the steps are kept.

The window: ``train_step`` micro-batch after micro-batch for ``--seconds``,
fed by the sampler and the batcher, every optimizer update that falls in it
included; the rate is impressions over the window's whole time. With
``--trace 1`` the window is ``trace_micro_batches`` micro-batches under
``torch.profiler``, with the benchmark's spans around the data plane and the
micro-step, and marks around the optimizer's step (``trace.mark``).

The check, once the program's state is freed: the reference
(``reference/miner.py``) follows the same steps from the same weights on the
same rows, after checking each row against the behaviors it was drawn from.
"""
from __future__ import annotations

import gc
import math
import os
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from harness import corpus, port, trace, weights
from harness.main import Outcome, Run


def feed(sampler, batcher, spans):
    """Micro-batches epoch after epoch, as ``Trainer.train`` draws them."""
    epoch = 0
    while True:
        with spans.span("host_data"):
            block = sampler.sample_epoch(epoch)
        batches = batcher.batches(block, epoch)
        while True:
            with spans.span("host_data"):
                batch = next(batches, None)
            if batch is None:
                break
            yield batch
        epoch += 1


def schedule(num_events: int, cfg: Dict):
    """(total updates, warmup updates) of the configuration's schedule over
    a log of ``num_events`` training samples (``Trainer.train``'s)."""
    steps = num_events // cfg["train_batch_size"]
    per_epoch = max(1, steps // max(1, cfg["gradient_accumulation_steps"]))
    total = per_epoch * cfg["num_train_epochs"]
    return total, math.ceil(total * cfg["warmup_ratio"])


def data_plane(cfg: Dict, traffic: Dict, run_seed: int, tmp: str, device: str):
    """The corpus of the seed and the port's data plane over it, as
    ``Trainer.train`` builds it: the trainer, its store, behaviors log,
    sampler and shuffled ``Batcher``, the schedule, the weights' layout."""
    from miner_tpu_torch.data.batcher import Batcher
    from miner_tpu_torch.training.trainer import Trainer
    from reference import miner as ref_miner

    seed = port.port_seed(run_seed)
    paths = corpus.write_corpus(os.path.join(tmp, "corpus"), traffic["corpus"], run_seed)
    args = port.parse(cfg, "train", [
        "--train_news_path", paths["news"], "--train_behaviors_path", paths["behaviors"],
        "--user2id_path", paths["user2id"], "--category2id_path", paths["category2id"],
        "--train_path", os.path.join(tmp, "out"), "--seed", str(seed), "--device", device])
    trainer = Trainer(args)
    store = trainer._load_store(args.train_news_path)
    log = trainer._load_log(args.train_behaviors_path, store)
    total, warmup = schedule(log.num_events, cfg)
    return SimpleNamespace(
        seed=seed, paths=paths, args=args, trainer=trainer, store=store,
        sampler=trainer._train_sampler(log, store),
        batcher=Batcher(args.train_batch_size, drop_last=True, shuffle=True, seed=args.seed),
        total=total, warmup=warmup,
        specs=ref_miner.param_specs(cfg, len(trainer.category2id)))


def run(r: Run):
    import torch

    from reference import miner as ref_miner
    from reference.mind import Corpus
    from reference.precision import Precision

    cfg, traffic = dict(r.cell.config), r.cell.traffic
    d = data_plane(cfg, traffic, r.seed, r.tmp, r.device)
    seed, paths, args, trainer, specs = d.seed, d.paths, d.args, d.trainer, d.specs
    total, warmup = d.total, d.warmup
    spans = trace.Spans()
    table = trainer._make_table(d.store)
    model = weights.on_device(trainer, weights.make(specs, seed, trainer.device)).train()
    wrong = port.disagreements(cfg, args, model.news_encoder.plm_cfg)
    if wrong:
        raise ValueError("the configuration file and the port disagree: " + "; ".join(wrong))
    optimizer = trainer.make_optimizer(model, total, warmup)
    spans.wrap(trainer, "_index", "host_to_device")
    batches = feed(d.sampler, d.batcher, spans)

    # the check's steps, through the window's own call and feed
    accum = cfg["gradient_accumulation_steps"]
    checked: List[Dict[str, np.ndarray]] = []
    losses, first_grad = [], None
    for step in range(traffic["check_updates"] * accum):
        batch = next(batches)
        checked.append({k: np.array(batch[k]) for k in
                        ("cand_idx", "his_idx", "label", "impression_id")})
        losses.append(float(trainer.train_step(model, table, batch, optimizer, step)))
        if first_grad is None and optimizer.updates == 1:
            state = optimizer.adamw.state
            first_grad = ref_miner.leaf_norms(  # no moment kept reads as nought
                {n: state[p]["exp_avg"] / (1 - 0.9) if p in state else torch.zeros_like(p)
                 for n, p in zip(optimizer.names, optimizer.params)}, cfg["hidden_size"])
    after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    step = len(checked)
    if r.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - r.started

    # the window
    spans.clear()
    updated = []
    n = 0
    prof = None
    if r.trace and r.device == "cuda":
        trace.mark(optimizer, "step", spans, "update")
        prof = trace.profiler()
        prof.__enter__()
        t_anchor = trace.anchor()
    t0 = time.perf_counter()
    while (n < traffic["trace_micro_batches"] if r.trace
           else time.perf_counter() - t0 < r.seconds):
        batch = next(batches)
        before = optimizer.updates
        with spans.span("train_step"):
            trainer.train_step(model, table, batch, optimizer, step)
        updated.append(optimizer.updates != before)
        step += 1
        n += 1
    if r.device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    window = t1 - t0
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        reduced = trace.reduce(prof, t_anchor, (t0, t1), spans)
        del prof
    peak = torch.cuda.max_memory_allocated() if r.device == "cuda" else 0

    # the check, once the program's state is freed
    del model, optimizer, table, batches, d
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()
    cfg["seed"] = seed
    ref_corpus = Corpus.from_paths(paths, cfg["vocab_size"])
    faults = []
    for i, b in enumerate(checked):
        faults += [f"micro-batch {i}: {x}" for x in
                   ref_miner.check_batch(ref_corpus, b, cfg["his_length"])]
    params = weights.make(specs, seed, trainer.device)
    changed = ref_miner.leaf_norms({nm: after[nm].to(params[nm].device) - params[nm]
                                    for nm in params}, cfg["hidden_size"])
    del after
    params = {nm: t.requires_grad_() for nm, t in params.items()}
    ref = ref_miner.MinerReference(cfg, ref_corpus, params, Precision("fp32"))
    t_ref = time.perf_counter()
    ref_out = ref_miner.follow(ref, checked, traffic["check_updates"], total, warmup)
    t_ref = time.perf_counter() - t_ref
    got = ref_miner.readings({"losses": losses, "first_grad": first_grad, "change": changed},
                             ref_out)
    lim = r.cell.limits["limits"]
    checks = {k: (got[k], lim[k]) for k in lim}
    notes = {"reference_s": t_ref, "check_micro_batches": len(checked),
             **{k: got[k] for k in ("worst_grad_leaf", "worst_change_leaf",
                                    "left_out_of_change")}}

    metrics = {"setup_s": (setup_s, "s"),
               "train_examples_per_s": (n * cfg["train_batch_size"] / window, "examples/s")}
    ctx = SimpleNamespace(kind="train", on_card=r.device == "cuda", cfg=cfg, traffic=traffic,
                          micro_batches=n, window_s=window, trace=reduced, spans=spans,
                          updated=updated)
    return Outcome(attempted=n, failed=0, metrics=metrics, memory_peak_bytes=peak,
                   checks=checks, faults=faults, trace=reduced, notes=notes), ctx
