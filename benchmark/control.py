"""The readings behind the limits of ``correct``: the control and the faults,
at a cell's own size, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --out <file.json>

The control is the reference put in the program's place and computed in the
precision below the configuration's (bfloat16: fp8, ``reference/
precision.py``), read against the float32 reference exactly as a run's
program is read. For a training cell, one fault as well, planted in the
reference put in the program's place: half of each micro-batch left out and
the mean taken over the rest. (A step that returns its state unchanged reads
1 on the change's gap with no run.)

Training: per seed, the cell's corpus and the port's data plane (sampler and
batcher, as a run feeds its check) give the micro-batches; the float32
reference, the fp8 control and the faulty reference each follow the same
optimizer steps from the seed's weights. Reranking: per seed, the window's
requests at the cell's rate over ``run_seconds``, the check's sample of
them; the fp8 control's scores and order are read against the float32
reference's. Each seed's readings are printed as a JSON line and written to
``--out``. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[var] = "0"
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import main, spec  # noqa: E402


def train_readings(cell, seed: int, tmp: str, device: str) -> dict:
    import itertools

    from harness import trace, weights
    from harness.train import data_plane, feed
    from reference import miner as ref_miner
    from reference.mind import Corpus
    from reference.precision import Precision

    cfg, traffic = dict(cell.config), cell.traffic
    d = data_plane(cfg, traffic, seed, tmp, device)
    cfg["seed"] = d.seed
    steps = traffic["check_updates"] * cfg["gradient_accumulation_steps"]
    batches = [{k: batch[k] for k in ("cand_idx", "his_idx", "label", "impression_id")}
               for batch in itertools.islice(feed(d.sampler, d.batcher, trace.Spans()), steps)]
    ref_corpus = Corpus.from_paths(d.paths, cfg["vocab_size"])

    def follow(precision: str, half: bool = False):
        params = {n: t.requires_grad_()
                  for n, t in weights.make(d.specs, d.seed, device).items()}
        ref = ref_miner.MinerReference(cfg, ref_corpus, params, Precision(precision))
        return ref_miner.follow(ref, batches, traffic["check_updates"], d.total, d.warmup,
                                half=half)

    t0 = time.perf_counter()
    want = follow("fp32")
    t_ref = time.perf_counter() - t0
    out = {"reference_s": t_ref}
    for name, got in (("control_fp8", follow("fp8")), ("fault_half_batch", follow("fp32", True))):
        read = ref_miner.readings(got, want)
        out[name] = {k: read[k] for k in ("loss_gap", "grad_gap", "change_gap",
                                          "worst_grad_leaf", "worst_change_leaf")}
    out["left_out_of_change"] = read["left_out_of_change"]
    return out


def rerank_readings(cell, seed: int, tmp: str, device: str, seconds: int) -> dict:
    from harness import corpus, port, weights
    from harness.rerank import requests, sample
    from reference import unbert as ref_unbert
    from reference.mind import Corpus
    from reference.precision import Precision

    cfg, traffic = cell.config, cell.traffic
    paths = corpus.write_corpus(os.path.join(tmp, "corpus"), traffic["corpus"], seed)
    ref_corpus = Corpus.from_paths(paths, cfg["vocab_size"])
    s = port.port_seed(seed)
    reqs = requests(traffic, s, seconds, traffic["rate_per_s"], ref_corpus.num_rows - 1)
    picked = sample(reqs, list(range(len(reqs))), s, traffic["check_requests"])
    bodies = [reqs[i]["body"] for i in picked]
    specs = ref_unbert.param_specs(cfg)
    low = ref_unbert.UnbertReference(cfg, ref_corpus, weights.make(specs, s, device),
                                     Precision("fp8"))
    fp8 = ref_unbert.score_requests(low, bodies)
    replies, at = [], 0
    for b in bodies:  # the control's replies: its scores, best first
        scored = list(zip(b["candidates"], fp8[at:at + len(b["candidates"])].tolist()))
        at += len(b["candidates"])
        replies.append(sorted(scored, key=lambda x: -x[1]))
    ref = ref_unbert.UnbertReference(cfg, ref_corpus, weights.make(specs, s, device),
                                     Precision("fp32"))
    read = ref_unbert.readings(ref, bodies, replies)
    return {"control_fp8": {k: read[k] for k in ("score_gap", "score_rms_gap")},
            "rows": read["rows"]}


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=spec.ROOT, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload, a.root)
    missing = main.card_ok(cell.chips, a.device)
    if missing:
        print(f"no result: {missing}", file=sys.stderr)
        return 2
    seconds = spec.benchmark(a.root)["run_seconds"]
    rows = []
    for seed in a.seeds:
        with tempfile.TemporaryDirectory(prefix="control-") as tmp:
            if cell.traffic["kind"] == "train":
                got = train_readings(cell, seed, tmp, a.device)
            else:
                got = rerank_readings(cell, seed, tmp, a.device, seconds)
        rows.append({"seed": seed, **got})
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(run())
