"""The runner of ``rerank`` traffic: UnBERT reranking behind the port's HTTP
front end, under an open loop of arrivals at the traffic's fixed rate.

Set-up: the corpus from the seed; the port's ``Trainer`` with the
configuration's serving flags, its model built on the card from the seed's
weights (``harness/weights.py``); ``ScoringService`` (the news store, the
packer, the ``MicroBatcher``) and ``make_http_server`` on a port of
localhost; every (batch, slate) bucket the traffic can reach run once
(``ScoringService.warmup``), then a few requests through HTTP.

The requests: their sizes and gaps are the same for every seed (drawn from
the traffic's ``shape_seed``: a Poisson process of ``rate_per_s`` over the
window, log-normal slates and histories), the seed orders them and draws
which news they hold. The window: ``harness/loadgen.py``, a process of its
own, sends each at its due time; a request's latency runs from that due time
to its complete reply; a failed or missing reply counts as over any limit.
With ``--trace 1`` the first ``trace_seconds`` of the window run under
``torch.profiler`` and the benchmark's spans sit around the device calls
and the packer.

The check, once the program's state is freed: the reference
(``reference/unbert.py``) packs and scores again a sample of the replies,
drawn from the seed with the longest slate in it.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from harness import corpus, port, trace, weights
from harness.main import Outcome, Run

HERE = os.path.dirname(os.path.abspath(__file__))
GRACE_S = 60.0


def _sizes(rng, spec: Dict, n: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def requests(traffic: Dict, seed: int, seconds: float, rate: float, n_news: int) -> List[Dict]:
    """The window's requests: due times and bodies."""
    shape = np.random.default_rng(traffic["shape_seed"])
    n = int(round(rate * seconds))
    due = np.sort(shape.uniform(0.0, seconds, n))
    gaps = np.diff(np.concatenate([[0.0], due]))
    slates = _sizes(shape, traffic["slate"], n)
    hists = _sizes(shape, traffic["history"], n)
    rng = np.random.default_rng(seed)
    due = np.cumsum(gaps[rng.permutation(n)])
    slates, hists = slates[rng.permutation(n)], hists[rng.permutation(n)]
    ids = corpus.news_ids(n_news)
    out = []
    for i in range(n):
        picks = rng.choice(n_news, int(slates[i] + hists[i]), replace=False)
        out.append({"due": float(due[i]),
                    "body": {"history": [ids[j] for j in picks[slates[i]:]],
                             "candidates": [ids[j] for j in picks[:slates[i]]]}})
    return out


def _post(port_: int, body: Dict) -> Dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port_}/score",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


class Server:
    """The port's scoring service behind its HTTP front end, warmed up."""

    def __init__(self, r: Run, spans: trace.Spans):
        from miner_tpu_torch.serving import ScoringService, make_http_server
        from miner_tpu_torch.training import trainer as trainer_module
        from miner_tpu_torch.training.trainer import Trainer
        from reference import unbert as ref_unbert

        cfg, traffic = r.cell.config, r.cell.traffic
        self.seed = port.port_seed(r.seed)
        self.paths = corpus.write_corpus(os.path.join(r.tmp, "corpus"), traffic["corpus"],
                                         r.seed)
        args = port.parse(cfg, "serve", [
            "--eval_news_path", self.paths["news"], "--user2id_path", self.paths["user2id"],
            "--category2id_path", self.paths["category2id"], "--seed", str(self.seed),
            "--device", r.device, "--host", "127.0.0.1", "--port", "0"])
        self.trainer = trainer = Trainer(args)
        self.specs = ref_unbert.param_specs(cfg)
        made = weights.make(self.specs, self.seed, trainer.device)
        build = trainer.build_model
        trainer.build_model = lambda: weights.on_device(SimpleNamespace(
            build_model=build, device=trainer.device), made)
        self.service = ScoringService(trainer, state_dict=made)
        del made
        trainer.build_model = build
        wrong = port.disagreements(cfg, args, self.service.ctx.model.cfg)
        if wrong:
            raise ValueError("the configuration file and the port disagree: " + "; ".join(wrong))
        self.calls: List[tuple] = []  # (start on perf_counter, rows run, real rows)
        batcher = self.service.batcher

        def count(cand_idx, his_idx):
            self.calls.append((time.perf_counter(), cand_idx.size,
                               int(np.count_nonzero(cand_idx))))

        spans.wrap(trainer_module, "pack_rows", "pack_rows")
        spans.wrap(batcher, "score_fn", "device_call", before=count)
        self.service.warmup(traffic["warmup_slates"])
        self.http = make_http_server(self.service, "127.0.0.1", 0, impl=args.serve_http_impl)
        self.port = self.http.server_address[1]
        self.thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.thread.start()
        n_news = self.service.num_news - 1
        for req in requests(traffic, self.seed, traffic["warm_requests"] / 10.0, 10.0, n_news):
            _post(self.port, req["body"])
        self.n_news = n_news

    def counters(self):
        b = self.service.batcher
        return b.requests, b.device_batches

    def close(self):
        self.http.shutdown()
        self.thread.join(timeout=10)
        self.service.close()


def window(server: Server, reqs: List[Dict], tmp: str, spans: trace.Spans,
           profile_s: float = 0.0):
    """Send ``reqs`` through the load generator; (records, reduced trace or
    None, connections opened, the window's start on ``perf_counter``)."""
    plan = os.path.join(tmp, "plan.json")
    out = os.path.join(tmp, "records.json")
    with open(plan, "w") as f:
        json.dump({"port": server.port, "connections": 64, "grace_s": GRACE_S,
                   "requests": reqs}, f)
    gen = subprocess.Popen([sys.executable, os.path.join(HERE, "loadgen.py"), plan, out],
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if gen.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        prof = None
        if profile_s:
            prof = trace.profiler()
            prof.__enter__()
            t_anchor = trace.anchor()
        gen.stdin.write("go\n")
        gen.stdin.flush()
        go = time.perf_counter()
        reduced = None
        if prof is not None:
            time.sleep(profile_s)
            prof.__exit__(None, None, None)
            reduced = trace.reduce(prof, t_anchor, (go, go + profile_s), spans)
            del prof
        last = max((q["due"] for q in reqs), default=0.0)
        gen.wait(timeout=last + GRACE_S + 60)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    with open(out) as f:
        got = json.load(f)
    return got["records"], reduced, got["connections"], go


# the latency a failed or missing reply counts as: over any limit
FAILED_MS = 1e9


def p95_ms(records: List[Dict]) -> float:
    """The 95th percentile (nearest rank) of every request's latency."""
    lat = sorted((r["done"] - r["due"]) * 1e3 if r and r.get("status") == 200 and r["done"]
                 else FAILED_MS for r in records)
    return lat[max(0, int(np.ceil(0.95 * len(lat))) - 1)]


def sample(reqs: List[Dict], done: List[int], seed: int, n: int) -> List[int]:
    """The requests the check compares: the longest slate of ``done`` and
    ``n - 1`` others drawn from the seed."""
    if not done:
        return []
    rng = np.random.default_rng([seed, 1])
    longest = max(done, key=lambda i: len(reqs[i]["body"]["candidates"]))
    others = [i for i in done if i != longest]
    return [longest] + [int(i) for i in
                        rng.choice(others, min(len(others), n - 1), replace=False)]


def check(r: Run, paths: Dict, seed: int, specs, reqs, records, device) -> tuple:
    """(checks, faults, seconds the reference took, rows compared) of a sample
    of the replies."""
    from reference import unbert as ref_unbert
    from reference.mind import Corpus
    from reference.precision import Precision

    cfg, traffic, lim = r.cell.config, r.cell.traffic, r.cell.limits["limits"]
    t0 = time.perf_counter()
    faults = [f"request {i}: {'no reply' if not rec else rec.get('status')}"
              for i, rec in enumerate(records) if not rec or rec.get("status") != 200]
    done = [i for i, rec in enumerate(records) if rec and rec.get("status") == 200]
    ref_corpus = Corpus.from_paths(paths, cfg["vocab_size"])
    ref = ref_unbert.UnbertReference(cfg, ref_corpus, weights.make(specs, seed, device),
                                     Precision("fp32"))
    bodies, replies = [], []
    for i in sample(reqs, done, seed, traffic["check_requests"]):
        results = records[i]["body"]["results"]
        if sorted(nid for nid, _ in results) != sorted(reqs[i]["body"]["candidates"]):
            faults.append(f"request {i}: the reply does not rank the request's candidates")
            continue
        bodies.append(reqs[i]["body"])
        replies.append(results)
    got = ref_unbert.readings(ref, bodies, replies)
    checks = {k: (got[k], lim[k]) for k in lim}
    return checks, faults, time.perf_counter() - t0, got["rows"]


def run(r: Run):
    import torch

    cfg, traffic = r.cell.config, r.cell.traffic
    spans = trace.Spans()
    server = Server(r, spans)
    reqs = requests(traffic, server.seed, r.seconds, traffic["rate_per_s"], server.n_news)
    if r.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - r.started
    spans.clear()
    server.calls.clear()
    req0, calls0 = server.counters()
    profile_s = traffic["trace_seconds"] if r.trace and r.device == "cuda" else 0.0
    records, reduced, opened, go = window(server, reqs, r.tmp, spans, profile_s)
    req1, calls1 = server.counters()
    peak = torch.cuda.max_memory_allocated() if r.device == "cuda" else 0
    server.close()
    paths, seed, specs = server.paths, server.seed, server.specs
    calls = list(server.calls)
    del server
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()
    checks, faults, t_ref, n_rows = check(r, paths, seed, specs, reqs, records, r.device)
    failed = sum(1 for rec in records if not rec or rec.get("status") != 200)
    late = max((rec["sent"] - rec["due"] for rec in records if rec), default=0.0)
    traced = [c for c in calls if reduced is not None and go <= c[0] <= go + reduced["window_s"]]
    ctx = SimpleNamespace(kind="rerank", on_card=r.device == "cuda", cfg=cfg, traffic=traffic,
                          trace=reduced, spans=spans,
                          requests=req1 - req0, device_calls=calls1 - calls0, calls=calls,
                          traced_calls=traced)
    metrics = {"setup_s": (setup_s, "s"), "rerank_p95_ms": (p95_ms(records), "ms")}
    notes = {"reference_s": t_ref, "rows_checked": n_rows, "generator_late_ms": late * 1e3,
             "connections": opened, "requests": len(reqs)}
    return Outcome(attempted=len(reqs), failed=failed, metrics=metrics, memory_peak_bytes=peak,
                   checks=checks, faults=faults, trace=reduced, notes=notes), ctx
