"""The rate sweep that fixes a rerank cell's offered rate.

    python3 benchmark/sweep.py --workload unbert-rerank --seed <n> \\
        --seconds 20 --rates 40 50 60 70 80

One set-up (as a run of the cell makes it), then one window of the cell's
traffic at each rate, in the order given, each with the same seed. For each
rate it prints the requests, how many failed, the median, 95th and 99th
percentiles and the largest latency (from the due time), the latency's
drift over the window (the median of its last quarter less that of its
first: a backlog that grows shows as a drift that grows with the window),
the requests a device call, the rows run a second and how late the
generator ran. The highest rate whose drift stays near zero is the knee;
the cell's rate is set at about four fifths of it. Results go to
``--out`` as JSON as well.
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

import numpy as np  # noqa: E402

from harness import main, rerank, spec, trace  # noqa: E402


def summary(records, calls, requests, seconds):
    ok = [r for r in records if r and r.get("status") == 200]
    lat = np.array([(r["done"] - r["due"]) * 1e3 for r in ok])
    due = np.array([r["due"] for r in ok])
    q = seconds / 4
    first, last = lat[due < q], lat[due >= 3 * q]
    return {"requests": len(records), "failed": len(records) - len(ok),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": rerank.p95_ms(records),
            "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat.max()),
            "drift_ms": float(np.median(last) - np.median(first)),
            "requests_per_call": requests / max(1, len(calls)),
            "rows_run_per_s": sum(c[1] for c in calls) / seconds,
            "late_ms": max((r["sent"] - r["due"]) * 1e3 for r in records if r)}


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=spec.ROOT, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload, a.root)
    missing = main.card_ok(cell.chips, a.device)
    if missing:
        print(f"no result: {missing}", file=sys.stderr)
        return 2
    out = []
    with tempfile.TemporaryDirectory(prefix="sweep-") as tmp:
        r = main.Run(cell=cell, seed=a.seed, seconds=a.seconds, trace=False, device=a.device,
                     started=time.time(), tmp=tmp)
        spans = trace.Spans()
        server = rerank.Server(r, spans)
        try:
            for rate in a.rates:
                reqs = rerank.requests(cell.traffic, server.seed, a.seconds, rate, server.n_news)
                server.calls.clear()
                before = server.counters()
                records = rerank.window(server, reqs, tmp, spans)[0]
                after = server.counters()
                row = {"rate_per_s": rate, **summary(records, list(server.calls),
                                                     after[0] - before[0], a.seconds)}
                out.append(row)
                print(json.dumps(row), flush=True)
        finally:
            server.close()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(run())
