"""One run of one cell: set-up, the measured window, the check, the result.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`` prints,
as the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each number that decided
``correct`` beside its limit, also printed as the last lines of standard
error. Without the card the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits with 2 or 3.

The runner of a cell is ``harness/<kind>.py`` of its traffic's ``kind``; it
returns an ``Outcome`` and the context its per-layer metrics read.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "miner_tpu")


def process_start() -> float:
    """This process's start on ``time.time()``'s clock, from the kernel's
    record of it where there is one."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Outcome:
    """What a runner hands back. ``checks`` maps each compared number to
    (value, limit); ``faults`` lists what the check found wrong outright
    (a reply that never came, a malformed batch)."""

    attempted: int
    failed: int
    metrics: Dict[str, Tuple[float, str]]
    memory_peak_bytes: int
    checks: Dict[str, Tuple[float, float]]
    faults: List[str] = field(default_factory=list)
    trace: Optional[Dict] = None
    notes: Dict = field(default_factory=dict)


@dataclass
class Run:
    """What a runner is given."""

    cell: spec.Cell
    seed: int
    seconds: int
    trace: bool
    device: str
    started: float
    tmp: str


def loaded_forbidden() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_ok(chips: int, device: str) -> Optional[str]:
    if device != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} card(s), the cell asks for {chips}"
    return None


def device_record(device: str, chips: int, peak: int, trace: Optional[Dict]) -> Dict:
    if device == "cuda":
        import torch

        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["window_s"]
    return rec


def per_layer(cell: spec.Cell, ctx) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="The port's benchmark: one run of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the tests' rehearsal on the CPU at a small size; the benchmark's runs
    # take the card
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=spec.ROOT, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, started: Optional[float] = None) -> int:
    started = process_start() if started is None else started
    a = parse(argv)
    cell = spec.cell(a.workload, a.root)
    missing = card_ok(cell.chips, a.device)
    if missing:
        print(f"no result: {missing}", file=sys.stderr)
        return 2
    import tempfile

    runner = importlib.import_module(f"harness.{cell.traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        outcome, ctx = runner.run(Run(cell=cell, seed=a.seed, seconds=a.seconds,
                                      trace=bool(a.trace), device=a.device,
                                      started=started, tmp=tmp))
    found = loaded_forbidden()
    if found:
        print(f"no result: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    if a.trace:
        metrics = per_layer(cell, ctx)
    else:
        metrics = {m["name"]: {"value": float(outcome.metrics[m["name"]][0]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in
              outcome.checks.items()}
    correct = (not outcome.faults and outcome.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device_record(a.device, cell.chips, outcome.memory_peak_bytes,
                                      outcome.trace if a.trace else None)}
    if a.trace and outcome.trace is not None:
        result["breakdown"] = outcome.trace["breakdown"]
    result["notes"] = outcome.notes
    result["check"] = {**checks, **({"faults": {"value": len(outcome.faults), "limit": 0}}
                                    if outcome.faults else {})}
    for fault in outcome.faults[:20]:
        print(f"fault: {fault}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
