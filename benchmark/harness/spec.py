"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic; everything else belongs to one name and sits in a
file of its own, found by that name:

  * ``benchmark/configs/<config>.json``: the model's sizes, the port's flags
    and the source;
  * ``benchmark/traffic/<traffic>.json``: the mix's parameters, and its
    ``kind``, the runner that drives it (``harness/<kind>.py``);
  * ``benchmark/limits/<cell>.json``: the limit of each number that decides
    ``correct``, with the readings it was set from;
  * ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; no file here names any of them.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, object] = field(default_factory=dict)


def benchmark(root: str = ROOT) -> Dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module of ``metrics/<name>.py`` (a name may hold dots)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = benchmark(root)
    bench_dir = os.path.join(root, "benchmark")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {known})")
    config = _load(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    traffic = _load(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    limits = _load(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer,
                readers={m["name"]: reader(m["name"], bench_dir) for m in per_layer})
