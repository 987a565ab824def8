"""The harness finds every configuration, traffic mix, limit file and metric
by its name, and a cell made of new files alone runs."""
import json
import os

import pytest
from conftest import run_cell

from harness import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_find_their_files(cell):
    c = spec.cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert c.traffic["name"] == entry["traffic"]
    assert os.path.exists(os.path.join(spec.BENCH_DIR, "harness", f"{c.traffic['kind']}.py"))
    assert set(c.limits["limits"])
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(c.readers[m["name"]].read)


def test_every_metric_and_config_is_a_file_of_its_own():
    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "metrics"))
             if f.endswith(".py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= files
    for name in files:  # every reader, those of cells still to come too
        assert callable(spec.reader(name).read)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_unknown_cell_names_what_there_is():
    with pytest.raises(KeyError, match="miner-train"):
        spec.cell("no-such-cell")


def test_a_cell_of_new_files_alone_runs(tiny_root):
    """The tiny cells are added to a copy by new configuration, traffic and
    limit files and BENCHMARK.json entries alone; one runs end to end."""
    c = spec.cell("tiny-train", tiny_root)
    assert c.config["name"] == "tiny-miner" and c.traffic["kind"] == "train"
    rc, result = run_cell(tiny_root, "tiny-train")
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert list(result)[-1] == "check"
