"""``RunLogger.trace``: the JAX package's profiler context
(``miner_tpu/observability/logging.py:trace``) on ``torch.profiler``.

One optimizer update of the port (``training/optim.py:Optimizer``: the
clip and AdamW) over a small linear model's backward, traced on the CPU:
the Chrome trace is written under the run directory, is JSON, and names the
step's ops (the product, its backward, AdamW's update); under a process
group each rank writes its own file, named by its rank.
"""
import json
import os

import torch

from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.parallel import mesh
from miner_tpu_torch.training.optim import Optimizer


def _one_update():
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    optimizer = Optimizer(model.named_parameters(), learning_rate=1e-3, total_steps=4,
                          warmup_steps=0)
    loss = model(torch.randn(16, 8)).square().mean()
    loss.backward()
    assert optimizer.step()


def _names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


def test_trace_writes_the_step_s_ops_under_the_run_directory(tmp_path):
    logger = RunLogger(str(tmp_path), "train")
    with logger.trace() as d:
        _one_update()
    assert d == os.path.join(logger.run_dir, "trace")
    path = os.path.join(d, "rank0.pt.trace.json")
    assert os.path.isfile(path)
    names = _names(path)
    assert "aten::addmm" in names  # the forward product
    assert any(n.startswith("autograd::engine::evaluate_function: AddmmBackward")
               for n in names)
    assert any("_foreach_" in n or n == "aten::addcdiv_" for n in names), sorted(names)[:40]
    # the profiler's events stay readable, as chip_smoke.py's report reads them
    assert any(e.name == "aten::addmm" for e in logger.profiler.events())


def test_each_rank_writes_its_own_trace(tmp_path, monkeypatch):
    """Under a process group (rank 1 of it here) the file carries the rank,
    and a second trace of another name goes beside the first."""
    logger = RunLogger(str(tmp_path), "train")
    monkeypatch.setattr(mesh, "this_rank", lambda: 1)
    with logger.trace("profile") as d:
        _one_update()
    assert os.listdir(d) == ["rank1.pt.trace.json"]
    assert "aten::addmm" in _names(os.path.join(d, "rank1.pt.trace.json"))
