"""Run observability: directory layout, python logging, CSV sinks, TB, profiler.

Behavioral contract mirrors the reference's three sinks (reference:
src/base_trainer.py:41-89, src/logger_utils.py):

  * python logging to ``<run_dir>/log/all.log`` + stdout;
  * CSVs ``loss.csv`` / ``eval.csv`` / ``epoch.csv`` with the same columns;
  * args dumped to ``args.json`` per run;
  * TensorBoard scalars when ``torch.utils.tensorboard`` is importable.

Also: examples/s counters recorded into ``throughput.csv``, and
``trace``, the JAX package's profiler context on ``torch.profiler``: CPU
activity and, where there is a card, CUDA's, written as a Chrome trace
under the run directory.

Under a process group every rank takes rank 0's run directory, and rank 0
alone writes the files; the other ranks log warnings to stdout.

The port's own copy of ``miner_tpu/observability/logging.py``.
"""
from __future__ import annotations

import contextlib
import csv
import datetime
import json
import logging
import os
import sys
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from miner_tpu_torch.parallel import mesh


class RunLogger:
    def __init__(self, base_dir: str, name: str = "train", args: Optional[dict] = None):
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        if mesh.world_size() > 1:  # rank 0's directory on every rank
            box = [ts]
            dist.broadcast_object_list(box, src=0)
            ts = box[0]
        self.writer = mesh.is_writer()
        self.run_dir = os.path.join(base_dir, ts)

        self.logger = logging.getLogger(f"miner_tpu_torch.{name}.{ts}")
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        if self.writer:
            os.makedirs(os.path.join(self.run_dir, "log"), exist_ok=True)
            fh = logging.FileHandler(os.path.join(self.run_dir, "log", "all.log"))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
        else:
            sh.setLevel(logging.WARNING)
        self.logger.addHandler(sh)
        self.logger.propagate = False

        self._csv_headers: Dict[str, Sequence[str]] = {}
        self._tb = None
        self.profiler: Optional[torch.profiler.profile] = None  # the last trace's
        if args is not None:
            self.dump_args(args)

    def dump_args(self, args: dict):
        if not self.writer:
            return
        with open(os.path.join(self.run_dir, "args.json"), "w") as f:
            json.dump({k: _jsonable(v) for k, v in args.items()}, f, indent=2)

    def enable_tensorboard(self, tb_dir: Optional[str] = None):
        if not self.writer:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(tb_dir or os.path.join(self.run_dir, "tb"))
        except Exception as e:
            self.logger.warning("tensorboard unavailable: %s", e)

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def csv_row(self, name: str, header: Sequence[str], row: Iterable):
        if not self.writer:
            return
        path = os.path.join(self.run_dir, f"{name}.csv")
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(header)
            w.writerow(list(row))

    def log_train(self, epoch: int, step: int, loss: float, lr: float,
                  examples_per_sec: float | None = None):
        self.logger.info(
            "epoch %d step %d loss %.5f lr %.3e%s", epoch, step, loss, lr,
            f" ex/s {examples_per_sec:.1f}" if examples_per_sec else "",
        )
        self.csv_row("loss", ["epoch", "step", "loss", "lr"], [epoch, step, loss, lr])
        self.scalar("train/loss", loss, step)
        self.scalar("train/lr", lr, step)
        if examples_per_sec is not None:
            self.csv_row("throughput", ["step", "examples_per_sec"],
                         [step, examples_per_sec])
            self.scalar("train/examples_per_sec", examples_per_sec, step)

    def log_eval(self, epoch: int, step: int, scores: Dict[str, float],
                 eval_loss: float | None = None):
        self.logger.info("eval epoch %d step %d %s", epoch, step, scores)
        keys = sorted(scores)
        self.csv_row("eval", ["epoch", "step", "loss"] + keys,
                     [epoch, step, eval_loss] + [scores[k] for k in keys])
        for k, v in scores.items():
            self.scalar(f"eval/{k}", v, step)

    def log_epoch(self, epoch: int, train_loss: float, seconds: float):
        self.logger.info("epoch %d done loss %.5f in %.1fs", epoch, train_loss, seconds)
        self.csv_row("epoch", ["epoch", "train_loss", "seconds"],
                     [epoch, train_loss, seconds])

    @contextlib.contextmanager
    def trace(self, name: str = "trace"):
        """``torch.profiler`` over the block, CPU activity and, where there
        is a card, CUDA's; yields the directory ``<run_dir>/<name>``, where
        the Chrome trace is written on exit, one file a rank
        (``rank<r>.pt.trace.json``: under a process group every rank traces
        its own work). The profiler stays on ``self.profiler`` for a caller
        that reads its events."""
        d = os.path.join(self.run_dir, name)
        os.makedirs(d, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        with self.profiler:
            yield d
        self.profiler.export_chrome_trace(
            os.path.join(d, f"rank{mesh.this_rank()}.pt.trace.json"))


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)
