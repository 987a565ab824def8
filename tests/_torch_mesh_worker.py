"""One rank of the port over a mesh of CPU processes, for the mesh tests.

    python tests/_torch_mesh_worker.py RANK WORLD RENDEZVOUS JOBS.json

joins a gloo process group of WORLD ranks through the file RENDEZVOUS
(``init_method="file://..."``, so concurrent tests never share a port) on
one intra-op thread, then runs each job of JOBS.json in turn through the
port's ``Trainer``, as ``python -m miner_tpu_torch`` does under a launcher:
``{"argv": [...], "out": "prefix", "no_plm_dropout": bool}``. A train
job writes ``prefix.RANK.pt`` with the rank's final parameters, the global
loss of each micro-step, each update's gradients (:func:`record`) and the
micro-steps of the history-cache rebuilds;
an eval job its scores. With ``no_plm_dropout`` the PLM's config rates are
0, as the tests patch them in-process. TensorFlow is kept out of the ranks
(TensorBoard then writes through its own stub), which saves seconds a
process.

``Ranks(jobs, world, directory)`` starts the ranks in the background;
``Ranks.wait()`` returns each rank's results and raises with the logs when
a rank fails or outlives its time limit.
"""
import dataclasses as dc
import datetime
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    def __init__(self, jobs, world: int, directory: str, timeout: float = 600):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "jobs.json")
        with open(path, "w") as f:
            json.dump(jobs, f)
        rendezvous = os.path.join(directory, "rendezvous")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.jobs, self.world, self.timeout = jobs, world, timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), rendezvous, path],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._results = None

    def wait(self):
        """{job "out" prefix: [rank 0's results, rank 1's, ...]}."""
        if self._results is None:
            import torch

            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=self.timeout)[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
            self._results = {job["out"]: [torch.load(f"{job['out']}.{r}.pt", weights_only=False)
                                          for r in range(self.world)] for job in self.jobs}
        return self._results


def record(trainer) -> dict:
    """Record ``trainer``'s training: the global loss of each micro-step,
    each update's gradients as AdamW takes them (summed over the data
    group, divided and clipped) by name and their global norm before the
    clip, and the history caches made."""
    rec = {"losses": [], "grads": [], "grad_norms": [], "caches": []}
    step, make_cache, make_optimizer = (trainer.train_step, trainer.make_history_cache,
                                        trainer.make_optimizer)

    def recorded_step(*a):
        loss = step(*a)
        rec["losses"].append(float(loss))
        return loss

    def recorded_optimizer(model, *a):
        opt = make_optimizer(model, *a)
        names = {id(p): n for n, p in model.named_parameters()}
        adamw_step = opt.adamw.step

        def adamw_recorded(*x, **k):
            rec["grads"].append({names[id(p)]: p.grad.detach().clone() for p in opt.params})
            rec["grad_norms"].append(float(opt.grad_norm))
            return adamw_step(*x, **k)

        opt.adamw.step = adamw_recorded
        return opt

    trainer.train_step = recorded_step
    trainer.make_optimizer = recorded_optimizer
    trainer.make_history_cache = lambda *a: rec["caches"].append(make_cache(*a)) or \
        rec["caches"][-1]
    return rec


def run_job(job: dict, rank: int) -> None:
    import torch

    import miner_tpu_torch.training.trainer as port_trainer
    from miner_tpu_torch.config import make_parser

    if job.get("no_plm_dropout"):
        make = port_trainer.plm_config
        port_trainer.plm_config = lambda *a, **k: dc.replace(
            make(*a, **k), hidden_dropout=0.0, attention_dropout=0.0)
    args = make_parser().parse_args(job["argv"])
    trainer = port_trainer.Trainer(args)
    out = {}
    if args.mode in ("eval", "eval_fastformer"):
        out["scores"] = trainer.eval()
    else:
        rec = record(trainer)
        run = trainer.train()
        caches = rec.pop("caches")
        out.update(rec, params=run.model.state_dict(), run_dir=run.run_dir,
                   fills=caches[0].fills if caches and caches[0] else [])
    torch.save(out, f"{job['out']}.{rank}.pt")


def main():
    rank, world, rendezvous, jobs = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4])
    sys.modules["tensorflow"] = None
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    with open(jobs) as f:
        for job in json.load(f):
            run_job(job, rank)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
