"""One rank of the port over a mesh of CPU processes, for the mesh tests.

    python tests/_torch_mesh_worker.py RANK WORLD RENDEZVOUS JOBS.json

joins a gloo process group of WORLD ranks through the file RENDEZVOUS
(``init_method="file://..."``, so concurrent tests never share a port) on
one intra-op thread, then runs each job of JOBS.json in turn through the
port's ``Trainer``, as ``python -m miner_tpu_torch`` does under a launcher:
``{"argv": [...], "out": "prefix", "no_plm_dropout": bool}``. A train
job writes ``prefix.RANK.pt`` with the rank's final parameters (whole,
their shares gathered over the model axis), the global loss of each
micro-step, each update's gradients (:func:`record`) and the micro-steps
of the history-cache rebuilds; an eval job its scores; a recommend job its
ranking; a serve job (``"requests"``: a list of ``[history, candidates,
topk]``) the replies rank 0's ``ScoringService`` gives them, the other
ranks following its device calls. With ``no_plm_dropout`` the PLM's config
rates are 0, as the tests patch them in-process; ``resume_glob`` names the
checkpoint of an earlier job to ``--resume_from`` (its run directory's
timestamp is known only once that job ran). TensorFlow is kept out of the ranks
(TensorBoard then writes through its own stub), which saves seconds a
process.

``Ranks(jobs, world, directory)`` starts the ranks in the background;
``Ranks.wait()`` returns each rank's results and raises with the logs when
a rank fails (stopping the others at once: they would wait for it) or
outlives its time limit.
"""
import dataclasses as dc
import datetime
import glob
import json
import os
import subprocess
import sys
import time

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
        self.logs = [os.path.join(directory, f"rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:  # a file: nothing blocks on a full pipe
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), str(world), rendezvous,
                     path], env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True))
        self.t0 = time.monotonic()
        self._results = None

    def wait(self):
        """{job "out" prefix: [rank 0's results, rank 1's, ...]}."""
        if self._results is None:
            import torch

            while any(p.poll() is None for p in self.procs):
                failed = any(p.returncode not in (None, 0) for p in self.procs)
                if failed or time.monotonic() - self.t0 > self.timeout:
                    for q in self.procs:
                        q.kill()
                    for q in self.procs:
                        q.wait()
                    if not failed:
                        raise TimeoutError(f"the ranks outlived {self.timeout} s")
                    break
                time.sleep(0.2)
            # a rank that failed by itself first, those stopped after it last
            for r in sorted(range(self.world), key=lambda r: self.procs[r].returncode < 0):
                with open(self.logs[r], errors="replace") as f:
                    log = f.read()
                assert self.procs[r].returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
            self._results = {job["out"]: [torch.load(f"{job['out']}.{r}.pt", weights_only=False)
                                          for r in range(self.world)] for job in self.jobs}
        return self._results


def record(trainer) -> dict:
    """Record ``trainer``'s training: the global loss of each micro-step,
    each update's gradients as AdamW takes them (summed over the data
    group, divided and clipped; a sharded leaf's gathered whole over the
    model group) by name and their global norm before the clip, and the
    history caches made."""
    from miner_tpu_torch.parallel import tp

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
            specs = tp.specs_of(model)
            rec["grads"].append({
                names[id(p)]: tp.gather(p.grad, specs[names[id(p)]], trainer.mesh.model_group)
                if names[id(p)] in specs else p.grad.detach().clone() for p in opt.params})
            rec["grad_norms"].append(float(opt.grad_norm))
            return adamw_step(*x, **k)

        opt.adamw.step = adamw_recorded
        return opt

    trainer.train_step = recorded_step
    trainer.make_optimizer = recorded_optimizer
    trainer.make_history_cache = lambda *a: rec["caches"].append(make_cache(*a)) or \
        rec["caches"][-1]
    return rec


PLM_CONFIG = None  # the package's own plm_config, kept by main


def run_job(job: dict, rank: int) -> None:
    import torch

    import miner_tpu_torch.training.trainer as port_trainer
    from miner_tpu_torch.config import make_parser

    port_trainer.plm_config = PLM_CONFIG  # as the package has it, whatever a job did
    if job.get("no_plm_dropout"):
        port_trainer.plm_config = lambda *a, **k: dc.replace(
            PLM_CONFIG(*a, **k), hidden_dropout=0.0, attention_dropout=0.0)
    argv = list(job["argv"])
    if job.get("resume_glob"):
        (path,) = glob.glob(job["resume_glob"])
        argv += ["--resume_from", path]
    args = make_parser().parse_args(argv)
    trainer = port_trainer.Trainer(args)
    out = {}
    if args.mode in ("eval", "eval_fastformer"):
        out["scores"] = trainer.eval()
    elif args.mode == "recommend":
        out["results"] = trainer.recommend()
    elif args.mode == "serve":
        from miner_tpu_torch.serving import ScoringService

        service = ScoringService(trainer)
        try:
            if rank == 0:
                out["replies"] = [service.score(*r) for r in job["requests"]]
            else:
                out["calls"] = service.mesh_calls.follow()
        finally:
            service.close()
    else:
        rec = record(trainer)
        run = trainer.train()
        caches = rec.pop("caches")
        out.update(rec, params=trainer.full_state_dict(run.model), run_dir=run.run_dir,
                   fills=caches[0].fills if caches and caches[0] else [])
    torch.save(out, f"{job['out']}.{rank}.pt")


def main():
    rank, world, rendezvous, jobs = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4])
    sys.modules["tensorflow"] = None
    import torch
    import torch.distributed as dist

    import miner_tpu_torch.training.trainer as port_trainer

    global PLM_CONFIG
    PLM_CONFIG = port_trainer.plm_config
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    with open(jobs) as f:
        for job in json.load(f):
            run_job(job, rank)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
