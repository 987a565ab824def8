"""CLI entry point of the port.

``python -m miner_tpu_torch train @config/train_miner.txt``,
``train_fastformer @config/train_fastformer.txt`` or
``@config/train_unbert.txt`` (``train`` by another name, as in JAX;
``--model_name`` picks the family: Miner, fastformer or unbert), ``pretrain
@config/pretrain_miner.txt`` (contrastive pretraining of the news encoder
alone, whatever ``--model_name`` says), ``eval
@config/eval_miner.txt`` or ``eval_fastformer @config/eval_unbert.txt``
(a port checkpoint), ``serve @config/serve_miner.txt`` (HTTP scoring
server over the news-embedding cache) or ``@config/serve_unbert.txt``
(the UnBERT cross-encoder reranking slates) and ``recommend ...``
(one-shot ranking), on
``--device`` (default ``cuda``).

Train, pretrain and eval run over a mesh of ranks under a launcher, one
process a rank: ``python -m torch.distributed.run --standalone
--nproc_per_node W -m miner_tpu_torch train @cfg --mesh_data W``
(``parallel/mesh.py``). Serving stays one process.
"""
from __future__ import annotations

import sys

from miner_tpu_torch.config import make_parser


def refuse_mesh_serving(args) -> None:
    """``serve`` and ``recommend`` are one process on one device, as the
    JAX package's serving: refused under a process group of several ranks
    or with a mesh flag above 1."""
    from miner_tpu_torch.parallel import mesh

    flags = {f"--mesh_{k}": getattr(args, f"mesh_{k}") for k in ("data", "table", "model")}
    if mesh.world_size() > 1 or any(v > 1 for v in flags.values()):
        raise NotImplementedError(
            f"{args.mode} over a mesh ({mesh.world_size()} ranks, {flags}): serving "
            "over the table axis is not ported yet (ROADMAP Queue 1 item 6); serve "
            "from one process")


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help()
        return 1

    import torch

    from miner_tpu_torch.parallel import mesh
    from miner_tpu_torch.training.trainer import Trainer

    owned = not torch.distributed.is_initialized()  # a group the caller started is its own
    mesh.maybe_initialize_distributed(args.device)
    try:
        if args.mode in ("train", "train_fastformer", "pretrain"):
            Trainer(args).train()
        elif args.mode in ("eval", "eval_fastformer"):
            Trainer(args).eval()
        elif args.mode == "recommend":
            refuse_mesh_serving(args)
            Trainer(args).recommend()
        elif args.mode == "serve":
            from miner_tpu_torch.serving import serve

            refuse_mesh_serving(args)
            serve(Trainer(args), args.host, args.port)
    finally:
        if owned:
            mesh.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
