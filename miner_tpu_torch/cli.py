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

Every subcommand runs over a mesh of ranks under a launcher, one process
a rank: ``python -m torch.distributed.run --standalone --nproc_per_node W
-m miner_tpu_torch train @cfg --mesh_data W`` (or ``--mesh_model``,
``--mesh_table``; ``parallel/mesh.py``). ``serve`` answers HTTP on rank 0
while the other ranks follow its device calls (``serving.py``);
``recommend`` runs on every rank and rank 0 prints.
"""
from __future__ import annotations

import datetime
import sys

from miner_tpu_torch.config import make_parser

# the collectives' timeout of a serving mesh: a device call whose ranks do
# not all answer within it fails on rank 0 (the followers wait for the next
# call on a group of their own, without it)
SERVE_TIMEOUT = datetime.timedelta(seconds=300)


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
    serving = args.mode in ("serve", "recommend")
    mesh.maybe_initialize_distributed(args.device, SERVE_TIMEOUT if serving else None)
    try:
        if args.mode in ("train", "train_fastformer", "pretrain"):
            Trainer(args).train()
        elif args.mode in ("eval", "eval_fastformer"):
            Trainer(args).eval()
        elif args.mode == "recommend":
            Trainer(args).recommend()
        elif args.mode == "serve":
            from miner_tpu_torch.serving import serve

            serve(Trainer(args), args.host, args.port)
    finally:
        if owned:
            mesh.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
