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
"""
from __future__ import annotations

import sys

from miner_tpu_torch.config import make_parser


def main(argv=None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help()
        return 1

    from miner_tpu_torch.training.trainer import Trainer

    if args.mode in ("train", "train_fastformer", "pretrain"):
        Trainer(args).train()
    elif args.mode in ("eval", "eval_fastformer"):
        Trainer(args).eval()
    elif args.mode == "recommend":
        Trainer(args).recommend()
    elif args.mode == "serve":
        from miner_tpu_torch.serving import serve

        serve(Trainer(args), args.host, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
