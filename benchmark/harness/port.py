"""The port's command line as a configuration file states it.

A configuration file holds the port's flags (``args``) beside the sizes it
publishes; the run adds the corpus's paths, the hash tokenizer at the
configuration's vocabulary size, the seed and the device, parses them with
the port's own parser, and checks that every size the file states is the
one the parsed flags give.
"""
from __future__ import annotations

from typing import Dict, List

# configuration keys that are also flags of the port's, by the same name
FLAGS = ("max_title_length", "max_sapo_length", "his_length", "npratio", "train_batch_size",
         "gradient_accumulation_steps", "learning_rate", "warmup_ratio", "weight_decay",
         "max_grad_norm", "num_train_epochs", "word_embed_dim", "category_embed_dim",
         "num_context_codes", "context_code_dim", "dropout", "compute_dtype", "remat",
         "serve_max_batch")

# the sizes each preset gives (miner_tpu_torch/config.py:plm_config)
PRESET_KEYS = ("hidden_size", "num_layers", "num_heads", "intermediate_size",
               "layer_norm_eps", "hidden_dropout", "attention_dropout", "position_offset",
               "gelu_approx")
CONFIG_KEY = {"num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
              "hidden_dropout": "hidden_dropout_prob",
              "attention_dropout": "attention_probs_dropout_prob"}

SEED_RANGE = 2 ** 31 - 1


def port_seed(seed: int) -> int:
    """The port's ``--seed`` of a run's seed (the native sampler takes 31
    bits); the weights are made from it too, the corpus from the run's."""
    return int(seed) % SEED_RANGE


def parse(cfg: Dict, mode: str, extra: List[str]):
    from miner_tpu_torch.config import make_parser

    words = [mode, *cfg["args"], "--pretrained_tokenizer", f"hash:{cfg['vocab_size']}",
             *extra]
    return make_parser().parse_args(words)


def disagreements(cfg: Dict, args, plm) -> List[str]:
    """Where the parsed flags and the built preset differ from the file."""
    out = []
    for key in FLAGS:
        if key in cfg and hasattr(args, key):
            got = getattr(args, key)
            if got != cfg[key] and not (isinstance(got, float) and abs(got - cfg[key]) < 1e-12):
                out.append(f"{key}: flags give {got!r}, the file {cfg[key]!r}")
    for key in PRESET_KEYS:
        want = cfg.get(CONFIG_KEY.get(key, key))
        if want is not None and getattr(plm, key) != want:
            out.append(f"{key}: the preset gives {getattr(plm, key)!r}, the file {want!r}")
    if plm.vocab_size != cfg["vocab_size"]:
        out.append(f"vocab_size: {plm.vocab_size} against {cfg['vocab_size']}")
    return out
