"""The work an operation needs at a cell's shapes, whatever kernel does it.

Operations and bytes are counted from the shapes the configuration and the
traffic fix, as the roofline guide asks: each input read once and each
output written once, at the compute type's width. Model FLOPs count each
product as 2 x m x n x k, the forward once and the backward twice; a
recompute (``--remat``) is not model work and is left out of them, and kept
in the products' bound, which the device really has to run.

The peaks are the table in ``benchmark/peaks.json`` (NVIDIA's data sheet of
the H100 SXM, dense rates); ``bound_s`` is the roofline arithmetic of
``chip_smoke.py:bound_ms``: the larger of operations over the peak rate and
bytes over the memory bandwidth.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "peaks.json")


def peaks() -> Dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def peak_flops(dtype: str) -> float:
    return float(peaks()["flops_per_s"][dtype])


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time the chip could take, and which of the two bounds it."""
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / float(peaks()["hbm_bytes_per_s"])
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def layer_dense_flops(cfg: Dict) -> float:
    """FLOPs of one token through one transformer layer's four products
    (qkv, out, ffn in and out), forward."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    return 2.0 * (D * 3 * D + D * D + 2 * D * F)


def attention_flops(cfg: Dict, L: int) -> float:
    """FLOPs of one sequence of ``L`` through one layer's attention
    (scores and context, every head), forward."""
    return 4.0 * L * L * cfg["hidden_size"]


def tower_flops(cfg: Dict, L: int, layers: int) -> float:
    """Forward FLOPs of one sequence of ``L`` tokens through ``layers``
    layers."""
    return layers * (L * layer_dense_flops(cfg) + attention_flops(cfg, L))


def miner_news_flops(cfg: Dict) -> float:
    """Forward FLOPs of one news through the Miner's news encoder: title and
    abstract towers, reduce_dim, the linear combine."""
    n = cfg["num_hidden_layers"]
    W, D = cfg["word_embed_dim"], cfg["hidden_size"]
    return (tower_flops(cfg, cfg["max_title_length"], n)
            + tower_flops(cfg, cfg["max_sapo_length"], n)
            + 2 * 2.0 * D * W + 2.0 * 2 * W * W)


def miner_micro_batch_flops(cfg: Dict) -> float:
    """Model FLOPs of one training micro-batch (forward + 2x backward) of
    the news encoder over its candidates and history; the tail (poly
    attention, scoring: under 0.1% of it) is left out, as ``bench.py``'s
    formula leaves it out."""
    news = cfg["train_batch_size"] * (1 + cfg["npratio"] + cfg["his_length"])
    return 3.0 * news * miner_news_flops(cfg)


def miner_products(cfg: Dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of the news encoder's products in one training
    micro-batch at the configuration's flags: the layers' four products,
    forward, backward (input and weight gradients), and under ``remat`` the
    forward again; bf16 operands. The smaller products (reduce_dim, the
    combine, the tail's) are left out."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    news = cfg["train_batch_size"] * (1 + cfg["npratio"] + cfg["his_length"])
    passes = 4 if cfg.get("remat") else 3  # forward, recompute, two gradients
    flops = nbytes = 0.0
    for L in (cfg["max_title_length"], cfg["max_sapo_length"]):
        m = news * L
        for k, n in ((D, 3 * D), (D, D), (D, F), (F, D)):
            per = 2.0 * m * k * n * cfg["num_hidden_layers"]
            flops += passes * per
            # each pass reads two operands and writes one
            io = 2.0 * (m * k + k * n + m * n) * cfg["num_hidden_layers"]
            nbytes += passes * io
    return flops, nbytes


def mha_work(cfg: Dict, sequences: float, L: int) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of the attention operation over ``sequences``
    sequences of ``L`` in one layer stack, forward and backward apart. The
    forward reads qkv and the key mask and writes the context; the backward
    reads qkv, the key mask and the context's gradient and writes qkv's
    gradient, with twice the forward's products (the probabilities' and
    values' gradients, then the queries' and keys'); bf16."""
    D, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    ops = attention_flops(cfg, L) * sequences * layers
    return {"forward": (ops, (2.0 * 4 * L * D + 4 * L) * sequences * layers),
            "backward": (2 * ops, (2.0 * 7 * L * D + 4 * L) * sequences * layers)}


def unbert_row_flops(cfg: Dict) -> float:
    """Forward FLOPs of one packed UnBERT row: the word tower at
    ``seq_len``, the news tower at ``3 + hist_max_len`` sentences, the head."""
    n = cfg["num_hidden_layers"]
    return (tower_flops(cfg, cfg["seq_len"], n)
            + tower_flops(cfg, 3 + cfg["hist_max_len"], n)
            + 2.0 * 2 * cfg["hidden_size"] * 2)
