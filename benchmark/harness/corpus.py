"""A MIND-format corpus made from a seed and a traffic file's parameters.

The benchmark's own generator, after the port's seeded corpora
(``chip_smoke.py:write_corpus`` / ``write_behaviors`` and
``miner_tpu_torch/tools/synth_mind.py``), rewritten so that every size is a
parameter of the traffic file: the number of news, impressions and users,
the word counts of titles and abstracts, history lengths and impression
sizes. The files are the reference's layout (``news.tsv``: id, title,
category, abstract; ``behaviors.tsv``: impression id, user, time, history,
impressions), with ``user2id.json`` and ``category2id.json``.

Words are ``w<k>`` drawn from a Zipf law over the vocabulary, so that the
hash tokenizer sees a realistic spread of ids. Every draw comes from one
``numpy.random.default_rng(seed)``, in bulk: the same seed gives the same
bytes, another seed another corpus of the same sizes.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

# MIND's 17 top-level categories
CATEGORIES = ("news", "sports", "finance", "foodanddrink", "lifestyle", "travel",
              "video", "weather", "health", "autos", "tv", "music", "movies",
              "entertainment", "kids", "middleeast", "northamerica")


def _lengths(rng, spec: Dict, n: int) -> np.ndarray:
    """``n`` word counts: a log-normal of median ``median`` and shape
    ``sigma``, rounded and clipped to [``min``, ``max``]."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _texts(rng, lengths: np.ndarray, vocab: int, zipf: float) -> list:
    """One string of ``w<k>`` words per length, the words Zipf-distributed."""
    total = int(lengths.sum())
    ranks = rng.zipf(zipf, total) % vocab
    words = np.char.add("w", ranks.astype(str))
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    return [" ".join(words[bounds[i]:bounds[i + 1]]) for i in range(len(lengths))]


def news_ids(n: int) -> list:
    return [f"N{i}" for i in range(n)]


def write_corpus(root: str, params: Dict, seed: int) -> Dict[str, str]:
    """Write the corpus of ``params`` (a traffic file's ``corpus`` block) under
    ``root``; returns the paths by name."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    n_news = int(params["news"])
    vocab, zipf = int(params["vocab_words"]), float(params["zipf"])
    titles = _texts(rng, _lengths(rng, params["title_words"], n_news), vocab, zipf)
    abstracts = _texts(rng, _lengths(rng, params["abstract_words"], n_news), vocab, zipf)
    cats = rng.integers(0, len(CATEGORIES), n_news)
    ids = news_ids(n_news)
    paths = {"news": os.path.join(root, "news.tsv"),
             "behaviors": os.path.join(root, "behaviors.tsv"),
             "user2id": os.path.join(root, "user2id.json"),
             "category2id": os.path.join(root, "category2id.json")}
    with open(paths["news"], "w", encoding="utf-8") as f:
        f.write("".join(f"{ids[i]}\t{titles[i]}\t{CATEGORIES[cats[i]]}\t{abstracts[i]}\n"
                        for i in range(n_news)))

    n_imp, n_users = int(params["impressions"]), int(params["users"])
    his_len = _lengths(rng, params["history"], n_imp)
    pos_n = rng.integers(params["positives"][0], params["positives"][1] + 1, n_imp)
    neg_n = rng.integers(params["negatives"][0], params["negatives"][1] + 1, n_imp)
    users = rng.integers(0, n_users, n_imp)
    # every news of a line distinct: history, positives and negatives
    lines = []
    for i in range(n_imp):
        picks = rng.choice(n_news, int(his_len[i] + pos_n[i] + neg_n[i]), replace=False)
        h, p = int(his_len[i]), int(pos_n[i])
        shown = [f"{ids[r]}-1" for r in picks[h:h + p]] + [f"{ids[r]}-0" for r in picks[h + p:]]
        order = rng.permutation(len(shown))
        lines.append(f"{i}\tU{users[i]}\t11/11/2019 9:05:58 AM\t"
                     f"{' '.join(ids[r] for r in picks[:h])}\t"
                     f"{' '.join(shown[j] for j in order)}\n")
    with open(paths["behaviors"], "w", encoding="utf-8") as f:
        f.write("".join(lines))
    with open(paths["user2id"], "w") as f:
        json.dump({"unk": 0, **{f"U{u}": u + 1 for u in range(n_users)}}, f)
    with open(paths["category2id"], "w") as f:
        json.dump({"pad": 0, "unk": 1, **{c: i + 2 for i, c in enumerate(CATEGORIES)}}, f)
    return paths
