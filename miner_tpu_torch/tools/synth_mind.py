"""The planted synthetic MIND-format corpus, the port's own copy.

The same generator as the JAX package's ``tools/synth_mind.py``
(``make_synth_mind``: same signature, same draws, byte-equal files for the
same arguments), kept here so that the port's end-to-end tools
(``scale_convergence``, ``quality_run``) make their corpus without
importing anything outside the port. It is numpy only.

A corpus of ``n_topics`` topics, each with a disjoint topical vocabulary;
titles and abstracts mix topical words with shared filler words; each user
prefers 2 topics, histories are drawn from them (plus noise), impression
positives are preferred-topic news and negatives other-topic news, with
label noise. It writes the reference's file layout: ``news.tsv``,
``behaviors.tsv``, ``eval_behaviors.tsv``, ``user2id.json`` and
``category2id.json`` (with ``unk`` and ``pad``). A model that learns topic
matching from titles and history reaches an auc far above 0.5; a broken
training path stays near chance.

    python -m miner_tpu_torch.tools.synth_mind --out /tmp/synth \
        --news 60000 --users 5000 --train_lines 50000 --eval_lines 5000 \
        --hist_len 30 50

(the at-scale corpus of ``scale_convergence``).
"""
from __future__ import annotations

import json
import os

import numpy as np

TOPICS = ["finance", "sports", "tech", "politics", "health", "movies",
          "travel", "food"]

_FILLER = ("today report update new latest big top best first more after "
           "breaking says week year world live full video watch").split()


def _topic_vocab(t: int, words_per_topic: int = 40):
    return [f"{TOPICS[t]}word{k}" for k in range(words_per_topic)]


def make_synth_mind(root: str, n_news: int = 1200, n_users: int = 300,
                    n_train_lines: int = 4000, n_eval_lines: int = 800,
                    n_topics: int = 8, hist_len: tuple = (6, 12),
                    n_neg: tuple = (6, 9), label_noise: float = 0.1,
                    seed: int = 11, topics=None) -> str:
    """``topics``: explicit topic indices (into TOPICS) to build the corpus
    from, e.g. ``[0, 1, 2, 3]`` vs ``[4, 5, 6, 7]`` for two corpora with
    DISJOINT topic mixtures (domain-shift experiments: each topic has its
    own disjoint topical vocabulary). Overrides ``n_topics``. Default: the
    first ``n_topics`` topics (unchanged behavior)."""
    topic_list = (list(topics) if topics is not None
                  else list(range(n_topics)))
    n_topics = len(topic_list)
    assert all(0 <= t < len(TOPICS) for t in topic_list)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    vocabs = [_topic_vocab(t) for t in topic_list]

    def title(topic: int, n_words: int) -> str:
        k_topical = max(1, int(round(n_words * 0.7)))
        words = list(rng.choice(vocabs[topic], size=k_topical)) + list(
            rng.choice(_FILLER, size=n_words - k_topical)
        )
        rng.shuffle(words)
        return " ".join(words)

    news_topic = rng.integers(0, n_topics, size=n_news)
    news_topic[:n_topics] = np.arange(n_topics)  # every topic non-empty
    news_ids = [f"N{i}" for i in range(n_news)]
    with open(os.path.join(root, "news.tsv"), "w", encoding="utf-8") as f:
        for i, nid in enumerate(news_ids):
            t = int(news_topic[i])
            f.write(f"{nid}\t{title(t, int(rng.integers(6, 12)))}\t"
                    f"{TOPICS[topic_list[t]]}\t"
                    f"{title(t, int(rng.integers(10, 18)))}\n")

    by_topic = [np.flatnonzero(news_topic == t) for t in range(n_topics)]
    user_pref = rng.integers(0, n_topics, size=(n_users, 2))

    def pick(topics, k):
        pool = np.concatenate([by_topic[t] for t in np.atleast_1d(topics)])
        return rng.choice(pool, size=k, replace=k > len(pool))

    def write_behaviors(path: str, n_lines: int, start_id: int) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for j in range(n_lines):
                u = int(rng.integers(0, n_users))
                prefs = user_pref[u]
                h = int(rng.integers(hist_len[0], hist_len[1] + 1))
                hist_rows = pick(prefs, h)
                # ~15% history noise from random topics
                noise = rng.random(h) < 0.15
                if noise.any():
                    hist_rows[noise] = rng.integers(0, n_news, size=noise.sum())
                hist = " ".join(news_ids[r] for r in hist_rows)

                n_pos = int(rng.integers(1, 3))
                k_neg = int(rng.integers(n_neg[0], n_neg[1] + 1))
                pos_rows = pick(prefs, n_pos)
                other = [t for t in range(n_topics) if t not in prefs]
                neg_rows = pick(other, k_neg)
                cands = np.concatenate([pos_rows, neg_rows])
                labels = np.concatenate(
                    [np.ones(n_pos, int), np.zeros(k_neg, int)]
                )
                flip = rng.random(len(labels)) < label_noise
                # keep >= 5 negatives after noise: the reference's
                # category-bias path NaNs on pad candidates (zero-norm pad
                # category embedding, src/utils.py:21-23), which appear
                # whenever an impression has fewer than npratio negatives
                neg_flips = np.flatnonzero(flip & (labels == 0))
                excess = len(neg_flips) - max(0, k_neg - 5)
                if excess > 0:
                    flip[rng.choice(neg_flips, size=excess, replace=False)] = False
                labels = np.where(flip, 1 - labels, labels)
                if labels.sum() == 0:
                    labels[0] = 1
                if labels.sum() == len(labels):
                    labels[-1] = 0
                order = rng.permutation(len(cands))
                beh = " ".join(
                    f"{news_ids[cands[i]]}-{labels[i]}" for i in order
                )
                f.write(f"{start_id + j}\tU{u}\t11/11/2019 9:05:58 AM\t"
                        f"{hist}\t{beh}\n")

    write_behaviors(os.path.join(root, "behaviors.tsv"), n_train_lines, 0)
    write_behaviors(os.path.join(root, "eval_behaviors.tsv"), n_eval_lines,
                    n_train_lines)

    user2id = {"unk": 0}
    for i in range(n_users):
        user2id[f"U{i}"] = i + 1
    category2id = {"pad": 0, "unk": 1}
    for i in range(n_topics):
        category2id[TOPICS[topic_list[i]]] = i + 2
    with open(os.path.join(root, "user2id.json"), "w") as f:
        json.dump(user2id, f)
    with open(os.path.join(root, "category2id.json"), "w") as f:
        json.dump(category2id, f)
    return root


def main(argv=None) -> str:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default="synth_mind",
                    help="output directory (the JAX tool's one argument)")
    ap.add_argument("--news", type=int, default=1200)
    ap.add_argument("--users", type=int, default=300)
    ap.add_argument("--train_lines", type=int, default=4000)
    ap.add_argument("--eval_lines", type=int, default=800)
    ap.add_argument("--hist_len", type=int, nargs=2, default=(6, 12),
                    metavar=("MIN", "MAX"), help="history length range, inclusive")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--topics", type=int, nargs="+", default=None,
                    help="topic indices into TOPICS (default: the first 8)")
    args = ap.parse_args(argv)
    make_synth_mind(args.out, n_news=args.news, n_users=args.users,
                    n_train_lines=args.train_lines, n_eval_lines=args.eval_lines,
                    hist_len=tuple(args.hist_len), seed=args.seed, topics=args.topics)
    print("done")
    return args.out


if __name__ == "__main__":
    main()
