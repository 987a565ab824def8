"""Offline data preparation for MIND-style corpora, the port's copy.

The JAX package's ``tools/prepare_mind.py`` over ``miner_tpu_torch.constants``
(the same flags, byte-equal output files): builds train/valid splits from
raw MIND ``behaviors.tsv`` + ``news.tsv`` (raw MIND's column order or the
reference's derived one, told apart by the columns), filters to lines with
a click history, samples a fixed-size validation split, and writes the
``user2id.json`` / ``category2id.json`` maps (with ``unk`` / ``pad``
entries) the trainer expects.

    python -m miner_tpu_torch.tools.prepare_mind \
        --raw_behaviors MINDsmall_train/behaviors.tsv \
        --raw_news MINDsmall_train/news.tsv \
        --out_dir data --valid_impressions 2500 --seed 36
"""
from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from miner_tpu_torch import constants


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_behaviors", required=True)
    ap.add_argument("--raw_news", required=True)
    ap.add_argument("--out_dir", default="data")
    ap.add_argument("--valid_impressions", type=int, default=2500)
    ap.add_argument("--min_history", type=int, default=1,
                    help="drop lines with shorter click history")
    ap.add_argument("--seed", type=int, default=36)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)

    # --- news passthrough (normalize column count, collect categories) -----
    categories = set()
    news_rows = []
    with open(args.raw_news, newline="", encoding="utf-8") as f:
        for line in csv.reader(f, delimiter="\t"):
            if not line:
                continue
            nid = line[constants.NEWS_ID]
            title = line[constants.TITLE] if len(line) > constants.TITLE else ""
            # raw MIND column order: id, category, subcategory, title, abstract
            # the reference's derived format: id, title, category, sapo —
            # detect raw MIND by its known category vocab position heuristic:
            if len(line) >= 5 and " " not in line[1] and " " in line[3]:
                category, title, sapo = line[1], line[3], line[4]
            else:
                category = line[constants.CATEGORY] if len(line) > 2 else "unk"
                sapo = line[constants.SAPO] if len(line) > 3 else ""
            categories.add(category)
            news_rows.append((nid, title, category, sapo))

    # --- behaviors filtering + split ---------------------------------------
    lines = []
    users = set()
    with open(args.raw_behaviors, newline="", encoding="utf-8") as f:
        for line in csv.reader(f, delimiter="\t"):
            if len(line) <= constants.BEHAVIOR:
                continue
            history = line[constants.HISTORY].split()
            behaviors = line[constants.BEHAVIOR].split()
            if len(history) < args.min_history or not behaviors:
                continue
            lines.append(line)
            users.add(line[constants.USER_ID])

    order = rng.permutation(len(lines))
    n_valid = min(args.valid_impressions, len(lines) // 10)
    valid_idx = set(order[:n_valid].tolist())

    def write_split(name, idxs):
        d = os.path.join(args.out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "behaviors.tsv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.writer(f, delimiter="\t")
            for i in idxs:
                w.writerow(lines[i])
        with open(os.path.join(d, "news.tsv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.writer(f, delimiter="\t")
            for row in news_rows:
                w.writerow(row)

    write_split("train", [i for i in range(len(lines)) if i not in valid_idx])
    write_split("valid", sorted(valid_idx))

    user2id = {constants.UNK_TOKEN: 0}
    for u in sorted(users):
        user2id[u] = len(user2id)
    category2id = {constants.PAD_TOKEN: 0, constants.UNK_TOKEN: 1}
    for c in sorted(categories):
        category2id[c] = len(category2id)
    with open(os.path.join(args.out_dir, "user2id.json"), "w") as f:
        json.dump(user2id, f)
    with open(os.path.join(args.out_dir, "category2id.json"), "w") as f:
        json.dump(category2id, f)

    print(f"wrote {len(lines) - n_valid} train / {n_valid} valid impressions, "
          f"{len(news_rows)} news, {len(user2id)} users, "
          f"{len(category2id)} categories -> {args.out_dir}")


if __name__ == "__main__":
    main()
