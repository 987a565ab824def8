"""BehaviorsLog: parsed behaviors.tsv as index arrays into a NewsStore.

Replaces the reference's per-line Python-object parsing (reference:
src/reader.py:135-379) with flat numpy storage:

  * history is padded to a fixed H. **The reference PREPENDS pad news**:
    every parse mode builds ``[pad] * (H - len) + clicks[:H]`` (reference:
    src/reader.py:154, 204, 268, 319, 369, 405), so clicks sit at the TAIL
    of the row and the first slots are pad for any user with fewer than H
    clicks.  Our default is a **deliberate deviation**: clicks FIRST, pad
    appended.  The reference's pads-first layout starves every
    position-sensitive consumer — its UnBERT packer reads the first
    ``hist_max_len=20`` slots (all pads whenever clicks ≤ H−20, i.e. most
    users at the canonical H=50), its UniSRec user vector is position 0
    (the pad news for short histories), and its Fastformer learned
    positions shift with history length.  ``legacy_layout=True``
    (``--legacy_history_layout``) reproduces the reference's pads-first
    rows bit-faithfully end-to-end — required when importing/exporting
    reference checkpoints for position-sensitive models (UnBERT, UniSRec,
    Fastformer).  Truncation keeps the first (earliest) H clicks in both
    layouts (reference: src/reader.py:154 ``clicks[:max]``);
  * one *event* per positive click (train) carrying the positive's row and
    the impression's negative rows (ragged, stored flat + offsets);
  * eval keeps one group per impression with all candidate rows and labels,
    filtered to impressions containing both a positive and a negative
    (reference: src/reader.py:374).

Impression ids are the 0-based line number in behaviors.tsv, matching the
reference's ``enumerate`` ids (reference: src/reader.py:29-36).

The port's own copy of ``miner_tpu/data/behaviors.py``
(the port imports nothing of the JAX package); the tests hold the two
equal.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from miner_tpu_torch import constants
from miner_tpu_torch.data.news_store import NewsStore


@dataclasses.dataclass
class BehaviorsLog:
    # Per-event (train): one row per positive click.
    user: np.ndarray  # (E,) int32
    history: np.ndarray  # (E_u, H) int32 news rows (0 = pad); indexed via hist_ptr
    hist_ptr: np.ndarray  # (E,) int32 -> row in history (events of one line share)
    pos_row: np.ndarray  # (E,) int32 positive news row
    impression_id: np.ndarray  # (E,) int32
    neg_flat: np.ndarray  # (sum_neg,) int32 negatives, flattened
    neg_offsets: np.ndarray  # (E+1,) int32; negatives of event e = neg_flat[o[e]:o[e+1]]

    # Per-impression (eval): groups of candidates with labels.
    eval_hist_ptr: np.ndarray  # (I,) int32
    eval_user: np.ndarray  # (I,) int32
    eval_impression_id: np.ndarray  # (I,) int32
    eval_cand_flat: np.ndarray  # (sum_cand,) int32
    eval_label_flat: np.ndarray  # (sum_cand,) int8
    eval_offsets: np.ndarray  # (I+1,) int32

    max_his_click: int
    legacy_layout: bool = False  # pads-first rows (the reference's layout)

    @property
    def num_events(self) -> int:
        return len(self.pos_row)

    @property
    def num_eval_impressions(self) -> int:
        return len(self.eval_user)

    def negatives(self, event: int) -> np.ndarray:
        return self.neg_flat[self.neg_offsets[event] : self.neg_offsets[event + 1]]

    def eval_group(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        sl = slice(self.eval_offsets[i], self.eval_offsets[i + 1])
        return self.eval_cand_flat[sl], self.eval_label_flat[sl]

    def eval_targets_by_impression(self) -> Dict[int, List[int]]:
        return {
            int(self.eval_impression_id[i]): [int(x) for x in self.eval_group(i)[1]]
            for i in range(self.num_eval_impressions)
        }

    @staticmethod
    def from_tsv(
        behaviors_path: str,
        store: NewsStore,
        user2id: Dict[str, int],
        max_his_click: int,
        require_negative: bool = True,
        legacy_layout: bool = False,
    ) -> "BehaviorsLog":
        unk_user = user2id.get(constants.UNK_TOKEN, 0)

        users: List[int] = []
        hist_rows: List[np.ndarray] = []
        hist_ptrs: List[int] = []
        pos_rows: List[int] = []
        imp_ids: List[int] = []
        neg_flat: List[int] = []
        neg_offsets: List[int] = [0]

        e_hist_ptr: List[int] = []
        e_user: List[int] = []
        e_imp: List[int] = []
        e_cand: List[int] = []
        e_label: List[int] = []
        e_offsets: List[int] = [0]

        with open(behaviors_path, newline="", encoding="utf-8") as f:
            for line_no, line in enumerate(csv.reader(f, delimiter="\t")):
                if not line:
                    continue
                uid = user2id.get(line[constants.USER_ID], unk_user)
                hist_ids = line[constants.HISTORY].split()
                hist = np.zeros(max_his_click, dtype=np.int32)  # 0 = pad row
                # unknown ids are dropped (NOT mapped to the pad row in
                # place): a 0 inside the click region would break the
                # clicks-first-contiguous invariant the packers and
                # position-sensitive models rely on
                rows = [r for r in (store.id_to_row.get(h) for h in hist_ids)
                        if r is not None and r != 0]
                # Default: clicks FIRST (pads appended), earliest-H
                # truncation — a DELIBERATE deviation from the reference,
                # which PREPENDS pads: [pad]*(H−len) + clicks[:H]
                # (reference: src/reader.py:154, 204, 268, 319, 369, 405).
                # Clicks-first un-starves the position-sensitive consumers
                # (UniSRec's position-0 user vector, Fastformer's learned
                # positions, UnBERT packing's first-hist_max slice).
                # legacy_layout reproduces the reference's pads-first rows
                # for bit-faithful checkpoint transfer (see module doc).
                kept = rows[:max_his_click]
                if legacy_layout:
                    hist[max_his_click - len(kept):] = kept
                else:
                    hist[: len(kept)] = kept
                hist_idx = len(hist_rows)
                hist_rows.append(hist)

                behaviors = line[constants.BEHAVIOR].split()
                pos, neg = [], []
                for b in behaviors:
                    nid, _, label = b.rpartition("-")
                    row = store.id_to_row.get(nid, 0)
                    (pos if label == "1" else neg).append(row)

                # Train events: one per positive; skip lines without negatives
                # (reference: src/reader.py:171-172).
                if pos and (neg or not require_negative):
                    for p in pos:
                        users.append(uid)
                        hist_ptrs.append(hist_idx)
                        pos_rows.append(p)
                        imp_ids.append(line_no)
                        neg_flat.extend(neg)
                        neg_offsets.append(len(neg_flat))

                # Eval groups: impressions with both classes
                # (reference: src/reader.py:374).
                if pos and neg:
                    e_hist_ptr.append(hist_idx)
                    e_user.append(uid)
                    e_imp.append(line_no)
                    for b in behaviors:
                        nid, _, label = b.rpartition("-")
                        e_cand.append(store.id_to_row.get(nid, 0))
                        e_label.append(int(label))
                    e_offsets.append(len(e_cand))

        return BehaviorsLog(
            user=np.asarray(users, dtype=np.int32),
            history=np.stack(hist_rows) if hist_rows else np.zeros((0, max_his_click), np.int32),
            hist_ptr=np.asarray(hist_ptrs, dtype=np.int32),
            pos_row=np.asarray(pos_rows, dtype=np.int32),
            impression_id=np.asarray(imp_ids, dtype=np.int32),
            neg_flat=np.asarray(neg_flat, dtype=np.int32),
            neg_offsets=np.asarray(neg_offsets, dtype=np.int32),
            eval_hist_ptr=np.asarray(e_hist_ptr, dtype=np.int32),
            eval_user=np.asarray(e_user, dtype=np.int32),
            eval_impression_id=np.asarray(e_imp, dtype=np.int32),
            eval_cand_flat=np.asarray(e_cand, dtype=np.int32),
            eval_label_flat=np.asarray(e_label, dtype=np.int8),
            eval_offsets=np.asarray(e_offsets, dtype=np.int32),
            max_his_click=max_his_click,
            legacy_layout=legacy_layout,
        )
