"""The plain reference of UnBERT reranking: the packed rows made again from
the corpus and the request, both towers and the score head, in float32 (or
in the control's precision, ``reference/precision.py``); inference, no
dropout.

  * packing, a frozen copy of the port's plain packer
    (``miner_tpu_torch/data/unbert_packing.py:UnbertPacker.pack_one``):
    ``[CLS] candidate title [SEP] history titles [SEP]`` in ``seq_len``
    tokens, each title cut to ``news_max_len`` tokens, the first
    ``hist_max_len`` clicks up to the first pad, news-segment ids 1 for the
    candidate and i + 2 for the i-th history news, token types 1 after the
    candidate, sentence ids ``0 .. 2 + n`` over ``3 + hist_max_len``;
  * the word tower: word + position + token type + news segment
    embeddings, LayerNorm, post-LN layers as in ``reference/miner.py``;
  * the news tower over the word tower's states at the sentence ids, masked
    by the sentence mask;
  * the click score: the score head over both CLS states, its second logit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.mind import Corpus, history_row
from reference.precision import Precision
from reference.tokenizer import CLS, PAD, SEP

NEG_INF = -1e9
NUM_NEWS_SEGMENTS = 64


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    D, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    std = cfg["initializer_range"]
    out = [("word_embeddings.weight", (V, D), 0.0, std),
           ("position_embeddings.weight", (cfg["max_position_embeddings"], D), 0.0, std),
           ("token_type_embeddings.weight", (cfg["type_vocab_size"], D), 0.0, std),
           ("news_segment_embeddings.weight", (NUM_NEWS_SEGMENTS, D), 0.0, std),
           ("emb_ln.weight", (D,), 1.0, std), ("emb_ln.bias", (D,), 0.0, std)]
    for tower in ("word_layers", "news_layers"):
        for i in range(cfg["num_hidden_layers"]):
            q = f"{tower}.{i}."
            for name, shape in (("attention.qkv", (3 * D, D)), ("attention.out", (D, D)),
                                ("ffn_in", (F_, D)), ("ffn_out", (D, F_))):
                out.append((q + name + ".weight", shape, 0.0, std))
                out.append((q + name + ".bias", shape[:1], 0.0, std))
            for ln in ("attention_ln", "ffn_ln"):
                out.append((q + ln + ".weight", (D,), 1.0, std))
                out.append((q + ln + ".bias", (D,), 0.0, std))
    out.append(("score_head.weight", (2, 2 * D), 0.0, std))
    out.append(("score_head.bias", (2,), 0.0, std))
    return out


def pack(corpus: Corpus, cfg: Dict, cand: int, history: List[int]) -> Dict[str, np.ndarray]:
    """One packed row of a candidate and a history (news rows, clicks
    first)."""
    L, nm, hm = cfg["seq_len"], cfg["news_max_len"], cfg["hist_max_len"]

    def title(row):
        ids = corpus.tokens(np.array([row]), 1, cfg["max_title_length"])[0]
        return ids[:min(int((ids != PAD).sum()), nm)]

    curr = title(cand)
    hist, segs = [], []
    for i, r in enumerate(history[:hm]):
        if r == 0:
            break
        ids = title(r)
        hist.append(ids)
        segs.append(np.full(len(ids), i + 2, np.int64))
    n_sent = 3 + len(hist)
    flat = np.concatenate(hist) if hist else np.zeros(0, np.int64)
    seg = np.concatenate(segs) if segs else np.zeros(0, np.int64)
    flat, seg = flat[:L - len(curr) - 3], seg[:L - len(curr) - 3]
    n = len(curr) + len(flat) + 3
    ids = np.full(L, PAD, np.int64)
    ids[0] = CLS
    ids[1:1 + len(curr)] = curr
    ids[1 + len(curr)] = SEP
    ids[2 + len(curr):2 + len(curr) + len(flat)] = flat
    ids[n - 1] = SEP
    mask = (np.arange(L) < n).astype(np.int64)
    types = np.zeros(L, np.int64)
    types[2 + len(curr):n] = 1
    news_seg = np.zeros(L, np.int64)
    news_seg[1:1 + len(curr)] = 1
    news_seg[2 + len(curr):2 + len(curr) + len(seg)] = seg
    S = 3 + hm
    sent_ids = np.zeros(S, np.int64)
    sent_ids[:n_sent] = np.arange(n_sent)
    sent_mask = (np.arange(S) < n_sent).astype(np.int64)
    return {"input_ids": ids, "input_mask": mask, "segment_ids": types,
            "news_segment_ids": news_seg, "sentence_ids": sent_ids, "sentence_mask": sent_mask}


class UnbertReference:
    def __init__(self, cfg: Dict, corpus: Corpus, params: Dict[str, torch.Tensor],
                 precision: Precision):
        self.cfg, self.corpus, self.p, self.prec = cfg, corpus, params, precision
        self.device = next(iter(params.values())).device

    def _layers(self, tower: str, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        cfg, p, prec = self.cfg, self.p, self.prec
        n, L, D = x.shape
        H, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
        keys = valid.bool()[:, None, None, :]
        act = "tanh" if cfg["gelu_approx"] else "none"
        for i in range(cfg["num_hidden_layers"]):
            q = f"{tower}.{i}."
            qkv = prec.linear(x, p[q + "attention.qkv.weight"], p[q + "attention.qkv.bias"])
            qh, kh, vh = (qkv[..., c * D:(c + 1) * D].reshape(n, L, H, D // H).transpose(1, 2)
                          for c in range(3))
            s = prec.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D // H))
            probs = prec.act(torch.softmax(torch.where(keys, s, NEG_INF), dim=-1))
            ctx = prec.matmul(probs, vh).transpose(1, 2).reshape(n, L, D)
            h = prec.linear(ctx, p[q + "attention.out.weight"], p[q + "attention.out.bias"])
            x = prec.act(F.layer_norm(x + h, (D,), p[q + "attention_ln.weight"],
                                      p[q + "attention_ln.bias"], eps))
            h = prec.act(F.gelu(prec.linear(x, p[q + "ffn_in.weight"], p[q + "ffn_in.bias"]),
                                approximate=act))
            h = prec.linear(h, p[q + "ffn_out.weight"], p[q + "ffn_out.bias"])
            x = prec.act(F.layer_norm(x + h, (D,), p[q + "ffn_ln.weight"],
                                      p[q + "ffn_ln.bias"], eps))
        return x

    @torch.no_grad()
    def scores(self, rows: List[Dict[str, np.ndarray]]) -> torch.Tensor:
        """(R,) float32 click scores of packed rows."""
        p, cfg = self.p, self.cfg
        f = {k: torch.as_tensor(np.stack([r[k] for r in rows]), device=self.device)
             for k in rows[0]}
        L = f["input_ids"].shape[1]
        x = (p["word_embeddings.weight"][f["input_ids"]]
             + p["position_embeddings.weight"][torch.arange(L, device=self.device)][None]
             + p["token_type_embeddings.weight"][f["segment_ids"]]
             + p["news_segment_embeddings.weight"][f["news_segment_ids"]])
        x = self.prec.act(F.layer_norm(x, x.shape[-1:], p["emb_ln.weight"], p["emb_ln.bias"],
                                       cfg["layer_norm_eps"]))
        x = self._layers("word_layers", x, f["input_mask"])
        idx = f["sentence_ids"][..., None].expand(-1, -1, x.shape[-1])
        y = self._layers("news_layers", torch.gather(x, 1, idx), f["sentence_mask"])
        logits = self.prec.linear(torch.cat([x[:, 0], y[:, 0]], dim=-1),
                                  p["score_head.weight"], p["score_head.bias"])
        return logits[:, 1]


def score_requests(ref: UnbertReference, bodies: List[Dict]) -> np.ndarray:
    """The reference's scores of every candidate of the requests (history and
    candidates, news ids), request after request, in 64-row blocks."""
    corpus, cfg = ref.corpus, ref.cfg
    rows = []
    for body in bodies:
        his = history_row([corpus.row_of[n] for n in body["history"]], cfg["his_length"])
        rows += [pack(corpus, cfg, corpus.row_of[n], his.tolist()) for n in body["candidates"]]
    if not rows:
        return np.zeros(0)
    return torch.cat([ref.scores(rows[k:k + 64]) for k in range(0, len(rows), 64)]
                     ).cpu().double().numpy()


def readings(ref: UnbertReference, bodies: List[Dict], replies: List[List]) -> Dict:
    """The numbers that decide ``correct`` for replies to requests (``bodies``:
    history and candidates, news ids; ``replies``: the served (id, score)
    list, best first): every candidate packed and scored again; the largest
    and the root-mean-square gap of the served scores, against the spread
    (standard deviation) of the reference's scores; and the replies whose
    order is not their own scores' (best first)."""
    want = score_requests(ref, bodies)
    served, unsorted = [], 0
    for body, results in zip(bodies, replies):
        score_of = dict((n, s) for n, s in results)
        served += [score_of[n] for n in body["candidates"]]
        scores = [s for _, s in results]
        unsorted += any(a < b for a, b in zip(scores, scores[1:]))
    if not len(want):
        return {"score_gap": 0.0, "score_rms_gap": 0.0, "unsorted_replies": unsorted, "rows": 0}
    scale = float(np.std(want)) or 1.0
    gap = np.abs(np.asarray(served, np.float64) - want)
    return {"score_gap": float(gap.max()) / scale,
            "score_rms_gap": float(np.sqrt(np.mean(gap ** 2))) / scale,
            "unsorted_replies": unsorted, "rows": len(want)}
