"""The serving half of the JAX package's ``Trainer``, in PyTorch.

Counterpart of ``miner_tpu/training/trainer.py`` for what ``serve`` and
``recommend`` run: ``build_model`` for ``Miner``, ``_make_table``,
``serving_context`` (news store, model, and the corpus news-embedding cache,
encoded once), ``_make_cached_scores_fn`` (category bias, poly-attention
interests, the lookup+score op, target-aware aggregation), ``serve_scores``
for slates and ``serve_topk`` for whole-corpus ranking with ``torch.topk``.

The model runs on ``--device`` (default ``cuda``; asking for a card that is
not there raises). On the card every op of the path launches its kernel; on
the CPU the ops run their plain versions, which is what the tests use.
Training, checkpoints and the int8 cache come with later slices of the port
(ROADMAP, Queue 1): the flags that need them are refused here.
"""
from __future__ import annotations

import json
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from miner_tpu_torch import constants
from miner_tpu_torch.config import plm_config
from miner_tpu_torch.data.device_table import NewsTable
from miner_tpu_torch.data.news_store import NewsStore
from miner_tpu_torch.data.tokenization import load_tokenizer
from miner_tpu_torch.models import Miner, NewsEncoder
from miner_tpu_torch.models.plm import cast_to_compute_
from miner_tpu_torch.ops.lookup_score import lookup_score_fused
from miner_tpu_torch.parallel.news_cache import (
    CacheFiller,
    NewsEmbeddingCache,
    gather_rows,
)
from miner_tpu_torch.serving import history_row
from miner_tpu_torch.utils import candidate_bucket, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ServingContext(NamedTuple):
    """One-time setup shared by ``recommend`` and the HTTP scoring server."""

    store: NewsStore
    table: NewsTable
    model: Miner
    cache: NewsEmbeddingCache


def _refuse_unported(args, device: torch.device) -> None:
    """Raise for a flag whose meaning this slice of the port cannot honour,
    naming the ROADMAP item that brings it, instead of serving something
    else than was asked for."""
    if (args.model_name or "Miner").lower() != "miner":
        raise NotImplementedError(
            f"--model_name {args.model_name!r}: the port serves Miner only "
            "so far (ROADMAP Queue 1, items 7-9: the Fastformer, UnBERT "
            "and UniSRec families)")
    if args.saved_model_path:
        raise NotImplementedError(
            "--saved_model_path: the JAX package's Orbax checkpoints cannot "
            "be read without its JAX stack; port-format checkpoints come "
            "with the training slice (ROADMAP Queue 1, item 1)")
    if args.serve_cache_int8:
        raise NotImplementedError(
            "--serve_cache_int8: the int8 cache (Int8Rows) is not ported "
            "yet (ROADMAP Queue 1, item 3)")
    if args.fused_kernels is False and device.type == "cuda":
        raise ValueError(
            "--no-fused_kernels with a CUDA device: on the card the serving "
            "path always runs the port's kernels (the plain versions run "
            "on --device cpu)")


class Trainer:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        _refuse_unported(args, self.device)
        self.tokenizer = load_tokenizer(args.pretrained_tokenizer)
        with open(args.category2id_path) as f:
            self.category2id = json.load(f)
        self.compute_dtype = _DTYPES[args.compute_dtype]
        self._legacy_layout = bool(args.legacy_history_layout)

    # ------------------------------------------------------------------ data
    def _load_store(self, news_path: str) -> NewsStore:
        return NewsStore.from_tsv(news_path, self.tokenizer, self.category2id,
                                  self.args.max_title_length,
                                  self.args.max_sapo_length)

    def _make_table(self, store: NewsStore) -> NewsTable:
        return NewsTable.from_store(store, use_sapo=self.args.use_sapo,
                                    combine_type=self.args.combine_type,
                                    device=self.device)

    # ----------------------------------------------------------------- model
    def build_model(self) -> Miner:
        """The Miner with fresh weights from ``--seed``, fp32, on the CPU
        (so the same seed gives the same weights on any device)."""
        a = self.args
        gelu_approx = a.gelu_approx
        if gelu_approx is None:
            gelu_approx = self.compute_dtype == torch.bfloat16
        plm = plm_config(a.plm_preset, vocab_size=self.tokenizer.vocab_size,
                         gelu_approx=gelu_approx)
        encoder = NewsEncoder(plm, apply_reduce_dim=a.apply_reduce_dim,
                              word_embed_dim=a.word_embed_dim,
                              use_sapo=a.use_sapo, combine_type=a.combine_type)
        category_embed = None
        if a.category_embed_path:
            category_embed = np.load(a.category_embed_path)
        model = Miner(
            encoder,
            use_category_bias=a.use_category_bias,
            num_context_codes=a.num_context_codes,
            context_code_dim=a.context_code_dim,
            score_type=a.score_type,
            num_categories=len(self.category2id),
            category_embed_dim=a.category_embed_dim,
            category_pad_id=self.category2id[constants.PAD_TOKEN],
            category_embed=category_embed,
            legacy_mask=a.legacy_poly_mask,
        )
        model.reset_parameters(torch.Generator().manual_seed(a.seed))
        return model

    def serving_context(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                        ) -> ServingContext:
        """Everything a scoring endpoint needs, built once: the news store,
        the device table, the model on the device in the compute type, and
        the corpus news-embedding cache (one PLM pass; zero PLM calls per
        request afterwards). ``state_dict`` (for example from
        ``models.convert.miner_params_from_jax``) replaces the random
        weights, loaded strictly."""
        a = self.args
        store = self._load_store(a.eval_news_path)
        table = self._make_table(store)
        model = self.build_model()
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        model = cast_to_compute_(model, self.compute_dtype).to(self.device).eval()
        if getattr(a, "serve_cache_path", None):
            # as in the JAX package: random-init weights have no stable
            # identity to fingerprint a persisted cache against
            print("--serve_cache_path ignored: no checkpoint "
                  "(--saved_model_path) to fingerprint against")
        cache = CacheFiller(model.encode_news).fill(table)
        return ServingContext(store=store, table=table, model=model, cache=cache)

    # --------------------------------------------------------------- scoring
    @staticmethod
    def _cached_scores(model: Miner, cache: NewsEmbeddingCache,
                       cand_idx: torch.Tensor, his_idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scoring from the news-embedding cache (zero PLM calls):
        (interests (B, K, D), matching (B, C)). The candidate gather and
        per-interest scoring run in the lookup+score op straight against
        the cache."""
        his_repr = gather_rows(cache.embeddings, his_idx)
        his_cat = gather_rows(cache.category, his_idx)
        his_mask = (his_cat != cache.category_pad_id).to(torch.int32)
        bias = None
        if model.use_category_bias:
            cand_cat = gather_rows(cache.category, cand_idx)
            bias = model.category_bias_from_ids(his_cat, cand_cat)
        interests = model.interests_from_history(his_repr, his_mask, bias)
        pscores = lookup_score_fused(cache.embeddings, cand_idx, interests)
        cand_repr = None
        if model.score_type == "weighted":
            cand_repr = gather_rows(cache.embeddings, cand_idx)
        return interests, model.aggregate_matching(interests, pscores, cand_repr)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int32), device=self.device)

    def serve_scores(self, model: Miner, cache: NewsEmbeddingCache,
                     cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        """Batched multi-user serving: (B, C) candidate rows + (B, H) history
        rows -> (B, C) matching scores, straight from the cache."""
        with torch.inference_mode():
            _, logits = self._cached_scores(model, cache, self._index(cand_idx),
                                            self._index(his_idx))
            return logits.float().cpu().numpy()

    def serve_topk(self, model: Miner, cache: NewsEmbeddingCache,
                   his_idx: np.ndarray, k: int):
        """Whole-corpus top-k on the device: (B, H) history rows ->
        (scores (B, k), news rows (B, k)). The corpus candidate list (every
        row but pad 0, padded to a power-of-two bucket with the pad news) is
        built on the device and ranked with ``torch.topk``, so only O(k)
        values come back to the host."""
        C = cache.num_rows - 1  # corpus candidates: rows 1.. (0 is the pad news)
        k = min(int(k), C)
        C_pad = candidate_bucket(C)
        with torch.inference_mode():
            his = self._index(his_idx)
            row = torch.arange(1, C_pad + 1, dtype=torch.int32, device=self.device)
            row = torch.where(row <= C, row, 0)  # bucket tail -> pad news
            cand_idx = row[None].expand(his.shape[0], C_pad).contiguous()
            _, logits = self._cached_scores(model, cache, cand_idx, his)
            logits = torch.where(row[None] > 0, logits.float(), -torch.inf)
            vals, pos = torch.topk(logits, k, dim=-1)
            return vals.cpu().numpy(), (pos + 1).cpu().numpy()

    def recommend(self):
        """One-shot ranking: ``--candidates`` (or the whole corpus) against
        ``--user_history``, through the same cached path as the server."""
        a = self.args
        ctx = self.serving_context()
        store = ctx.store

        def idx_of(nid: str) -> int:
            if nid not in store.id_to_row:
                raise KeyError(f"unknown news id {nid!r}")
            return store.id_to_row[nid]

        his_idx = history_row([idx_of(n) for n in a.user_history],
                              a.his_length, self._legacy_layout)[None]
        if a.candidates:
            cand_idx = np.asarray([idx_of(n) for n in a.candidates], np.int32)[None]
            scores = self.serve_scores(ctx.model, ctx.cache, cand_idx, his_idx)[0]
            order = np.argsort(-scores)[: a.topk]
            results = [(a.candidates[i], float(scores[i])) for i in order]
        else:
            row_to_id = {v: k for k, v in store.id_to_row.items()}
            k = min(a.topk, store.num_news - 1)
            vals, rows = self.serve_topk(ctx.model, ctx.cache, his_idx, k)
            results = [(row_to_id.get(int(r), str(int(r))), float(v))
                       for v, r in zip(vals[0, :k], rows[0, :k])]
        for nid, sc in results:
            print(f"{nid}\t{sc:.4f}")
        return results
