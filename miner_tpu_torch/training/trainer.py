"""The trainer of the port: ``train``, ``pretrain``, ``eval``, ``serve`` and
``recommend``.

Counterpart of ``miner_tpu/training/trainer.py`` for four model kinds, as
``--model_name`` picks them (trainer.py:272-328): ``miner`` (the Miner),
``vanilla`` (``fastformer``: the news encoder under a Fastformer user
encoder; ``unisrec``: the MoE news encoder under a causal SASRec encoder;
logits only), ``unbert`` (the UnBERT cross-encoder over packed
(candidate, history) rows, ``data/unbert_packing.py``) and ``pretrain``
(the news encoder alone, trained on the contrastive loss over a positive,
its augmented variants and negatives; the ``pretrain`` subcommand takes it
whatever ``--model_name`` says, trainer.py:111-112):

  * ``train`` (trainer.py:558-799): ``BehaviorsLog``, the numpy samplers and
    the shuffled ``Batcher``; every micro-batch gathers its token rows from
    the ``NewsTable`` on the device, runs the model with dropout (one PLM
    call per field over candidates and history), the kind's loss and its
    backward, and the optimizer (clip, AdamW, warmup schedule, accumulation)
    updates every ``--gradient_accumulation_steps`` micro-batches; an eval
    at every ``--eval_steps`` and at each epoch's end, best and final
    checkpoints, ``--resume_from``; ``--augmentations`` (the
    ``<aug>_news.tsv`` variants) with the ``hard`` sampler mode, and
    ``--pretrained_model_path`` (trainer.py:624-660): a port checkpoint
    loaded whole, or a pretrain run's news encoder grafted into the model;
    before it, as JAX grafts them at init (trainer.py:800-861), the HF
    weights of ``--hf_checkpoint`` (or a local ``--pretrained_embedding``)
    into the PLM and UniSRec's ``--unisrec_pretrained_path`` artifact;
    UniSRec trains its MoE adaptor alone unless ``--unisrec_train_all``;
  * ``eval`` (trainer.py:1081-1130): the model restored from
    ``--saved_model_path`` over the eval behaviors, by default from the
    news-embedding cache (``--cached_eval``); UnBERT scores every packed
    eval row with the model, as the JAX package's ``_run_eval`` does inside
    ``train`` (trainer.py:986-998). The JAX package's standalone UnBERT
    eval raises ``KeyError: 'input_ids'`` (it builds its init example from
    ``EvalSampler``, trainer.py:1101-1107, which ``_init_params_for_kind``
    reads as packed rows, :804-809); the port runs the branch that works;
  * the serving half: ``serving_context`` (news store, model, and the corpus
    news-embedding cache, encoded once or loaded from ``--serve_cache_path``,
    int8 with ``--serve_cache_int8``; trainer.py:1250-1329),
    ``_cached_scores`` (Miner: category bias, poly-attention interests, the
    lookup+score op for the per-interest scores and the target-aware
    logits; Fastformer and UniSRec: the user encoder over the gathered
    history rows, dotted with the gathered candidate rows), ``serve_scores`` for slates
    and ``serve_topk`` for whole-corpus ranking with ``torch.topk``. UnBERT
    has no cache: ``serve_scores_unbert`` packs every (candidate, history)
    pair of a slate batch and runs the model once over them
    (trainer.py:1366-1399), and whole-corpus ranking is refused.

The Miner trains on ``miner_loss`` and evaluates on ``miner_eval_loss``; the
vanilla kind trains on ``vanilla_loss`` and evaluates on
``logsigmoid_eval_loss`` (trainer.py:401-408, 947-953); UnBERT trains on
``binary_cross_entropy_with_logits`` and evaluates on
``logsigmoid_eval_loss`` (trainer.py:372-390); the pretrain kind
trains on ``pretrain_contrastive`` and evaluates on its sum over the eval
behaviors (trainer.py:354-370, 499-548).

The model runs on ``--device`` (default ``cuda``; asking for a card that is
not there raises). On the card every op of the path launches its kernel; on
the CPU the ops run their plain versions, which is what the tests use.
Parameters are fp32 masters and the model computes in ``--compute_dtype``.
A micro-step's dropout is a pure function of (``--seed`` + 1, micro-step)
(``models/dropout.py``), so a resumed run draws what the interrupted one
would have. Flags whose paths come in later slices are refused, naming the
feature of ROADMAP Queue 1 that brings them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from miner_tpu_torch import constants
from miner_tpu_torch.config import plm_config
from miner_tpu_torch.data.batcher import Batcher, block_size
from miner_tpu_torch.data.behaviors import BehaviorsLog
from miner_tpu_torch.data.device_table import NewsTable
from miner_tpu_torch.data.news_store import NewsStore
from miner_tpu_torch.data.samplers import (
    EvalSampler,
    OfflineSampler,
    OnlineSampler,
    PretrainSampler,
)
from miner_tpu_torch.data.tokenization import load_tokenizer
from miner_tpu_torch.data.unbert_packing import (
    FEATURES,
    SEQ_MAX_LEN,
    UnbertEvalSampler,
    UnbertPacker,
    UnbertTrainSampler,
    pack_rows,
)
from miner_tpu_torch.evaluation.evaluator import FastEvaluator, ImpressionEvaluator
from miner_tpu_torch.models import (
    FastformerConfig,
    FastformerUserModel,
    Miner,
    NewsEncoder,
    NewsEncoderMoe,
    UNBert,
    UniSRec,
)
from miner_tpu_torch.models import hf_import
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.models.plm import cast_to_compute_, normal_init_
from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.parallel.news_cache import (
    CacheFiller,
    NewsEmbeddingCache,
    gather_rows,
    load_cache,
    save_cache,
)
from miner_tpu_torch.serving import history_row
from miner_tpu_torch.training import checkpoint, losses
from miner_tpu_torch.training.optim import (
    Optimizer,
    scheduled_lr_value,
    warmup_steps_from_ratio,
)
from miner_tpu_torch.utils import candidate_bucket, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# --model_name (lower case) -> model kind
_KINDS = {"miner": "miner", "fastformer": "vanilla", "unisrec": "vanilla",
          "pretrain": "pretrain", "unbert": "unbert"}


class ServingContext(NamedTuple):
    """One-time setup shared by ``recommend`` and the HTTP scoring server.
    The UnBERT cross-encoder has no table and no cache, and a packer."""

    store: NewsStore
    table: Optional[NewsTable]
    model: nn.Module
    cache: Optional[NewsEmbeddingCache]
    packer: Optional[UnbertPacker] = None


class TrainRun(NamedTuple):
    """What ``train`` returns: the trained model and optimizer, the number
    of micro-steps taken since the run began (resumed steps included), and
    the run directory."""

    model: nn.Module
    optimizer: Optimizer
    step: int
    run_dir: str


def _refuse_unported(args, device: torch.device) -> None:
    """Raise for a flag whose meaning this slice of the port cannot honour,
    naming the feature of ROADMAP Queue 1 that brings it, instead of running
    something else than was asked for."""
    name = (args.model_name or "Miner").lower()
    if name not in _KINDS:
        raise ValueError(f"unknown --model_name {args.model_name!r}")
    if args.fused_kernels is False and device.type == "cuda":
        raise ValueError(
            "--no-fused_kernels with a CUDA device: on the card every path "
            "always runs the port's kernels (the plain versions run on "
            "--device cpu)")
    if args.use_sapo and args.combine_type == "lstm":
        raise NotImplementedError(
            "--combine_type 'lstm' is not ported yet (ROADMAP Queue 1: the "
            "other combines); the port has the linear and pre-concat combines")
    if args.param_dtype != "float32":
        raise NotImplementedError(
            "--param_dtype only supports float32 (fp32 master weights); "
            "use --compute_dtype bfloat16 for mixed precision")
    if getattr(args, "mode", None) not in ("train", "train_fastformer", "pretrain"):
        return
    if args.his_cache_refresh > 0:
        raise NotImplementedError(
            "--his_cache_refresh: cached-history training is not ported yet "
            "(ROADMAP Queue 1: cached-history training)")


class Trainer:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        _refuse_unported(args, self.device)
        # the pretrain subcommand pretrains the news encoder alone whatever
        # --model_name says (its default is "Miner"; trainer.py:111-112)
        if getattr(args, "mode", None) == "pretrain":
            self.model_name = "pretrain"
        else:
            self.model_name = (args.model_name or "Miner").lower()
        self.kind = _KINDS[self.model_name]
        self._num_augs = 0  # augmented variants a pretrain row holds (the train store's)
        self.tokenizer = load_tokenizer(args.pretrained_tokenizer)
        self.user2id: Dict[str, int] = {}
        if args.user2id_path:
            with open(args.user2id_path) as f:
                self.user2id = json.load(f)
        with open(args.category2id_path) as f:
            self.category2id = json.load(f)
        self.compute_dtype = _DTYPES[args.compute_dtype]
        self._legacy_layout = bool(args.legacy_history_layout)
        # 'loss': eval loss and bestLossModel; 'metrics': the ranking
        # evaluator and bestAucModel (reference: src/trainer.py:181-206)
        self.eval_info = frozenset(args.evaluation_info or ("metrics", "loss"))

    # ------------------------------------------------------------------ data
    def _load_store(self, news_path: str, augmentations=None) -> NewsStore:
        return NewsStore.from_tsv(news_path, self.tokenizer, self.category2id,
                                  self.args.max_title_length,
                                  self.args.max_sapo_length,
                                  augmentations=augmentations)

    def _make_table(self, store: NewsStore) -> Optional[NewsTable]:
        """The store's token table on the device; None for UnBERT, which
        packs its rows on the host from the store's titles."""
        if self.kind == "unbert":
            return None
        return NewsTable.from_store(store, use_sapo=self.args.use_sapo,
                                    combine_type=self.args.combine_type,
                                    device=self.device)

    def _load_log(self, behaviors_path: str, store: NewsStore) -> BehaviorsLog:
        return BehaviorsLog.from_tsv(behaviors_path, store, self.user2id,
                                     self.args.his_length,
                                     legacy_layout=self._legacy_layout)

    def _train_sampler(self, log: BehaviorsLog, store: NewsStore):
        a = self.args
        if self.kind == "pretrain":
            return PretrainSampler(log, store, a.npratio, seed=a.seed)
        if self.kind == "unbert":
            return UnbertTrainSampler(log, store, self._unbert_packer(store),
                                      a.npratio, seed=a.seed)
        mode = "hard" if a.augmentation_mode == "hard" else "base"
        cls = OnlineSampler if a.online else OfflineSampler
        return cls(log, store, a.npratio, seed=a.seed, mode=mode)

    def _unbert_packer(self, store: NewsStore) -> UnbertPacker:
        """The packer over ``store``'s titles with the tokenizer's CLS, SEP
        (EOS when it has none) and PAD ids (trainer.py:196-205)."""
        tok = self.tokenizer
        sep = tok.sep_token_id if tok.sep_token_id is not None else tok.eos_token_id
        return UnbertPacker(store, cls_id=tok.cls_token_id, sep_id=sep,
                            pad_id=tok.pad_token_id, legacy_layout=self._legacy_layout)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int32), device=self.device)

    # ----------------------------------------------------------------- model
    def build_model(self) -> nn.Module:
        """The model of the kind with fresh weights from ``--seed``, fp32, on
        the CPU (so the same seed gives the same weights on any device). The
        news encoder, and all of the Miner, compute in ``--compute_dtype``;
        the Fastformer user encoder computes in fp32, since the JAX package
        builds it without a dtype (trainer.py:291). The pretrain kind's
        model is the news encoder alone (trainer.py:239-252), with the
        weights the Miner's encoder takes from the same seed. UnBERT
        (trainer.py:303-328) computes in ``--compute_dtype`` throughout.
        UniSRec (trainer.py:293-301): ``NewsEncoderMoe`` in the compute type
        with ``--dropout`` in its adaptor, the SASRec tail in fp32."""
        a = self.args
        gelu_approx = a.gelu_approx
        if gelu_approx is None:
            gelu_approx = self.compute_dtype == torch.bfloat16
        plm = plm_config(a.plm_preset, vocab_size=self.tokenizer.vocab_size,
                         gelu_approx=gelu_approx, remat=a.remat)
        if self.kind == "unbert":
            # two token types, and a position table covering the packed row
            # (the tiny preset's 256 < 300)
            cfg = dataclasses.replace(
                plm, type_vocab_size=max(2, plm.type_vocab_size),
                max_position_embeddings=max(plm.max_position_embeddings,
                                            SEQ_MAX_LEN + plm.position_offset))
            # eval / serve / recommend do not take the UnBERT flags: their
            # defaults, as the JAX package's getattr reads them
            model = UNBert(cfg, getattr(a, "unbert_news_layers", None) or cfg.num_layers,
                           getattr(a, "unbert_news_mode", "nseg"), self.compute_dtype)
            normal_init_(model, cfg.initializer_range, torch.Generator().manual_seed(a.seed))
            return model
        if self.model_name == "unisrec":
            encoder = NewsEncoderMoe(plm, use_sapo=a.use_sapo, combine_type=a.combine_type,
                                     adaptor_dropout=a.dropout, dtype=self.compute_dtype)
            model = UniSRec(encoder, max_his_len=a.his_length)
            model.reset_parameters(torch.Generator().manual_seed(a.seed))
            return model
        encoder = NewsEncoder(plm, apply_reduce_dim=a.apply_reduce_dim,
                              word_embed_dim=a.word_embed_dim,
                              use_sapo=a.use_sapo, combine_type=a.combine_type,
                              dropout=a.dropout, dtype=self.compute_dtype)
        if self.kind == "pretrain":
            normal_init_(encoder, plm.initializer_range,
                         torch.Generator().manual_seed(a.seed))
            return encoder
        if self.kind == "vanilla":
            D = encoder.embed_dim
            cfg = FastformerConfig(hidden_size=D,
                                   num_heads=16 if D % 16 == 0 else 4,
                                   intermediate_size=D, hidden_dropout=a.dropout,
                                   max_position_embeddings=max(256, a.his_length))
            model = FastformerUserModel(encoder, cfg)
            model.reset_parameters(torch.Generator().manual_seed(a.seed))
            return model
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
            dropout=a.dropout,
            dtype=self.compute_dtype,
        )
        model.reset_parameters(torch.Generator().manual_seed(a.seed))
        return model

    def initial_model(self) -> nn.Module:
        """``build_model`` with the grafts the JAX package makes at init
        (trainer.py:822-861), in its order: the HF weights of
        ``--hf_checkpoint``, or of ``--pretrained_embedding`` when it names
        a local directory (a hub name only warns), into the PLM (the
        pretrain kind's ``plm``, else ``news_encoder.plm``; UnBERT takes
        none, as in JAX); then UniSRec's ``--unisrec_pretrained_path``."""
        a = self.args
        log = getattr(self, "_log", logging.getLogger("miner_tpu_torch"))
        model = self.build_model()
        hf_dir, pretrained = a.hf_checkpoint, getattr(a, "pretrained_embedding", None)
        if not hf_dir and pretrained:
            if os.path.isdir(pretrained):
                hf_dir = pretrained
            else:
                log.warning("--pretrained_embedding %r is not a local checkpoint "
                            "directory; training from random init", pretrained)
        if hf_dir and self.kind == "unbert":
            log.warning("HF weights are not imported into UnBERT (as in the JAX "
                        "package); %s ignored", hf_dir)
        elif hf_dir:
            hf_import.load_plm_into(model.plm if self.kind == "pretrain"
                                    else model.news_encoder.plm, hf_dir)
            log.info("imported the PLM's weights from %s", hf_dir)
        path = getattr(a, "unisrec_pretrained_path", None)
        if self.model_name == "unisrec" and path:
            n = hf_import.load_unisrec_pretrained(
                model, path, legacy_layout=self._legacy_layout,
                force=getattr(a, "force_layout_mismatch", False))
            log.info("loaded %d tensors from UniSRec pretrained checkpoint %s", n, path)
        return model

    def restored_model(self) -> nn.Module:
        """The parameters of ``--saved_model_path`` (a port checkpoint)
        loaded strictly into ``build_model`` when it is given (they replace
        every graft), else ``initial_model``."""
        if not self.args.saved_model_path:
            return self.initial_model()
        model = self.build_model()
        payload = checkpoint.load(self.args.saved_model_path)
        model.load_state_dict(payload["params"], strict=True)
        return model

    def serving_context(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                        ) -> ServingContext:
        """Everything a scoring endpoint needs, built once: the news store,
        the device table, the model on the device in the compute type, and
        the corpus news-embedding cache (one PLM pass; zero PLM calls per
        request afterwards). The weights are ``state_dict`` (for example
        from ``models.convert.params_from_jax``) when given, else
        those of ``--saved_model_path``, else random from ``--seed``;
        loaded strictly."""
        a = self.args
        if self.kind == "pretrain":
            raise ValueError("serving takes the Miner, Fastformer and UnBERT "
                             "families, not the pretrain kind's bare news encoder")
        store = self._load_store(a.eval_news_path)
        if state_dict is not None:
            model = self.build_model()
            model.load_state_dict(state_dict, strict=True)
        else:
            model = self.restored_model()
        if self.kind == "unbert":
            # a cross-encoder reranker: every request runs the model over
            # packed (candidate, history) rows, so there is no table and no
            # cache, and --serve_cache_path is not read (trainer.py:1202-1218)
            model = cast_to_compute_(model, self.compute_dtype).to(self.device).eval()
            return ServingContext(store=store, table=None, model=model, cache=None,
                                  packer=self._unbert_packer(store))
        table = self._make_table(store)
        # one cast for serving; the same bf16 values as casting at each use.
        # The Fastformer user encoder stays fp32: only its news tower casts
        cast_to_compute_(model.news_encoder if self.kind == "vanilla" else model,
                         self.compute_dtype)
        model = model.to(self.device).eval()
        cache = self._load_or_build_serving_cache(model, table)
        return ServingContext(store=store, table=table, model=model, cache=cache)

    def _serving_cache_fingerprint(self) -> Dict:
        """What a persisted serving cache is a function of (trainer.py:
        1250-1298): the corpus bytes, the tokenization geometry, the
        checkpoint file and the settings that change the encoding. The
        checkpoint is one file, named with its size and modification time
        (cheap; a false mismatch only costs an encode)."""
        a = self.args
        h = hashlib.sha256()
        with open(a.eval_news_path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        st = os.stat(a.saved_model_path)
        ckpt = f"{os.path.basename(a.saved_model_path)}:{st.st_size}:{st.st_mtime_ns}"
        gelu_approx = a.gelu_approx
        if gelu_approx is None:
            gelu_approx = self.compute_dtype == torch.bfloat16
        return {
            "news_sha": h.hexdigest(),
            "ckpt_sha": hashlib.sha256(ckpt.encode()).hexdigest(),
            "tokenizer": str(a.pretrained_tokenizer),
            "model_name": self.model_name,
            "plm_preset": str(a.plm_preset),
            "compute_dtype": str(a.compute_dtype),
            "max_title_length": int(a.max_title_length),
            "max_sapo_length": int(a.max_sapo_length),
            "use_sapo": bool(a.use_sapo),
            "combine_type": str(a.combine_type),
            "gelu_approx": bool(gelu_approx),
            "attn_fp32": bool(a.attn_fp32),
            "fused_kernels": self.device.type == "cuda",
            # an int8 file never serves a float request, nor the other way
            "serve_cache_int8": bool(getattr(a, "serve_cache_int8", False)),
        }

    def _load_or_build_serving_cache(self, model: nn.Module,
                                     table: NewsTable) -> NewsEmbeddingCache:
        """The corpus cache (trainer.py:1299-1329): loaded from
        ``--serve_cache_path`` when the file's fingerprint matches, else one
        corpus encode, quantized to int8 with ``--serve_cache_int8``, and
        persisted to that path. Without ``--saved_model_path`` the weights
        have no identity to fingerprint and the path is ignored."""
        a = self.args
        path = getattr(a, "serve_cache_path", None)
        if path and not a.saved_model_path:
            print("--serve_cache_path ignored: no checkpoint "
                  "(--saved_model_path) to fingerprint against")
            path = None
        fingerprint = self._serving_cache_fingerprint() if path else None
        if path:
            cache = load_cache(path, fingerprint, self.device)
            if cache is not None:
                print(f"serving cache loaded from {path}")
                return cache
        cache = CacheFiller(model.encode_news).fill(table)
        if getattr(a, "serve_cache_int8", False):
            cache = cache.quantize()
        if path:
            save_cache(cache, path, cache.num_rows, fingerprint)
            print(f"serving cache persisted to {path}")
        return cache

    # --------------------------------------------------------------- scoring
    def _cached_scores(self, model: nn.Module, cache: NewsEmbeddingCache,
                       cand_idx: torch.Tensor, his_idx: torch.Tensor
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Scoring from the news-embedding cache (zero PLM calls):
        (interests (B, K, D) or None, matching (B, C)). For the Miner the
        candidate rows are never gathered: the lookup+score op reads them
        straight from the cache (``Miner.matching_from_cache``); the vanilla
        kind gathers the candidate and history rows and runs its tail
        (trainer.py:917-923). An int8 cache's gathered rows are dequantized
        to the compute type."""
        his_repr = gather_rows(cache.embeddings, his_idx)
        his_cat = gather_rows(cache.category, his_idx)
        his_mask = (his_cat != cache.category_pad_id).to(torch.int32)
        if self.kind == "vanilla":
            cand_repr = gather_rows(cache.embeddings, cand_idx)
            return None, model.tail(cand_repr, his_repr, his_mask)
        bias = None
        if model.use_category_bias:
            cand_cat = gather_rows(cache.category, cand_idx)
            bias = model.category_bias_from_ids(his_cat, cand_cat)
        interests = model.interests_from_history(his_repr, his_mask, bias)
        return interests, model.matching_from_cache(cache.embeddings, cand_idx, interests)

    def _loss(self, interests: Optional[torch.Tensor], logits: torch.Tensor,
              label: torch.Tensor, train: bool,
              row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The kind's training or eval loss (trainer.py:391-408, 947-953)."""
        if self.kind == "vanilla":
            if train:
                return losses.vanilla_loss(logits, label)
            return losses.logsigmoid_eval_loss(logits, label, row_mask)
        if train:
            return losses.miner_loss(interests, logits, label)
        return losses.miner_eval_loss(interests, logits, label, row_mask)

    def serve_scores(self, model: nn.Module, cache: NewsEmbeddingCache,
                     cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        """Batched multi-user serving: (B, C) candidate rows + (B, H) history
        rows -> (B, C) matching scores, straight from the cache."""
        with torch.inference_mode():
            _, logits = self._cached_scores(model, cache, self._index(cand_idx),
                                            self._index(his_idx))
            return logits.float().cpu().numpy()

    def _unbert_features(self, feat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(feat[k], device=self.device) for k in FEATURES}

    def serve_scores_unbert(self, model: nn.Module, packer: UnbertPacker,
                            cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        """Cross-encoder reranking (trainer.py:1366-1399): (B, C) candidate
        rows + (B, H) history rows -> (B, C) logits. Each (candidate,
        history) pair packs into one ``seq_max_len``-token row on the host
        and the B * C rows run through the model in one call: no cache can
        exist for a cross-encoder, so a request costs a full pass per
        candidate."""
        B, C = cand_idx.shape
        hist = np.repeat(np.asarray(his_idx, np.int32), C, axis=0)  # (B*C, H)
        feat = pack_rows(packer, np.asarray(cand_idx, np.int32).reshape(-1), hist)
        with torch.inference_mode():
            logits = model(self._unbert_features(feat))
            return logits.float().cpu().numpy().reshape(B, C)

    def serve_topk(self, model: nn.Module, cache: NewsEmbeddingCache,
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
            if self.kind == "unbert":
                scores = self.serve_scores_unbert(ctx.model, ctx.packer, cand_idx,
                                                  his_idx)[0]
            else:
                scores = self.serve_scores(ctx.model, ctx.cache, cand_idx, his_idx)[0]
            order = np.argsort(-scores)[: a.topk]
            results = [(a.candidates[i], float(scores[i])) for i in order]
        elif self.kind == "unbert":
            raise ValueError(
                "whole-corpus ranking is not supported for the unbert "
                "cross-encoder (no embedding cache exists; every candidate "
                "costs a full PLM pass) — pass --candidates")
        else:
            row_to_id = {v: k for k, v in store.id_to_row.items()}
            k = min(a.topk, store.num_news - 1)
            vals, rows = self.serve_topk(ctx.model, ctx.cache, his_idx, k)
            results = [(row_to_id.get(int(r), str(int(r))), float(v))
                       for v, r in zip(vals[0, :k], rows[0, :k])]
        for nid, sc in results:
            print(f"{nid}\t{sc:.4f}")
        return results

    # ----------------------------------------------------------------- train
    def make_optimizer(self, model: nn.Module, total_updates: int,
                       warmup: int) -> Optimizer:
        a = self.args
        if self.model_name == "unisrec" and not getattr(a, "unisrec_train_all", False):
            # the MoE adaptor alone trains (trainer.py:331-345, JAX's name
            # filter): nothing before it needs a gradient, so no backward
            # runs through the PLM
            for name, p in model.named_parameters():
                p.requires_grad_("moe" in name.lower())
        # UnBERT has no "plm" subtree, so --freeze_transformer freezes
        # nothing of it, as the JAX package's name filter (trainer.py:345)
        elif a.freeze_transformer and self.kind != "unbert":
            encoder = model if self.kind == "pretrain" else model.news_encoder
            encoder.plm.requires_grad_(False)
        return Optimizer(model.named_parameters(), learning_rate=a.learning_rate,
                         total_steps=total_updates, warmup_steps=warmup,
                         weight_decay=a.weight_decay,
                         max_grad_norm=a.max_grad_norm,
                         accum_steps=a.gradient_accumulation_steps)

    def _apply_and_loss(self, model: nn.Module, table: NewsTable,
                        batch: Dict[str, np.ndarray], train: bool,
                        rng: Optional[DropoutRNG] = None,
                        row_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, logits) of a batch of index rows (``_apply_and_loss``,
        trainer.py:354-408); for the pretrain kind (loss, news vectors); for
        UnBERT of a batch of packed rows (``table`` unused)."""
        if self.kind == "pretrain":
            return self._pretrain_loss(model, table, batch["cand_idx"], self._num_augs,
                                       rng, row_mask)
        if self.kind == "unbert":
            logits = model(self._unbert_features(batch), rng)
            label = torch.as_tensor(batch["label"], device=self.device)
            if train:
                return losses.binary_cross_entropy_with_logits(logits, label), logits
            return losses.logsigmoid_eval_loss(logits, label, row_mask), logits
        model_batch = table.lookup(self._index(batch["cand_idx"]),
                                   self._index(batch["his_idx"]))
        label = torch.as_tensor(batch["label"], device=self.device)
        out = model(model_batch, rng)
        interests, logits = out if self.kind == "miner" else (None, out)
        return self._loss(interests, logits, label, train, row_mask), logits

    def _pretrain_loss(self, model: nn.Module, table: NewsTable, cand_idx: np.ndarray,
                       num_augs: int, rng: Optional[DropoutRNG] = None,
                       row_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The contrastive loss of (B, C) candidate rows (trainer.py:354-370):
        the B * C news through the encoder, back to (B, C, D)."""
        cand = table.lookup_candidates(self._index(cand_idx))
        B, C = cand["cand_title"].shape[:2]
        sapo = sapo_mask = None
        if "cand_sapo" in cand:
            sapo, sapo_mask = cand["cand_sapo"].flatten(0, 1), cand["cand_sapo_mask"].flatten(0, 1)
        reprs = model(cand["cand_title"].flatten(0, 1), cand["cand_title_mask"].flatten(0, 1),
                      sapo, sapo_mask, rng).reshape(B, C, -1)
        return losses.pretrain_contrastive(reprs, num_augs, row_mask), reprs

    def train_step(self, model: nn.Module, table: NewsTable,
                   batch: Dict[str, np.ndarray], optimizer: Optimizer,
                   micro_step: int) -> torch.Tensor:
        """One micro-batch (trainer.py:410-425): forward with the dropout of
        ``micro_step``, backward into the accumulated gradients, and the
        optimizer's update when one is due. Returns the loss, on the
        device."""
        rng = DropoutRNG(self.args.seed + 1, micro_step, self.device)
        loss, _ = self._apply_and_loss(model, table, batch, True, rng)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def _payload(self, model: nn.Module, optimizer: Optimizer, micro_step: int) -> Dict:
        grad_acc = None
        if optimizer.mini_step:  # mid-accumulation: keep the partial sum
            grad_acc = {n: p.grad.detach() for n, p in model.named_parameters()
                        if p.grad is not None}
        return {"params": model.state_dict(), "optimizer": optimizer.state_dict(),
                "micro_step": micro_step, "rng_seed": self.args.seed + 1,
                "grad_acc": grad_acc, "args": _plain(vars(self.args))}

    def _resume(self, path: str, model: nn.Module, optimizer: Optimizer) -> int:
        payload = checkpoint.load(path)
        model.load_state_dict(payload["params"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        for name, p in model.named_parameters():
            grad = (payload["grad_acc"] or {}).get(name)
            p.grad = None if grad is None else grad.to(p.device)
        return int(payload["micro_step"])

    def _warm_start(self, model: nn.Module, path: str, log) -> None:
        """``--pretrained_model_path`` (trainer.py:624-660): a port
        checkpoint's parameters, grafted under ``news_encoder.`` when they
        are a news encoder's alone (a pretrain run's), else loaded whole.
        Raises ``ValueError`` naming up to 5 missing and 5 unexpected keys
        when they are neither."""
        loaded = checkpoint.load(path)["params"]
        own = model.state_dict()
        prefix = "news_encoder."
        enc = {k[len(prefix):] for k in own if k.startswith(prefix)}
        if enc and set(loaded) != set(own) and enc == set(loaded):
            model.news_encoder.load_state_dict(loaded, strict=True)
            log.info("warm-started news_encoder (pretrain -> finetune) from %s", path)
            return
        if set(loaded) != set(own):
            missing = sorted(set(own) - set(loaded))[:5]
            extra = sorted(set(loaded) - set(own))[:5]
            raise ValueError(
                f"--pretrained_model_path {path} does not match the model (neither "
                f"the whole model nor its news encoder): missing {missing}, "
                f"unexpected {extra}")
        model.load_state_dict(loaded, strict=True)
        log.info("warm-started the whole model from %s", path)

    def train(self) -> TrainRun:
        a = self.args
        logger = RunLogger(a.train_path, "train", vars(a))
        logger.enable_tensorboard(os.path.join(logger.run_dir,
                                               a.tensorboard_path or "tb"))
        log = self._log = logger.logger
        log.info("device: %s", self.device)

        store = self._load_store(a.train_news_path, a.augmentations)
        self._num_augs = store.num_variants - 1
        train_log = self._load_log(a.train_behaviors_path, store)
        sampler = self._train_sampler(train_log, store)
        table = self._make_table(store)
        eval_store, eval_table, eval_log = store, table, None
        if a.eval_news_path and a.eval_news_path != a.train_news_path:
            eval_store = self._load_store(a.eval_news_path)
            eval_table = self._make_table(eval_store)
        if a.eval_behaviors_path:
            eval_log = self._load_log(a.eval_behaviors_path, eval_store)

        batcher = Batcher(a.train_batch_size, drop_last=True, shuffle=True,
                          seed=a.seed)
        steps_per_epoch = batcher.num_batches(block_size(sampler.sample_epoch(0)))
        if steps_per_epoch == 0:
            raise ValueError("no training batches — dataset smaller than batch")
        accum = max(1, a.gradient_accumulation_steps)
        updates_per_epoch = max(1, steps_per_epoch // accum)
        total_updates = a.max_steps or updates_per_epoch * a.num_train_epochs
        warmup = warmup_steps_from_ratio(total_updates, a.warmup_ratio, a.warmup_steps)

        model = self.initial_model().to(self.device).train()
        if a.pretrained_model_path:  # before the optimizer sees the parameters
            self._warm_start(model, a.pretrained_model_path, log)
        log.info("parameters: %.2fM",
                 sum(p.numel() for p in model.parameters()) / 1e6)
        optimizer = self.make_optimizer(model, total_updates, warmup)
        ckpt_dir = os.path.join(logger.run_dir, "ckpt")
        global_step = 0
        if a.resume_from:
            global_step = self._resume(a.resume_from, model, optimizer)
            log.info("resumed from %s at step %d", a.resume_from, global_step)
        # resume is exact: a step's data and dropout are pure functions of
        # (seed, epoch) and (seed, step), so completed epochs are skipped and
        # the partial epoch's consumed batches fast-forwarded
        start_epoch = min(global_step // steps_per_epoch, a.num_train_epochs)
        skip_batches = global_step % steps_per_epoch

        run_eval = lambda epoch, step: self._run_eval(  # noqa: E731
            model, eval_table, eval_store, eval_log, logger, epoch, step)
        if self.kind == "pretrain" and eval_log is not None:
            # the contrastive loss over the eval behaviors, negatives drawn
            # once (seed, epoch 0), with the eval store's variants
            eval_block = PretrainSampler(eval_log, eval_store, a.npratio,
                                         seed=a.seed).sample_epoch(0)
            run_eval = lambda epoch, step: ({}, self._run_pretrain_eval(  # noqa: E731
                model, eval_table, eval_block, eval_store.num_variants - 1, logger,
                epoch, step))
            if "metrics" in self.eval_info:
                log.warning("--evaluation_info metrics has no effect for pretrain "
                            "(the forward emits embeddings, not rankable logits)")

        best_loss, best_auc = float("inf"), -float("inf")
        ex_counter, t_last = 0, time.time()
        for epoch in range(start_epoch, a.num_train_epochs):
            t_epoch = time.time()
            block = sampler.sample_epoch(epoch)
            epoch_losses = []
            for i, batch in enumerate(batcher.batches(block, epoch)):
                if epoch == start_epoch and i < skip_batches:
                    continue
                loss = self.train_step(model, table, batch, optimizer, global_step)
                global_step += 1
                ex_counter += a.train_batch_size
                epoch_losses.append(loss)
                if global_step % a.logging_steps == 0:
                    loss_v = float(loss)
                    dt = time.time() - t_last
                    eps = ex_counter / dt if dt > 0 else 0.0
                    ex_counter, t_last = 0, time.time()
                    logger.log_train(epoch, global_step, loss_v,
                                     scheduled_lr_value(a.learning_rate, warmup,
                                                        total_updates,
                                                        global_step // accum),
                                     eps)
                if eval_log is not None and global_step % a.eval_steps == 0:
                    scores, eval_loss = run_eval(epoch, global_step)
                    best_loss, best_auc = self._maybe_checkpoint(
                        ckpt_dir, model, optimizer, global_step, scores,
                        eval_loss, best_loss, best_auc, log)
            mean_loss = float(torch.stack(epoch_losses).mean()) if epoch_losses else float("nan")
            if eval_log is not None:
                scores, eval_loss = run_eval(epoch, global_step)
                best_loss, best_auc = self._maybe_checkpoint(
                    ckpt_dir, model, optimizer, global_step, scores, eval_loss,
                    best_loss, best_auc, log)
            logger.log_epoch(epoch, mean_loss, time.time() - t_epoch)
        checkpoint.save(os.path.join(ckpt_dir, "finalModel"),
                        self._payload(model, optimizer, global_step))
        log.info("training complete: %d steps", global_step)
        return TrainRun(model, optimizer, global_step, logger.run_dir)

    def _maybe_checkpoint(self, ckpt_dir, model, optimizer, step, scores,
                          eval_loss, best_loss, best_auc, log):
        # best-loss / best-auc selection is gated by --evaluation_info
        # (_run_eval returns eval_loss None / scores {} for the halves off)
        if eval_loss is not None and eval_loss < best_loss:
            best_loss = eval_loss
            checkpoint.save(os.path.join(ckpt_dir, "bestLossModel"),
                            self._payload(model, optimizer, step))
            log.info("new best loss %.5f -> bestLossModel", eval_loss)
        auc = scores.get("auc", scores.get("group_auc"))
        if auc is not None and auc > best_auc:
            best_auc = auc
            checkpoint.save(os.path.join(ckpt_dir, "bestAucModel"),
                            self._payload(model, optimizer, step))
            log.info("new best auc %.5f -> bestAucModel", auc)
        return best_loss, best_auc

    # ------------------------------------------------------------------ eval
    def _run_eval(self, model: nn.Module, table: NewsTable, store: NewsStore,
                  eval_log: BehaviorsLog, logger: RunLogger, epoch: int,
                  step: int) -> Tuple[Dict[str, float], Optional[float]]:
        """One pass over the eval behaviors (trainer.py:982-1063): by default
        from the news-embedding cache of the current weights (zero PLM calls
        per batch, the same scores as re-encoding, since the encoder is
        deterministic at eval); ``--fast_eval`` scores train-format
        (1+npratio) rows with softmax probabilities. Returns (scores,
        summed eval loss). UnBERT scores the packed row of every eval
        candidate over ``store`` with the model (trainer.py:986-998):
        ``--cached_eval`` and ``--fast_eval`` do not apply to a
        cross-encoder."""
        a = self.args
        fast = a.fast_eval and self.kind != "unbert"
        if self.kind == "unbert":
            block = UnbertEvalSampler(eval_log, store, self._unbert_packer(store)).sample_all()
            evaluator = ImpressionEvaluator(eval_log.eval_targets_by_impression())
        elif fast:
            block = OfflineSampler(eval_log, store, a.npratio, seed=a.seed).sample_epoch(0)
            evaluator = FastEvaluator([row.tolist() for row in block.label.astype(int)])
        else:
            block = EvalSampler(eval_log).sample_all()
            evaluator = ImpressionEvaluator(eval_log.eval_targets_by_impression())
        batcher = Batcher(a.eval_batch_size, drop_last=False, shuffle=False)
        was_training = model.training
        model.eval()
        cache = None
        if a.cached_eval and not fast and self.kind != "unbert":
            cache = CacheFiller(model.encode_news).fill(table)
        total_loss = 0.0
        with torch.inference_mode():
            for batch in batcher.batches(block):
                valid = int(batch.pop("valid"))
                B = len(batch["label"])
                row_mask = torch.arange(B, device=self.device) < valid
                if cache is not None:
                    interests, logits = self._cached_scores(
                        model, cache, self._index(batch["cand_idx"]),
                        self._index(batch["his_idx"]))
                    label = torch.as_tensor(batch["label"], device=self.device)
                    loss = self._loss(interests, logits, label, False, row_mask)
                else:
                    loss, logits = self._apply_and_loss(model, table, batch, False,
                                                        row_mask=row_mask)
                total_loss += float(loss)
                if "metrics" in self.eval_info:
                    evaluator.eval_batch(logits.float().cpu().numpy(),
                                         batch["impression_id"], valid=valid)
        model.train(was_training)
        scores = {}
        if "metrics" in self.eval_info:
            scores = evaluator.compute_scores(a.metrics, save_result=a.save_eval_result,
                                              path=logger.run_dir)
        eval_loss = total_loss if "loss" in self.eval_info else None
        logger.log_eval(epoch, step, scores, eval_loss)
        if "metrics" in self.eval_info:
            if a.save_eval_result and hasattr(evaluator, "save_predictions"):
                evaluator.save_predictions(logger.run_dir)
            if a.save_ranking and hasattr(evaluator, "save_ranking"):
                evaluator.save_ranking(logger.run_dir)
        return scores, eval_loss

    def _run_pretrain_eval(self, model: nn.Module, table: NewsTable, block,
                           num_augs: int, logger: RunLogger, epoch: int,
                           step: int) -> float:
        """The pretrain kind's eval (trainer.py:499-548): the contrastive
        loss summed over the batches of ``block``, the padded tail's rows
        masked, logged to eval.csv with no ranking metrics."""
        batcher = Batcher(self.args.eval_batch_size, drop_last=False, shuffle=False)
        was_training = model.training
        model.eval()
        total = 0.0
        with torch.inference_mode():
            for batch in batcher.batches(block):
                valid = int(batch.pop("valid"))
                B = len(batch["cand_idx"])
                row_mask = torch.arange(B, device=self.device) < valid
                loss, _ = self._pretrain_loss(model, table, batch["cand_idx"], num_augs,
                                              row_mask=row_mask)
                total += float(loss)
        model.train(was_training)
        logger.log_eval(epoch, step, {}, total)
        return total

    def eval(self) -> Dict[str, float]:
        """Standalone evaluation of ``--saved_model_path``; for the pretrain
        kind ``{"loss": total}`` (trainer.py:1095-1118); for UnBERT the
        packed-row eval that ``train`` runs (see the module docstring)."""
        a = self.args
        logger = RunLogger(a.eval_path, "eval", vars(a))
        self._log = logger.logger
        store = self._load_store(a.eval_news_path)
        eval_log = self._load_log(a.eval_behaviors_path, store)
        table = self._make_table(store)
        model = self.restored_model().to(self.device).eval()
        if self.kind == "pretrain":
            block = PretrainSampler(eval_log, store, a.npratio, seed=a.seed).sample_epoch(0)
            return {"loss": self._run_pretrain_eval(model, table, block,
                                                    store.num_variants - 1, logger, 0, 0)}
        scores, _ = self._run_eval(model, table, store, eval_log, logger, 0, 0)
        return scores


def _plain(args: Dict) -> Dict:
    """The run's arguments as plain values (what a checkpoint stores)."""
    return {k: v if isinstance(v, (str, int, float, bool, type(None), list)) else str(v)
            for k, v in args.items()}
