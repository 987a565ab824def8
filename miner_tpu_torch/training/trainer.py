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

  * ``train`` (trainer.py:558-799): ``BehaviorsLog``, the samplers built as
    JAX's are (at ``backend="auto"``: the native C++ sampler and UnBERT
    packer where g++ builds them, ``data/native.py``) and the shuffled
    ``Batcher``; every micro-batch gathers its token rows from
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
    cached-history training (``--his_cache_refresh K``, trainer.py:427-477,
    694-710, 761-766; the Miner, Fastformer and UniSRec): after
    ``--his_cache_warmup_steps`` optimizer steps of full-history
    micro-batches, only the candidates go through the news encoder, and the
    history rows are gathered from a news-embedding cache of the train table
    (``HistoryCache``), rebuilt from the live weights every K optimizer
    steps and held out of the gradient;
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
and each value's place in the global batch (``models/dropout.py``), so a
resumed run draws what the interrupted one would have, and a run over a
mesh what one device draws. ``--param_dtype`` other than float32 is refused, as the JAX
package refuses it, and so is ``--no-fused_kernels`` on a card.

Over a mesh of ranks (``--mesh_data``, ``--mesh_table``; one process a
rank under ``python -m torch.distributed.run``, ``parallel/mesh.py``;
JAX's mesh, trainer.py:120-132) every rank samples and batches the same
global batches, as JAX's processes do, and feeds its rows of each
(``parallel/sharding.py:shard_batch``); ``--train_batch_size`` and
``--eval_batch_size`` stay global. A rank's loss is its share of the global
batch's (a mean loss times 1 / the data size; the pretrain kind's sum as
it is), so the gradients summed over the data group at each update
(``Optimizer``) are the global batch's, and every rank applies the same
update. An eval gathers every rank's logits (and the Miner's interests)
into the whole batch and computes its loss and metrics as one rank does.
The news-embedding caches (cached eval, cached-history training, serving)
are row-sharded over the table axis (``parallel/news_cache.py``). Over the
model axis (``--mesh_model``) the transformer layers and the MoE experts
are sharded (``parallel/tp.py``) once the model is whole and checked equal
over the ranks; the optimizer sums a sharded leaf's squares over the model
group for the clip. Rank 0 writes the run's files and checkpoints, which
hold full tensors whatever the mesh (the shards gathered, AdamW's moments
too): a checkpoint of any mesh loads on any other. ``serve`` runs its HTTP
front-end on rank 0 and every other rank follows its device calls
(``serving.py``); ``recommend`` runs on every rank.
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
from miner_tpu_torch.parallel import tp
from miner_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, MeshConfig
from miner_tpu_torch.parallel.sharding import gather_rows as gather_batch
from miner_tpu_torch.parallel.sharding import replicate, shard_batch
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
    sum_over,
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


def _refuse_flags(args, device: torch.device) -> None:
    """Raise for an unknown ``--model_name``, for ``--param_dtype`` other
    than float32 (the JAX package refuses it too, trainer.py:125-131), for
    ``--remat_policy`` without ``--remat`` (JAX's ``plm_config`` raises the
    same error in every subcommand that builds a model) and for
    ``--no-fused_kernels`` on a card, instead of running something else
    than was asked for."""
    name = (args.model_name or "Miner").lower()
    if name not in _KINDS:
        raise ValueError(f"unknown --model_name {args.model_name!r}")
    policy = getattr(args, "remat_policy", "")
    if policy and not getattr(args, "remat", False):
        raise ValueError(
            f"--remat_policy {policy!r} has no effect without "
            "--remat; pass --remat (or drop --remat_policy)")
    if args.fused_kernels is False and device.type == "cuda":
        raise ValueError(
            "--no-fused_kernels with a CUDA device: on the card every path "
            "always runs the port's kernels (the plain versions run on "
            "--device cpu)")
    if args.param_dtype != "float32":
        raise NotImplementedError(
            "--param_dtype only supports float32 (fp32 master weights); "
            "use --compute_dtype bfloat16 for mixed precision")


class HistoryCache:
    """Cached-history training's schedule and cache (``--his_cache_refresh
    K``, ``--his_cache_warmup_steps W``; JAX trainer.py:694-710, 761-766),
    counted in micro-steps as JAX counts them: micro-steps below ``warmup``
    = W x accumulation train on the full history; from there on a micro-step
    gathers its history rows from ``embeddings``, rebuilt from the live
    weights before the micro-step when there is none yet (the first cached
    micro-step, and the first after a ``--resume_from``) or when the
    micro-step is a multiple of ``every`` = K x accumulation. ``fills``
    records the micro-steps of the rebuilds."""

    def __init__(self, refresh: int, warmup_steps: int, accum: int):
        self.warmup = warmup_steps * accum
        self.every = refresh * accum
        self.embeddings: Optional[torch.Tensor] = None
        self.fills = []

    def cached(self, micro_step: int) -> bool:
        return micro_step >= self.warmup

    def due(self, micro_step: int) -> bool:
        return self.embeddings is None or micro_step % self.every == 0


class Trainer:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(getattr(args, "device", None))
        _refuse_flags(args, self.device)
        # the ranks of the process group (one without a launcher) as JAX's
        # mesh; raises JAX's ValueError for a mesh that does not cover them
        self.mesh = Mesh(MeshConfig(getattr(args, "mesh_data", -1),
                                    getattr(args, "mesh_table", 1),
                                    getattr(args, "mesh_model", 1)))
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

    # ------------------------------------------------------------------ mesh
    @property
    def _data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def _share(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global batch's loss, whose gradients
        summed over the data group are the global batch's: a mean over
        rows (every kind but pretrain) times 1 / the data size; the pretrain
        kind's contrastive sum as it is. The loss itself on one data rank."""
        if self._data_size == 1 or self.kind == "pretrain":
            return loss
        return loss / self._data_size

    def _global(self, share: torch.Tensor) -> torch.Tensor:
        """The global batch's loss: the ranks' shares summed over the data
        group."""
        if self.mesh.data_group is not None:
            share = share.clone()
            torch.distributed.all_reduce(share, group=self.mesh.data_group)
        return share

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
                         gelu_approx=gelu_approx, remat=a.remat,
                         remat_policy=getattr(a, "remat_policy", ""))
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
                              dropout=a.dropout,
                              lstm_num_layers=getattr(a, "lstm_num_layers", 1),
                              lstm_dropout=getattr(a, "lstm_dropout", 0.0),
                              dtype=self.compute_dtype)
        if self.kind == "pretrain":
            encoder.reset_parameters(torch.Generator().manual_seed(a.seed))
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

    def on_mesh(self, model: nn.Module) -> nn.Module:
        """``model`` (whole, on the device) sharded over the mesh's model
        axis in place (``parallel/tp.py``); as it is without one."""
        tp.shard_(model, self.mesh)
        return model

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """``model``'s parameters whole, its shards gathered over the model
        group (a collective: every rank calls it)."""
        return tp.full_state_dict(model, self.mesh)

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
            return ServingContext(store=store, table=None, model=self.on_mesh(model), cache=None,
                                  packer=self._unbert_packer(store))
        table = self._make_table(store)
        # one cast for serving; the same bf16 values as casting at each use.
        # The Fastformer user encoder stays fp32: only its news tower casts
        cast_to_compute_(model.news_encoder if self.kind == "vanilla" else model,
                         self.compute_dtype)
        model = self.on_mesh(model.to(self.device).eval())
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
        have no identity to fingerprint and the path is ignored. Over a
        table axis every rank loads the file and keeps its shard, or fills
        its shard, and the shards are gathered into the one-device file:
        the file does not depend on the mesh."""
        a = self.args
        path = getattr(a, "serve_cache_path", None)
        if path and not a.saved_model_path:
            print("--serve_cache_path ignored: no checkpoint "
                  "(--saved_model_path) to fingerprint against")
            path = None
        fingerprint = self._serving_cache_fingerprint() if path else None
        if path:
            cache = load_cache(path, fingerprint, self.device, self.mesh)
            if cache is not None:
                print(f"serving cache loaded from {path}")
                return cache
        cache = CacheFiller(model.encode_news).fill(table, mesh=self.mesh)
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
        if self.kind in ("unbert", "vanilla"):
            if not train:
                return losses.logsigmoid_eval_loss(logits, label, row_mask)
            if self.kind == "unbert":
                return losses.binary_cross_entropy_with_logits(logits, label)
            return losses.vanilla_loss(logits, label)
        if train:
            return losses.miner_loss(interests, logits, label)
        return losses.miner_eval_loss(interests, logits, label, row_mask)

    def _call_rows(self, *arrays: np.ndarray):
        """This rank's rows of a serving call's (B, ...) arrays over the data
        axis, B padded with rows of the pad news (0) to a multiple of the
        data size; the arrays as they are on one data rank."""
        if self._data_size == 1:
            return arrays
        B = len(arrays[0])
        pad = -B % self._data_size
        padded = {str(i): np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])
                  for i, a in enumerate(arrays)}
        mine = shard_batch(self.mesh, padded)
        return tuple(mine[str(i)] for i in range(len(arrays)))

    def _call_result(self, x: torch.Tensor, B: int) -> np.ndarray:
        """A serving call's (B, ...) result from every data rank's rows."""
        return gather_batch(self.mesh, x)[:B].cpu().numpy()

    def serve_scores(self, model: nn.Module, cache: NewsEmbeddingCache,
                     cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        """Batched multi-user serving: (B, C) candidate rows + (B, H) history
        rows -> (B, C) matching scores, straight from the cache. Over a
        mesh every rank runs the call: a data rank its rows, the cache's
        rows sharded over the table axis."""
        cand, his = self._call_rows(np.asarray(cand_idx), np.asarray(his_idx))
        with torch.inference_mode():
            _, logits = self._cached_scores(model, cache, self._index(cand), self._index(his))
            return self._call_result(logits.float(), len(cand_idx))

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
        cand, his = self._call_rows(np.asarray(cand_idx, np.int32),
                                    np.asarray(his_idx, np.int32))
        hist = np.repeat(his, C, axis=0)  # (B*C, H)
        feat = pack_rows(packer, cand.reshape(-1), hist)
        with torch.inference_mode():
            logits = model(self._unbert_features(feat))
            return self._call_result(logits.float().reshape(-1, C), B)

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
        (mine,) = self._call_rows(np.asarray(his_idx))
        with torch.inference_mode():
            his = self._index(mine)
            row = torch.arange(1, C_pad + 1, dtype=torch.int32, device=self.device)
            row = torch.where(row <= C, row, 0)  # bucket tail -> pad news
            cand_idx = row[None].expand(his.shape[0], C_pad).contiguous()
            _, logits = self._cached_scores(model, cache, cand_idx, his)
            logits = torch.where(row[None] > 0, logits.float(), -torch.inf)
            vals, pos = torch.topk(logits, k, dim=-1)
            B = len(his_idx)
            return self._call_result(vals, B), self._call_result(pos + 1, B)

    def recommend(self):
        """One-shot ranking: ``--candidates`` (or the whole corpus) against
        ``--user_history``, through the same cached path as the server.
        Over a mesh every rank runs it (the same arguments, the same call)
        and rank 0 prints."""
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
        if self.mesh.rank == 0:
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
                         accum_steps=a.gradient_accumulation_steps,
                         grad_group=self.mesh.data_group,
                         replica_group=self.mesh.row_group,
                         replica_root=self.mesh.row_root,
                         sharded=frozenset(tp.specs_of(model)),
                         model_group=self.mesh.model_group,
                         shard_replica_group=self.mesh.table_group,
                         shard_replica_root=self.mesh.table_root)

    def _outputs(self, model: nn.Module, table: NewsTable, batch: Dict[str, np.ndarray],
                 rng: Optional[DropoutRNG] = None
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(interests (the Miner's) or None, logits) of a batch of index
        rows through the model, with ``rng``'s dropout; UnBERT's of a batch
        of packed rows (``table`` unused)."""
        if self.kind == "unbert":
            return None, model(self._unbert_features(batch), rng)
        out = model(table.lookup(self._index(batch["cand_idx"]),
                                 self._index(batch["his_idx"])), rng)
        return out if self.kind == "miner" else (None, out)

    def _apply_and_loss(self, model: nn.Module, table: NewsTable,
                        batch: Dict[str, np.ndarray], rng: Optional[DropoutRNG] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(training loss, logits) of a batch (``_apply_and_loss``,
        trainer.py:354-408); for the pretrain kind (loss, news vectors)."""
        if self.kind == "pretrain":
            reprs = self._pretrain_reprs(model, table, batch["cand_idx"], rng)
            return losses.pretrain_contrastive(reprs, self._num_augs), reprs
        interests, logits = self._outputs(model, table, batch, rng)
        label = torch.as_tensor(batch["label"], device=self.device)
        return self._loss(interests, logits, label, True), logits

    def _pretrain_reprs(self, model: nn.Module, table: NewsTable, cand_idx: np.ndarray,
                        rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """The (B, C, D) news vectors of (B, C) candidate rows
        (trainer.py:354-370): the B * C news through the encoder."""
        cand = table.lookup_candidates(self._index(cand_idx))
        B, C = cand["cand_title"].shape[:2]
        sapo = sapo_mask = None
        if "cand_sapo" in cand:
            sapo, sapo_mask = cand["cand_sapo"].flatten(0, 1), cand["cand_sapo_mask"].flatten(0, 1)
        return model(cand["cand_title"].flatten(0, 1), cand["cand_title_mask"].flatten(0, 1),
                     sapo, sapo_mask, rng).reshape(B, C, -1)

    def train_step(self, model: nn.Module, table: NewsTable,
                   batch: Dict[str, np.ndarray], optimizer: Optimizer,
                   micro_step: int, his_cache: Optional[HistoryCache] = None
                   ) -> torch.Tensor:
        """One micro-batch (trainer.py:410-425): forward with the dropout of
        ``micro_step``, backward into the accumulated gradients, and the
        optimizer's update when one is due. Past ``his_cache``'s warmup the
        forward is the cached-history one (``_cached_his_loss``), the cache
        rebuilt first when it is due. Over a mesh ``batch`` holds this
        rank's rows (``shard_batch``), the backward runs from its share of
        the loss and its dropout masks are its rows' of the global batch's.
        Returns the global batch's loss, on the device."""
        rng = DropoutRNG(self.args.seed + 1, micro_step, self.device, self.mesh.data_rank,
                         self._data_size)
        if his_cache is not None and his_cache.cached(micro_step):
            if his_cache.due(micro_step):
                his_cache.embeddings = self.fill_history_cache(model, table)
                his_cache.fills.append(micro_step)
            loss, _ = self._cached_his_loss(model, table, batch, his_cache.embeddings, rng)
        else:
            loss, _ = self._apply_and_loss(model, table, batch, rng)
        share = self._share(loss)
        share.backward()
        optimizer.step()
        return self._global(share.detach())

    def fill_history_cache(self, model: nn.Module, table: NewsTable) -> torch.Tensor:
        """The (R, D) news embeddings of every row of the train table from
        the live weights, as the eval cache is built (trainer.py:763-765):
        the model in eval mode (no dropout, no draw from any micro-step's
        stream), then back in its own mode; under ``no_grad``, so that the
        rows a micro-step gathers from it are ordinary tensors. Row-sharded
        over the mesh's table axis."""
        was_training = model.training
        model.eval()
        try:
            return CacheFiller(model.encode_news).fill(table, inference=False,
                                                       mesh=self.mesh).embeddings
        finally:
            model.train(was_training)

    def _cached_his_loss(self, model: nn.Module, table: NewsTable,
                         batch: Dict[str, np.ndarray], cache_emb: torch.Tensor,
                         rng: Optional[DropoutRNG] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, logits) of a cached-history micro-batch
        (``_make_cached_his_train_step``, trainer.py:427-477): the B x C
        candidates through the news encoder with the step's dropout; the
        history rows gathered from ``cache_emb``, held out of the gradient
        and cast to the candidates' type; the history categories and mask
        from the table; the model's tail with dropout; the kind's training
        loss."""
        cand_idx, his_idx = self._index(batch["cand_idx"]), self._index(batch["his_idx"])
        cand = table.lookup_candidates(cand_idx)
        B, C = cand_idx.shape
        sapo = sapo_mask = None
        if "cand_sapo" in cand:  # the table holds sapos iff the model reads them
            sapo, sapo_mask = cand["cand_sapo"].flatten(0, 1), cand["cand_sapo_mask"].flatten(0, 1)
        cand_repr = model.encode_news(cand["cand_title"].flatten(0, 1),
                                      cand["cand_title_mask"].flatten(0, 1), sapo, sapo_mask,
                                      rng).reshape(B, C, -1)
        his_repr = gather_rows(cache_emb, his_idx).detach().to(cand_repr.dtype)
        his_cat = gather_rows(table.category, his_idx)
        his_mask = (his_cat != table.category_pad_id).to(torch.int32)
        label = torch.as_tensor(batch["label"], device=self.device)
        if self.kind == "miner":
            interests, logits = model.tail(cand_repr, his_repr, cand["cand_category"], his_cat,
                                           his_mask, rng)
        else:
            interests, logits = None, model.tail(cand_repr, his_repr, his_mask, rng)
        return self._loss(interests, logits, label, True), logits

    def make_history_cache(self, log: Optional[logging.Logger] = None) -> Optional[HistoryCache]:
        """The ``HistoryCache`` of ``--his_cache_refresh`` for the kinds with
        a news-embedding cache (the Miner, Fastformer and UniSRec,
        ``_supports_cached_eval``, trainer.py:863-864); for UnBERT and the
        pretrain kind a warning and None (they train as usual), and a
        warning for ``--his_cache_warmup_steps`` without
        ``--his_cache_refresh`` (trainer.py:694-700)."""
        a = self.args
        log = log or logging.getLogger("miner_tpu_torch")
        refresh = int(getattr(a, "his_cache_refresh", 0) or 0)
        warmup = int(getattr(a, "his_cache_warmup_steps", 0) or 0)
        if refresh > 0 and self.kind not in ("miner", "vanilla"):
            log.warning("--his_cache_refresh ignored for model kind %r", self.kind)
            return None
        if refresh <= 0:
            if warmup:
                log.warning("--his_cache_warmup_steps has no effect without "
                            "--his_cache_refresh")
            return None
        return HistoryCache(refresh, warmup, max(1, a.gradient_accumulation_steps))

    def _payload(self, model: nn.Module, optimizer: Optimizer, micro_step: int) -> Dict:
        """What a checkpoint holds, in full tensors whatever the mesh: the
        model's shards and AdamW's moments of them gathered over the model
        group (a collective: every rank calls it)."""
        specs = tp.specs_of(model)
        grad_acc = None
        if optimizer.mini_step:  # mid-accumulation: keep the partial sum
            grad_acc = {n: p.grad.detach() for n, p in model.named_parameters()
                        if p.grad is not None}
            if self.mesh.data_group is not None:  # the ranks' shares summed
                grad_acc = {n: g.clone() for n, g in grad_acc.items()}
                sum_over(list(grad_acc.values()), self.mesh.data_group)
            grad_acc = {n: tp.gather(g, specs[n], self.mesh.model_group) if n in specs else g
                        for n, g in grad_acc.items()}
        return {"params": self.full_state_dict(model),
                "optimizer": tp.full_optimizer_state(optimizer.state_dict(), optimizer.names,
                                                     specs, self.mesh.model_group),
                "micro_step": micro_step, "rng_seed": self.args.seed + 1,
                "grad_acc": grad_acc, "args": _plain(vars(self.args))}

    def _resume(self, payload: Dict, model: nn.Module, optimizer: Optimizer) -> int:
        """The optimizer state and the partial gradient sum of a
        ``--resume_from`` payload (its parameters are already loaded), each
        rank taking its shares."""
        specs = tp.specs_of(model)
        state = payload["optimizer"]
        if "param_groups" not in state["adamw"]:  # converted from JAX: moments by name
            state = optimizer.by_index(state)
        optimizer.load_state_dict(tp.local_optimizer_state(state, optimizer.names, specs))
        # the partial sum is the data group's whole: one data rank takes it
        grad_acc = payload["grad_acc"] if self.mesh.data_rank == 0 else None
        grad_acc = tp.local_state_dict(grad_acc or {}, specs)
        for name, p in model.named_parameters():
            grad = grad_acc.get(name)
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
        self.run_logger = logger  # its trace() profiles into the run directory
        log = self._log = logger.logger
        log.info("device: %s, mesh: %s", self.device, self.mesh.shape)

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
        resume = checkpoint.optimizer_payload(a.resume_from) if a.resume_from else None
        if resume is not None:
            model.load_state_dict(resume["params"], strict=True)
        replicate(model)  # every rank from rank 0's parameters (checked equal)
        self.on_mesh(model)  # then each rank keeps its shares of the sharded ones
        optimizer = self.make_optimizer(model, total_updates, warmup)
        ckpt_dir = os.path.join(logger.run_dir, "ckpt")
        global_step = 0
        if resume is not None:
            global_step = self._resume(resume, model, optimizer)
            log.info("resumed from %s at step %d", a.resume_from, global_step)
        # resume is exact: a step's data and dropout are pure functions of
        # (seed, epoch) and (seed, step), so completed epochs are skipped and
        # the partial epoch's consumed batches fast-forwarded
        start_epoch = min(global_step // steps_per_epoch, a.num_train_epochs)
        skip_batches = global_step % steps_per_epoch
        # a resumed run starts without a cache, as JAX's (rebuilt at its
        # first cached micro-step)
        his_cache = self.make_history_cache(log)
        if his_cache is not None:
            log.info("cached-history training: %d full-history micro-steps, then the "
                     "cache rebuilt every %d micro-steps", his_cache.warmup, his_cache.every)

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
                loss = self.train_step(model, table, shard_batch(self.mesh, batch), optimizer,
                                       global_step, his_cache)
                global_step += 1
                ex_counter += a.train_batch_size
                epoch_losses.append(loss)
                if global_step % a.logging_steps == 0:
                    loss_v = float(loss)
                    dt = time.time() - t_last
                    # per rank, as JAX logs eps / n_devices (trainer.py:782)
                    eps = ex_counter / dt / self.mesh.size if dt > 0 else 0.0
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
        if his_cache is not None:
            log.info("history cache rebuilt at micro-steps %s", his_cache.fills)
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
        cross-encoder. Over a mesh each rank scores its rows of every batch
        (the cache row-sharded over the table axis) and the logits, with
        the Miner's interests, are gathered into the whole batch, whose loss
        and metrics every rank computes as one rank does; rank 0 writes the
        files."""
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
            cache = CacheFiller(model.encode_news).fill(table, mesh=self.mesh)
        total_loss = 0.0
        with torch.inference_mode():
            for batch in batcher.batches(block):
                valid = int(batch.pop("valid"))
                B = len(batch["label"])
                row_mask = torch.arange(B, device=self.device) < valid
                interests, logits = self._eval_outputs(model, table, cache,
                                                       shard_batch(self.mesh, batch))
                if interests is not None:
                    interests = gather_batch(self.mesh, interests)
                logits = gather_batch(self.mesh, logits)
                label = torch.as_tensor(batch["label"], device=self.device)
                loss = self._loss(interests, logits, label, False, row_mask)
                total_loss += float(loss)
                if "metrics" in self.eval_info:
                    evaluator.eval_batch(logits.float().cpu().numpy(),
                                         batch["impression_id"], valid=valid)
        model.train(was_training)
        scores = {}
        if "metrics" in self.eval_info:
            scores = evaluator.compute_scores(
                a.metrics, save_result=a.save_eval_result and logger.writer,
                path=logger.run_dir)
        eval_loss = total_loss if "loss" in self.eval_info else None
        logger.log_eval(epoch, step, scores, eval_loss)
        if "metrics" in self.eval_info and logger.writer:
            if a.save_eval_result and hasattr(evaluator, "save_predictions"):
                evaluator.save_predictions(logger.run_dir)
            if a.save_ranking and hasattr(evaluator, "save_ranking"):
                evaluator.save_ranking(logger.run_dir)
        return scores, eval_loss

    def _eval_outputs(self, model: nn.Module, table: NewsTable,
                      cache: Optional[NewsEmbeddingCache], batch: Dict[str, np.ndarray]
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(interests (the Miner's) or None, logits) of an eval batch (this
        rank's rows of it over a mesh): from ``cache`` when given, else
        through the model (``_outputs``)."""
        if cache is not None:
            return self._cached_scores(model, cache, self._index(batch["cand_idx"]),
                                       self._index(batch["his_idx"]))
        return self._outputs(model, table, batch)

    def _run_pretrain_eval(self, model: nn.Module, table: NewsTable, block,
                           num_augs: int, logger: RunLogger, epoch: int,
                           step: int) -> float:
        """The pretrain kind's eval (trainer.py:499-548): the contrastive
        loss summed over the batches of ``block``, the padded tail's rows
        masked, logged to eval.csv with no ranking metrics. Over a mesh each
        rank encodes its rows and the news vectors are gathered into the
        whole batch."""
        batcher = Batcher(self.args.eval_batch_size, drop_last=False, shuffle=False)
        was_training = model.training
        model.eval()
        total = 0.0
        with torch.inference_mode():
            for batch in batcher.batches(block):
                valid = int(batch.pop("valid"))
                B = len(batch["cand_idx"])
                row_mask = torch.arange(B, device=self.device) < valid
                reprs = self._pretrain_reprs(model, table,
                                             shard_batch(self.mesh, batch)["cand_idx"])
                loss = losses.pretrain_contrastive(gather_batch(self.mesh, reprs),
                                                   num_augs, row_mask)
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
        model = self.on_mesh(self.restored_model().to(self.device).eval())
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
