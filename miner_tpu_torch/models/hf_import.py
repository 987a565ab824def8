"""Importing pretrained weights (HF BERT/RoBERTa towers, UniSRec
artifacts), and checkpoints to and from the reference (MrRobot2211/miner).

Counterpart of ``miner_tpu/models/hf_import.py``. The trainer's half:

  * ``load_plm_into(plm, checkpoint_dir)`` (``load_into_params``,
    :895-933): a transformers state dict (``model.safetensors`` or
    ``pytorch_model.bin`` in a local directory, any ``roberta.`` /
    ``bert.`` / ``model.`` prefix stripped) into a ``TransformerPLM``. Q, K
    and V are fused on the ``nn.Linear`` weight's row axis in q|k|v order,
    with no transpose: HF and the port both store (out, in). The layer
    count is read from the module; a shape mismatch raises, naming the key;
  * ``load_unisrec_pretrained(model, path)`` (:809-892): a UniSRec
    ``.pth`` grafted into a ``UniSRec`` with ``strict=False`` semantics
    (only keys both hold are replaced; a shape mismatch raises). Two
    layouts: RecBole's (top-level ``moe_adaptor.*``, ``position_embedding``,
    ``trm_encoder.*``, ``LayerNorm``; no news tower, no layout gate) and the
    full reference model's (``news_encoder.roberta.*`` or ``.bert.*`` too),
    which is history-layout sensitive: a marker the JAX package's export
    writes (``HISTORY_LAYOUT_MARKER``) must match ``--legacy_history_layout``
    unless ``--force_layout_mismatch``, and an unmarked one needs either.
    The experts' per-expert ``lin.weight`` (D_out, D_in) stack into the
    (E, D_in, D_out) ``experts.kernel``.

The converters of whole reference checkpoints, which
``miner_tpu_torch/tools/import_reference_checkpoint.py`` and
``export_to_reference.py`` run: ``convert_miner_state_dict`` /
``export_miner_state_dict`` (:190-348), ``convert_fastformer_state_dict`` /
``export_fastformer_state_dict`` (:349-468), ``convert_unbert_state_dict`` /
``export_unbert_state_dict`` (:469-560), ``export_plm_state_dict``
(:267-296) and ``export_unisrec_state_dict`` (:734-808; its import is
``unisrec_model_state_dict``). Both sides are torch state dicts, so they map
the reference's names onto the port's module names (those
``models.convert.params_from_jax`` gives the JAX tree): a ``Linear.weight``
keeps its (out, in) layout, the fused qkv rows are the reference's query,
key and value concatenated (and split back on export), poly-attention's
``proj_kernel`` and the Fastformer's ``*_att_kernel`` are the transposes of
the reference's ``weight``. They keep the JAX package's refusals word for
word: a ``--combine_type lstm`` checkpoint, and the history-layout gate of
the position-sensitive models.

``safetensors`` is imported only when a ``model.safetensors`` is there.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch
import torch.nn as nn

HISTORY_LAYOUT_MARKER = "_miner_tpu_history_layout"
POSITION_SENSITIVE_MODELS = ("fastformer", "unbert", "unisrec")

StateDict = Dict[str, torch.Tensor]


def _load_state_dict(checkpoint_dir: str) -> StateDict:
    st_path = os.path.join(checkpoint_dir, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    bin_path = os.path.join(checkpoint_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights found in {checkpoint_dir}")


def _strip_prefix(sd: StateDict) -> StateDict:
    for prefix in ("roberta.", "bert.", "model."):
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


# the sub-modules of a post-LN layer in the two torch layouts: the attention
# whose query, key and value the port fuses, then (torch name, port name)
# for the rest
BERT_LAYER = ("attention.self", (
    ("attention.output.dense", "attention.out"), ("attention.output.LayerNorm", "attention_ln"),
    ("intermediate.dense", "ffn_in"), ("output.dense", "ffn_out"),
    ("output.LayerNorm", "ffn_ln")))
RECBOLE_LAYER = ("multi_head_attention", (
    ("multi_head_attention.dense", "attention.out"),
    ("multi_head_attention.LayerNorm", "attention_ln"), ("feed_forward.dense_1", "ffn_in"),
    ("feed_forward.dense_2", "ffn_out"), ("feed_forward.LayerNorm", "ffn_ln")))
_QKV = ("query", "key", "value")


def _fused_layer(sd: StateDict, p: str, layout, out: str) -> StateDict:
    """One post-LN layer under the torch prefix ``p`` in ``layout``
    (``BERT_LAYER`` or ``RECBOLE_LAYER``) -> the port's
    ``TransformerLayer`` keys under ``out``, QKV fused."""
    attn, rest = layout
    state = {}
    for suffix in ("weight", "bias"):
        state[f"{out}attention.qkv.{suffix}"] = torch.cat(
            [sd[f"{p}{attn}.{n}.{suffix}"] for n in _QKV])
        for src, name in rest:
            state[f"{out}{name}.{suffix}"] = sd[f"{p}{src}.{suffix}"]
    return state


def _split_layer(state: StateDict, p: str, layout, out: str) -> StateDict:
    """Inverse of :func:`_fused_layer`: the port's layer keys under ``p``
    -> the torch keys of ``layout`` under ``out``, QKV split."""
    attn, rest = layout
    sd = {}
    for suffix in ("weight", "bias"):
        for name, part in zip(_QKV, state[f"{p}attention.qkv.{suffix}"].chunk(3)):
            sd[f"{out}{attn}.{name}.{suffix}"] = part
        for dst, name in rest:
            sd[f"{out}{dst}.{suffix}"] = state[f"{p}{name}.{suffix}"]
    return sd


def _layers(state: StateDict, prefix: str) -> int:
    """How many layers ``{prefix}{i}.`` the port's state dict holds."""
    n = 0
    while f"{prefix}{n}.attention.qkv.weight" in state:
        n += 1
    return n


def _sub(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def plm_state_dict(sd: StateDict, num_layers: int, prefix: str = "") -> StateDict:
    """A transformers BERT/RoBERTa state dict (prefix stripped) -> the
    port's ``TransformerPLM`` state dict, its keys under ``prefix``."""
    state = {f"{prefix}embeddings.{name}.weight": sd[f"embeddings.{name}.weight"]
             for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    state[f"{prefix}embeddings.ln.weight"] = sd["embeddings.LayerNorm.weight"]
    state[f"{prefix}embeddings.ln.bias"] = sd["embeddings.LayerNorm.bias"]
    for i in range(num_layers):
        state.update(_fused_layer(sd, f"encoder.layer.{i}.", BERT_LAYER,
                                  f"{prefix}layers.{i}."))
    return state


def export_plm_state_dict(plm: StateDict, prefix: str = "") -> StateDict:
    """A ``TransformerPLM`` state dict -> a transformers-format one, its
    keys under ``prefix``: the exact inverse of :func:`plm_state_dict`."""
    sd = {f"{prefix}embeddings.{name}.weight": plm[f"embeddings.{name}.weight"]
          for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    sd[f"{prefix}embeddings.LayerNorm.weight"] = plm["embeddings.ln.weight"]
    sd[f"{prefix}embeddings.LayerNorm.bias"] = plm["embeddings.ln.bias"]
    for i in range(_layers(plm, "layers.")):
        sd.update(_split_layer(plm, f"layers.{i}.", BERT_LAYER,
                               f"{prefix}encoder.layer.{i}."))
    return sd


def _check_shapes(own: StateDict, new: StateDict, where: str) -> None:
    for key, value in new.items():
        if key in own and tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {where}{key}: {tuple(own[key].shape)} "
                             f"vs checkpoint {tuple(value.shape)}")


def load_plm_into(plm: nn.Module, checkpoint_dir: str) -> None:
    """Replace every parameter of the ``TransformerPLM`` ``plm`` with the
    HF checkpoint's in ``checkpoint_dir`` (loaded strictly after the shape
    check)."""
    new = plm_state_dict(_strip_prefix(_load_state_dict(checkpoint_dir)), len(plm.layers))
    _check_shapes(plm.state_dict(), new, "plm.")
    plm.load_state_dict(new, strict=True)


def unisrec_state_dict(sd: StateDict) -> StateDict:
    """A RecBole-layout UniSRec state dict -> the port's ``UniSRec`` keys,
    for the keys present: the sequential encoder, its position table and
    LayerNorm, and the MoE adaptor (hf_import.py:561-653)."""
    state = {}
    if "position_embedding.weight" in sd:
        state["position_embedding.weight"] = sd["position_embedding.weight"]
    if "LayerNorm.weight" in sd:
        state["ln.weight"], state["ln.bias"] = sd["LayerNorm.weight"], sd["LayerNorm.bias"]
    i = 0
    while f"trm_encoder.layer.{i}.multi_head_attention.query.weight" in sd:
        state.update(_fused_layer(sd, f"trm_encoder.layer.{i}.", RECBOLE_LAYER,
                                  f"trm_layers.{i}."))
        i += 1
    n_exps = 0
    while f"moe_adaptor.experts.{n_exps}.lin.weight" in sd:
        n_exps += 1
    if n_exps:
        moe = "news_encoder.moe_adaptor."
        state[moe + "experts.bias"] = torch.stack(
            [sd[f"moe_adaptor.experts.{e}.bias"] for e in range(n_exps)])
        state[moe + "experts.kernel"] = torch.stack(
            [sd[f"moe_adaptor.experts.{e}.lin.weight"].T for e in range(n_exps)])
        for name in ("w_gate", "w_noise"):
            if f"moe_adaptor.{name}" in sd:
                state[moe + name] = sd[f"moe_adaptor.{name}"]
    return state


def unisrec_model_state_dict(sd: StateDict, num_layers: int) -> StateDict:
    """A full reference-model UniSRec state dict (``news_encoder.roberta.*``
    or ``.bert.*``, ``news_encoder.moe_adaptor.*``, the sequential encoder)
    -> the port's ``UniSRec`` keys (hf_import.py:685-732); ``num_layers``
    is the tower's depth."""
    sub = {k: v for k, v in sd.items() if not k.startswith("news_encoder.")}
    sub.update({k[len("news_encoder."):]: v for k, v in sd.items()
                if k.startswith("news_encoder.moe_adaptor.")})
    state = unisrec_state_dict(sub)
    # the reference's attribute is named ``roberta`` even over a BertModel
    state.update(plm_state_dict(_tower(sd), num_layers, "news_encoder.plm."))
    for suffix in ("weight", "bias"):
        key = f"news_encoder.linear_combine.{suffix}"
        if key in sd:
            state[key] = sd[key]
    return state


def check_history_layout_for_transfer(model_name: str, legacy_layout: bool,
                                      force: bool = False) -> None:
    """Refuse a reference checkpoint of a position-sensitive model
    (hf_import.py:652-683) unless the run uses the reference's pads-first
    history rows (``--legacy_history_layout``) or ``force``: the reference
    prepends pad news to every history, the default here is clicks-first,
    and UniSRec's position-0 user vector, UnBERT's packer and the
    Fastformer's positions compute another function under the other."""
    if model_name not in POSITION_SENSITIVE_MODELS or legacy_layout or force:
        return
    raise ValueError(
        f"{model_name} is position-sensitive in the history layout: the reference "
        "prepends pad news (src/reader.py:154) while this framework's default is "
        "clicks-first (PARITY.md deviations). A transferred checkpoint only "
        "reproduces the reference's function when run with --legacy_history_layout. "
        "Pass --legacy_history_layout to acknowledge that recipe, or "
        "--force_layout_mismatch to transfer anyway (the model will see a shifted "
        "input distribution).")


_TOWER_LAYER = re.compile(r"news_encoder\.(?:roberta|bert)\.encoder\.layer\.(\d+)\.")


def load_unisrec_pretrained(model: nn.Module, pth_path: str,
                            legacy_layout: bool = False, force: bool = False) -> int:
    """Graft the UniSRec artifact at ``pth_path`` into ``model`` (a
    ``UniSRec``): the keys both hold, each shape-checked. Returns the
    number of tensors loaded."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    marker = sd.pop(HISTORY_LAYOUT_MARKER, None)
    sd = {k: v for k, v in sd.items() if not k.startswith("_miner_tpu")}
    layer_ids = [int(m.group(1)) for m in map(_TOWER_LAYER.match, sd) if m]
    if layer_ids:
        if marker is not None:
            artifact_legacy = bool(int(marker.reshape(-1)[0]))
            if artifact_legacy != bool(legacy_layout) and not force:
                name = {True: "legacy (pads-first)", False: "clicks-first"}
                raise ValueError(
                    f"UniSRec artifact {pth_path} was trained under the "
                    f"{name[artifact_legacy]} history layout but this run uses "
                    f"{name[bool(legacy_layout)]}: the position-0 user vector would "
                    "read a different history slot than the one it was trained on. "
                    "Match the layout (--legacy_history_layout) or pass "
                    "--force_layout_mismatch to load anyway.")
        else:
            check_history_layout_for_transfer("unisrec", legacy_layout, force=force)
        new = unisrec_model_state_dict(sd, max(layer_ids) + 1)
    else:
        new = unisrec_state_dict(sd)
    own = model.state_dict()
    new = {k: v for k, v in new.items() if k in own}
    _check_shapes(own, new, "")
    model.load_state_dict(new, strict=False)
    return len(new)


# ------------------------------------------------- whole reference checkpoints
LSTM_IMPORT_REFUSAL = (
    "cannot import a --combine_type lstm checkpoint: the reference's "
    "lstm combiner feeds a 2-D tensor into nn.LSTM (unbatched-"
    "sequence semantics; reference: src/model/news_encoder.py:52-56, "
    "100-104) while ours is a BiLSTM over the [title, sapo] pair — "
    "the weight shapes are architecturally incompatible (see "
    "PARITY.md deviations). Retrain, or use combine_type linear.")
LSTM_EXPORT_REFUSAL = (
    "cannot export a --combine_type lstm model to the reference "
    "format: our BiLSTM-over-[title, sapo] combiner is a deliberate "
    "redesign of the reference's broken unbatched nn.LSTM path "
    "(reference: src/model/news_encoder.py:52-56, 100-104) — the "
    "weight shapes are architecturally incompatible (see PARITY.md "
    "deviations).")
_DENSE = ("weight", "bias")


def _tower(sd: StateDict) -> StateDict:
    """The reference news encoder's PLM keys (its attribute is ``roberta``
    even over a BertModel; ``bert`` too), prefix stripped."""
    for tower in ("news_encoder.roberta.", "news_encoder.bert."):
        plm = _sub(sd, tower)
        if plm:
            return plm
    return {}


def _convert_news_encoder(sd: StateDict, num_layers: int) -> StateDict:
    """The reference ``NewsEncoder`` keys (under ``news_encoder.``) -> the
    port's, under ``news_encoder.`` (hf_import.py:190-226)."""
    if any(k.startswith("news_encoder.lstm.") for k in sd):
        raise ValueError(LSTM_IMPORT_REFUSAL)
    state = plm_state_dict(_tower(sd), num_layers, "news_encoder.plm.")
    for name in ("reduce_dim", "linear_combine"):
        if f"news_encoder.{name}.weight" in sd:
            for suffix in _DENSE:
                key = f"news_encoder.{name}.{suffix}"
                state[key] = sd[key]
    return state


def _export_news_encoder(state: StateDict, plm_name: str) -> StateDict:
    """Inverse of :func:`_convert_news_encoder`."""
    if any(k.startswith("news_encoder.lstm_combine.") for k in state):
        raise ValueError(LSTM_EXPORT_REFUSAL)
    sd = export_plm_state_dict(_sub(state, "news_encoder.plm."),
                               f"news_encoder.{plm_name}.")
    for name in ("reduce_dim", "linear_combine"):
        if f"news_encoder.{name}.weight" in state:
            for suffix in _DENSE:
                key = f"news_encoder.{name}.{suffix}"
                sd[key] = state[key]
    return sd


def convert_miner_state_dict(sd: StateDict, num_layers: int) -> StateDict:
    """A reference-format MINER state dict -> the port's ``Miner`` state
    dict (hf_import.py:229-264): the news tower with its QKV fused,
    poly-attention's ``linear.weight`` transposed into ``proj_kernel``, the
    context codes, the category embedding and the target-aware projection
    when there."""
    state = _convert_news_encoder(sd, num_layers)
    state["poly_attn.proj_kernel"] = sd["poly_attn.linear.weight"].T.contiguous()
    state["poly_attn.context_codes"] = sd["poly_attn.context_codes"]
    if "category_embedding.weight" in sd:
        state["category_embedding.weight"] = sd["category_embedding.weight"]
    if "target_aware_attn.linear.weight" in sd:
        state["target_aware_attn.proj.weight"] = sd["target_aware_attn.linear.weight"]
    return state


def export_miner_state_dict(state: StateDict, plm_name: str = "roberta") -> StateDict:
    """The port's ``Miner`` state dict -> a reference-format one, the exact
    inverse of :func:`convert_miner_state_dict` (hf_import.py:323-348); the
    reference loads it with ``load_state_dict(..., strict=False)``."""
    sd = _export_news_encoder(state, plm_name)
    sd["poly_attn.linear.weight"] = state["poly_attn.proj_kernel"].T.contiguous()
    sd["poly_attn.context_codes"] = state["poly_attn.context_codes"]
    if "category_embedding.weight" in state:
        sd["category_embedding.weight"] = state["category_embedding.weight"]
    if "target_aware_attn.proj.weight" in state:
        sd["target_aware_attn.linear.weight"] = state["target_aware_attn.proj.weight"]
    return sd


# the Fastformer user encoder's keys: (reference under fast_attn., port under
# fast_attn.) for the Dense / LayerNorm / embedding modules outside the layers,
# and within a layer (encoders.{i}. / layers.{i}.); the attention's two
# additive-attention projections are transposed into (D, h) kernels
_FF_TOP = (("position_embeddings", "position_embeddings"), ("LayerNorm", "ln"),
           ("poolers.0.att_fc1", "pooler.fc1"), ("poolers.0.att_fc2", "pooler.fc2"))
_FF_LAYER = (("attention.self.query", "self_attn.query"),
             ("attention.self.key", "self_attn.key"),
             ("attention.self.transform", "self_attn.transform"),
             ("attention.output.dense", "attn_out"), ("attention.output.LayerNorm", "attn_ln"),
             ("intermediate.dense", "ffn_in"), ("output.dense", "ffn_out"),
             ("output.LayerNorm", "ffn_ln"))
_FF_ATT = ("query_att", "key_att")


def _moved(src: StateDict, pairs, src_prefix: str, dst_prefix: str) -> StateDict:
    """Every ``weight`` / ``bias`` of ``pairs`` (src name, dst name) that
    ``src`` holds under ``src_prefix``, renamed under ``dst_prefix``."""
    return {f"{dst_prefix}{b}.{suffix}": src[f"{src_prefix}{a}.{suffix}"]
            for a, b in pairs for suffix in _DENSE if f"{src_prefix}{a}.{suffix}" in src}


def convert_fastformer_state_dict(sd: StateDict, num_layers: int) -> StateDict:
    """A reference-format Fastformer state dict -> the port's
    ``FastformerUserModel`` state dict (hf_import.py:349-420); the
    Fastformer's layer count is read from the dict."""
    state = _convert_news_encoder(sd, num_layers)
    state.update(_moved(sd, _FF_TOP, "fast_attn.", "fast_attn."))
    i = 0
    while f"fast_attn.encoders.{i}.attention.self.query.weight" in sd:
        p, q = f"fast_attn.encoders.{i}.", f"fast_attn.layers.{i}."
        state.update(_moved(sd, _FF_LAYER, p, q))
        for att in _FF_ATT:
            state[f"{q}self_attn.{att}_kernel"] = sd[f"{p}attention.self.{att}.weight"].T.contiguous()
            state[f"{q}self_attn.{att}_bias"] = sd[f"{p}attention.self.{att}.bias"]
        i += 1
    return state


def export_fastformer_state_dict(state: StateDict, plm_name: str = "roberta") -> StateDict:
    """The exact inverse of :func:`convert_fastformer_state_dict`
    (hf_import.py:422-468)."""
    sd = _export_news_encoder(state, plm_name)
    sd.update(_moved(state, [(b, a) for a, b in _FF_TOP], "fast_attn.", "fast_attn."))
    i = 0
    while f"fast_attn.layers.{i}.self_attn.query.weight" in state:
        p, q = f"fast_attn.layers.{i}.", f"fast_attn.encoders.{i}."
        sd.update(_moved(state, [(b, a) for a, b in _FF_LAYER], p, q))
        for att in _FF_ATT:
            sd[f"{q}attention.self.{att}.weight"] = state[f"{p}self_attn.{att}_kernel"].T.contiguous()
            sd[f"{q}attention.self.{att}.bias"] = state[f"{p}self_attn.{att}_bias"]
        i += 1
    return sd


# UnBERT's keys outside its layers: (reference, port)
_UNBERT_TOP = (("_model.embeddings.word_embeddings", "word_embeddings"),
               ("_model.embeddings.position_embeddings", "position_embeddings"),
               ("_model.embeddings.token_type_embeddings", "token_type_embeddings"),
               ("_model.embeddings.segment_embeddings", "news_segment_embeddings"),
               ("_model.embeddings.LayerNorm", "emb_ln"), ("_dense", "score_head"),
               ("att.0", "att_mapping_in"), ("att.2", "att_mapping_out"))
# its two stacks: (reference prefix, port prefix)
_UNBERT_STACKS = (("_model.encoder.layer.", "word_layers."),
                  ("_model.encoder_news.layer.", "news_layers."))


def convert_unbert_state_dict(sd: StateDict) -> StateDict:
    """A reference-format UNBERT state dict -> the port's ``UNBert`` state
    dict (hf_import.py:469-520): the unused ``_model.pooler.*`` is dropped;
    the layer counts are read from the dict."""
    state = _moved(sd, _UNBERT_TOP, "", "")
    for ref, port in _UNBERT_STACKS:
        i = 0
        while f"{ref}{i}.attention.self.query.weight" in sd:
            state.update(_fused_layer(sd, f"{ref}{i}.", BERT_LAYER, f"{port}{i}."))
            i += 1
    return state


def export_unbert_state_dict(state: StateDict) -> StateDict:
    """The exact inverse of :func:`convert_unbert_state_dict`
    (hf_import.py:523-560); the reference's ``strict=False`` load
    regenerates the pooler it never scores with."""
    sd = _moved(state, [(b, a) for a, b in _UNBERT_TOP], "", "")
    for ref, port in _UNBERT_STACKS:
        for i in range(_layers(state, port)):
            sd.update(_split_layer(state, f"{port}{i}.", BERT_LAYER, f"{ref}{i}."))
    return sd


def export_unisrec_state_dict(state: StateDict, plm_name: str = "roberta",
                              history_layout: Optional[str] = "clicks_first") -> StateDict:
    """The port's ``UniSRec`` state dict -> a full reference-format one, the
    exact inverse of :func:`unisrec_model_state_dict` (hf_import.py:
    734-808): the (E, D_in, D_out) experts unstack into per-expert
    ``lin.weight`` / ``bias``, the fused QKV splits into RecBole's
    spellings, and ``history_layout`` ("clicks_first" or "legacy"; None
    omits it) is recorded as a one-element int8 tensor under
    ``HISTORY_LAYOUT_MARKER``, which :func:`load_unisrec_pretrained`
    checks."""
    sd = export_plm_state_dict(_sub(state, "news_encoder.plm."), f"news_encoder.{plm_name}.")
    moe = "news_encoder.moe_adaptor."
    for name in ("w_gate", "w_noise"):
        sd[moe + name] = state[moe + name]
    kernel, bias = state[moe + "experts.kernel"], state[moe + "experts.bias"]
    for i in range(kernel.shape[0]):
        sd[f"{moe}experts.{i}.lin.weight"] = kernel[i].T.contiguous()
        sd[f"{moe}experts.{i}.bias"] = bias[i]
    if "news_encoder.linear_combine.weight" in state:
        for suffix in _DENSE:
            key = f"news_encoder.linear_combine.{suffix}"
            sd[key] = state[key]
    sd["position_embedding.weight"] = state["position_embedding.weight"]
    sd["LayerNorm.weight"], sd["LayerNorm.bias"] = state["ln.weight"], state["ln.bias"]
    for i in range(_layers(state, "trm_layers.")):
        sd.update(_split_layer(state, f"trm_layers.{i}.", RECBOLE_LAYER,
                               f"trm_encoder.layer.{i}."))
    if history_layout is not None:
        if history_layout not in ("clicks_first", "legacy"):
            raise ValueError(f"unknown history_layout {history_layout!r}")
        sd[HISTORY_LAYOUT_MARKER] = torch.tensor([int(history_layout == "legacy")],
                                                 dtype=torch.int8)
    return sd
