"""Importing pretrained weights: HF BERT/RoBERTa towers and UniSRec
artifacts.

Counterpart of the trainer-facing part of ``miner_tpu/models/hf_import.py``:

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

``safetensors`` is imported only when a ``model.safetensors`` is there.
The export functions and the reference-checkpoint converters, which only
``tools/`` uses, are not ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import os
import re
from typing import Dict

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


def _fused_layer(sd: StateDict, p: str, attn: str, attn_out: str, attn_ln: str,
                 ffn_in: str, ffn_out: str, ffn_ln: str, out: str) -> StateDict:
    """One post-LN layer under the torch prefix ``p`` (the sub-module names
    given) -> the port's ``TransformerLayer`` keys under ``out``, QKV fused."""
    state = {}
    for suffix in ("weight", "bias"):
        state[f"{out}attention.qkv.{suffix}"] = torch.cat(
            [sd[f"{p}{attn}.{n}.{suffix}"] for n in ("query", "key", "value")])
        for name, src in (("attention.out", attn_out), ("attention_ln", attn_ln),
                          ("ffn_in", ffn_in), ("ffn_out", ffn_out), ("ffn_ln", ffn_ln)):
            state[f"{out}{name}.{suffix}"] = sd[f"{p}{src}.{suffix}"]
    return state


def plm_state_dict(sd: StateDict, num_layers: int, prefix: str = "") -> StateDict:
    """A transformers BERT/RoBERTa state dict (prefix stripped) -> the
    port's ``TransformerPLM`` state dict, its keys under ``prefix``."""
    state = {f"{prefix}embeddings.{name}.weight": sd[f"embeddings.{name}.weight"]
             for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    state[f"{prefix}embeddings.ln.weight"] = sd["embeddings.LayerNorm.weight"]
    state[f"{prefix}embeddings.ln.bias"] = sd["embeddings.LayerNorm.bias"]
    for i in range(num_layers):
        state.update(_fused_layer(
            sd, f"encoder.layer.{i}.", "attention.self", "attention.output.dense",
            "attention.output.LayerNorm", "intermediate.dense", "output.dense",
            "output.LayerNorm", f"{prefix}layers.{i}."))
    return state


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
        state.update(_fused_layer(
            sd, f"trm_encoder.layer.{i}.", "multi_head_attention",
            "multi_head_attention.dense", "multi_head_attention.LayerNorm",
            "feed_forward.dense_1", "feed_forward.dense_2", "feed_forward.LayerNorm",
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
    for tower in ("news_encoder.roberta.", "news_encoder.bert."):
        plm_sd = {k[len(tower):]: v for k, v in sd.items() if k.startswith(tower)}
        if plm_sd:
            break
    state.update(plm_state_dict(plm_sd, num_layers, "news_encoder.plm."))
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
