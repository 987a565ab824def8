"""Carrying weights over from the JAX package (the role of its hf_import.py).

``params_from_jax`` takes a JAX parameter tree as nested dicts of numpy
arrays, as ``jax.device_get(params)`` gives them, and returns a state dict
for the matching module of the port: the Miner's or the
``FastformerUserModel``'s or the ``UNBert``'s tree for those models, or a
subtree for the matching sub-module (``params["news_encoder"]["plm"]`` for
a ``TransformerPLM``). The layouts differ in three ways:

  * a flax ``Dense`` stores ``kernel`` as (in, out); ``nn.Linear`` stores
    ``weight`` as (out, in). Each rank-2 ``kernel`` becomes ``weight``,
    transposed; the fused ``qkv`` kernel (D, 3D) becomes a (3D, D) weight
    whose rows stay in q|k|v order;
  * flax ``Embed`` tables (``embedding``) and LayerNorm ``scale`` become
    ``weight``;
  * an unrolled layer stack ``layer_{i}`` becomes ``layers.{i}``, UnBERT's
    two stacks ``word_layer_{i}`` and ``news_layer_{i}`` become
    ``word_layers.{i}`` and ``news_layers.{i}``, and UniSRec's
    ``trm_layer_{i}`` become ``trm_layers.{i}``.

Other leaves (LayerNorm and Dense ``bias``, poly-attention's
``proj_kernel`` and ``context_codes``, the Fastformer's
``query_att_kernel`` / ``key_att_kernel`` (D, h) and their biases, the MoE
adaptor's ``w_gate`` / ``w_noise`` (D_in, E) and ``experts/bias`` (E,
D_in)) keep their names and layouts. So does the MoE adaptor's rank-3
``experts/kernel``: it stays ``kernel``, in its (E, D_in, D_out) axis
order, which ``PWExperts`` takes as it is. Load the result with
``load_state_dict(strict=True)``. ``miner_params_from_jax`` is the same
function under its first name.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"((?:word_|news_|trm_)?layer)_(\d+)$")


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                m = _LAYER.match(name)
                sub = f"{m.group(1)}s.{m.group(2)}" if m else name
                walk(value, f"{prefix}{sub}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel" and arr.ndim == 2:
                name, arr = "weight", arr.T
            elif name in ("embedding", "scale"):
                name = "weight"
            state[prefix + name] = torch.tensor(arr)  # a contiguous copy

    walk(params, "")
    return state


miner_params_from_jax = params_from_jax
