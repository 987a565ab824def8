"""The news-embedding cache, on one device.

Counterpart of ``miner_tpu/parallel/news_cache.py``: the news encoder runs
once over the whole corpus, producing a (N, D) table of news embeddings;
each serving request then gathers rows from it and runs only the model's
tail (zero PLM calls per request). ``CacheFiller`` encodes the corpus in
chunks of 512 news with a Python loop (the JAX package's ``lax.scan``).
``Int8Rows`` stores the table as int8 rows with a scale each (half the
bytes of bf16); ``save_cache`` / ``load_cache`` persist a serving cache so
that a restart skips the corpus encode. Mesh placement is not ported yet
(ROADMAP Queue 1: multi-GPU).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from miner_tpu_torch.data.device_table import NewsTable

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_NAMED_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


@dataclasses.dataclass
class Int8Rows:
    """Per-row symmetric int8 quantization of a (R, D) embedding table:
    ``values[r] = round(emb[r] / scales[r])`` with ``scales[r] =
    absmax(emb[r]) / 127``. A score is linear in the row, so the scale is
    applied to the dot product's result: lookup+score reads int8 rows and
    no dequantized copy of a gather is built. ``gather_rows`` dequantizes
    the rows it gathers to ``dequant_dtype`` (the name of a torch dtype, as
    the JAX package names it: "float32", "bfloat16")."""

    values: torch.Tensor  # (R, D) int8
    scales: torch.Tensor  # (R, 1) float32
    dequant_dtype: str = "float32"

    @property
    def shape(self):
        return self.values.shape


def quantize_rows(emb: torch.Tensor) -> Int8Rows:
    """Quantize a (R, D) table to :class:`Int8Rows` that dequantize to its
    type (per-row absmax; an all-zero row, such as the pad news, gets scale
    1). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    f = emb.float()
    scales = f.abs().amax(dim=1, keepdim=True) / 127.0
    scales = torch.where(scales == 0.0, 1.0, scales)
    values = torch.clamp(torch.round(f / scales), -127, 127).to(torch.int8)
    return Int8Rows(values, scales, _DTYPE_NAMES[emb.dtype])


def gather_rows(table: Union[torch.Tensor, Int8Rows], idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (R, ...) table for an index tensor of any shape; the rows
    of an :class:`Int8Rows` table dequantized to its ``dequant_dtype`` as
    ``q.to(dt) * s.to(dt)``."""
    if isinstance(table, Int8Rows):
        dt = _NAMED_DTYPES[table.dequant_dtype]
        return gather_rows(table.values, idx).to(dt) * gather_rows(table.scales, idx).to(dt)
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


def gathered_dtype(table: Union[torch.Tensor, Int8Rows]) -> torch.dtype:
    """The type of the rows ``gather_rows`` gives from ``table``."""
    if isinstance(table, Int8Rows):
        return _NAMED_DTYPES[table.dequant_dtype]
    return table.dtype


@dataclasses.dataclass
class NewsEmbeddingCache:
    embeddings: Union[torch.Tensor, Int8Rows]  # (R, D) in the compute type, or int8 rows
    category: torch.Tensor  # (R,) int32
    category_pad_id: int

    @property
    def quantized(self) -> bool:
        return isinstance(self.embeddings, Int8Rows)

    def quantize(self) -> "NewsEmbeddingCache":
        """The int8 version of this cache (itself if already quantized)."""
        if self.quantized:
            return self
        return dataclasses.replace(self, embeddings=quantize_rows(self.embeddings))

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]


def save_cache(cache: NewsEmbeddingCache, path: str, num_rows: int,
               fingerprint: dict) -> None:
    """Persist the corpus cache as ``.npz`` in the JAX package's layout
    (``embeddings``, ``category``, for int8 ``scales``, and a JSON ``meta``
    holding the caller's ``fingerprint``, the dtype, ``num_rows`` and
    ``category_pad_id``), written to ``path + ".tmp.npz"`` and renamed, so
    a reader never sees half a file. bfloat16 travels as its raw bits in
    uint16, the dtype named in the metadata."""
    arrays = {}
    if cache.quantized:
        q = cache.embeddings
        arrays["embeddings"] = q.values[:num_rows].cpu().numpy()
        arrays["scales"] = q.scales[:num_rows].cpu().numpy()
        dtype = f"int8:{q.dequant_dtype}"
    else:
        emb = cache.embeddings[:num_rows].cpu()
        dtype = _DTYPE_NAMES[emb.dtype]
        if emb.dtype == torch.bfloat16:
            emb = emb.view(torch.int16).numpy().view(np.uint16)
        else:
            emb = emb.numpy()
        arrays["embeddings"] = emb
    meta = dict(fingerprint, dtype=dtype, num_rows=int(num_rows),
                category_pad_id=int(cache.category_pad_id))
    tmp = path + ".tmp.npz"
    np.savez(tmp, category=cache.category[:num_rows].cpu().numpy(),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    os.replace(tmp, path)


def load_cache(path: str, fingerprint: dict,
               device: torch.device = torch.device("cpu")
               ) -> Optional[NewsEmbeddingCache]:
    """A cache persisted by :func:`save_cache` (by either package), on
    ``device``; None when the file is absent or its fingerprint differs from
    ``fingerprint`` in any key (the caller then encodes the corpus anew)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if {k: meta.get(k) for k in fingerprint} != dict(fingerprint):
            return None
        emb, cat = z["embeddings"], z["category"]
        scales = z["scales"] if "scales" in z.files else None
    dtype = meta["dtype"]
    if dtype.startswith("int8:"):
        embeddings = Int8Rows(torch.from_numpy(emb).to(device),
                              torch.from_numpy(scales).to(device),
                              dtype.split(":", 1)[1])
    elif dtype == "bfloat16":
        embeddings = torch.from_numpy(emb.view(np.int16)).view(torch.bfloat16).to(device)
    else:
        embeddings = torch.from_numpy(emb).to(device)
    return NewsEmbeddingCache(embeddings=embeddings,
                              category=torch.from_numpy(cat).to(device),
                              category_pad_id=int(meta["category_pad_id"]))


class CacheFiller:
    """Encodes the whole news table in chunks of ``batch_size`` rows.

    ``encode_fn(title, title_mask, sapo, sapo_mask) -> (n, D)``; each news
    is encoded on its own, so the last, shorter chunk needs no padding."""

    def __init__(self, encode_fn: Callable[..., torch.Tensor],
                 batch_size: int = 512):
        self.encode_fn = encode_fn
        self.batch_size = batch_size

    def fill(self, table: NewsTable, inference: bool = True) -> NewsEmbeddingCache:
        """Under ``torch.inference_mode()``, or ``torch.no_grad()`` when not
        ``inference``: cached-history training gathers rows of the cache
        into micro-steps that autograd records, and an inference tensor
        cannot be saved for backward."""
        R = table.title.shape[0]
        chunks = []
        with torch.inference_mode() if inference else torch.no_grad():
            for start in range(0, R, self.batch_size):
                t = table.title[start:start + self.batch_size]
                tm = (t != table.pad_token_id).to(torch.int32)
                s = sm = None
                if table.sapo is not None:
                    s = table.sapo[start:start + self.batch_size]
                    sm = (s != table.pad_token_id).to(torch.int32)
                chunks.append(self.encode_fn(t, tm, s, sm))
        return NewsEmbeddingCache(embeddings=torch.cat(chunks),
                                  category=table.category,
                                  category_pad_id=table.category_pad_id)
