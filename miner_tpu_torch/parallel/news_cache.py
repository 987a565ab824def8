"""The news-embedding cache, on one device or row-sharded over the mesh's
table axis.

Counterpart of ``miner_tpu/parallel/news_cache.py``: the news encoder runs
once over the whole corpus, producing a (N, D) table of news embeddings;
each serving request then gathers rows from it and runs only the model's
tail (zero PLM calls per request). ``CacheFiller`` encodes the corpus in
chunks of 512 news with a Python loop (the JAX package's ``lax.scan``).
``Int8Rows`` stores the table as int8 rows with a scale each (half the
bytes of bf16); ``save_cache`` / ``load_cache`` persist a serving cache so
that a restart skips the corpus encode.

Under a mesh with a table axis of T > 1 (``CacheFiller.fill(..., mesh)``,
JAX's ``_place_on_mesh``) the rows are padded to a multiple of T, and
table rank t keeps rows [t R_pad / T, (t + 1) R_pad / T) and one zero row
(``ShardedRows``). :func:`gather_rows` and the lookup+score op map each
index to its local row, or to the zero row where another rank owns it,
work on the local shard and sum over the table group: one rank's term is
the row's, the others' are zeros, so the sum is exact and a sharded cache
gives what one device's gives, bit for bit. A sharded cache persists as
one device's (``save_cache`` gathers the true rows; JAX writes only true
rows too), and each rank loads the file and keeps its shard
(``load_cache``), so a file written at one table size loads at any other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from miner_tpu_torch.data.device_table import NewsTable
from miner_tpu_torch.parallel.mesh import TABLE_AXIS, Mesh, barrier, is_writer
from miner_tpu_torch.parallel.sharding import every_rank

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


@dataclasses.dataclass
class ShardedRows:
    """This table rank's shard of a (R, ...) table row-sharded over the
    mesh's table axis: ``local`` holds rows [``start``, ``start`` +
    ``per_shard``) of the table padded to ``per_shard`` x T rows (pad rows
    zero, an int8 pad row's scale 1), then one zero row. ``num_rows`` is R,
    ``group`` the table group."""

    local: Union[torch.Tensor, Int8Rows]
    start: int
    per_shard: int
    num_rows: int
    group: object

    @property
    def shape(self):
        return (self.num_rows, *self.local.shape[1:])

    def local_index(self, idx: torch.Tensor) -> torch.Tensor:
        """Each index's row in ``local``: an index in [-R, 0) wrapped to R +
        index, a row of this shard to its place, any other row to the zero
        row (``per_shard``), and an index outside [-R, R) on table rank 0
        to ``per_shard + 1``, outside the local table (NaN scores, as one
        device gives them)."""
        R, S = self.num_rows, self.per_shard
        row = torch.where(idx < 0, idx + R, idx)
        local = row - self.start
        mine = (local >= 0) & (local < S)
        out = torch.where(mine, local, S)
        if self.start == 0:
            out = torch.where((row < 0) | (row >= R), S + 1, out)
        return out.to(idx.dtype)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the table group, in place."""
        dist.all_reduce(x, group=self.group)
        return x

    def whole(self) -> Union[torch.Tensor, Int8Rows]:
        """The whole (R, ...) table on every rank of the table group, from
        each rank's true rows (the bytes as they are)."""
        def gather(local: torch.Tensor) -> torch.Tensor:
            return torch.cat(every_rank(local[:self.per_shard], self.group))[:self.num_rows]

        if isinstance(self.local, Int8Rows):
            return Int8Rows(gather(self.local.values), gather(self.local.scales),
                            self.local.dequant_dtype)
        return gather(self.local)


def shard_rows(table: Union[torch.Tensor, Int8Rows], mesh: Mesh
               ) -> Union[torch.Tensor, Int8Rows, ShardedRows]:
    """This rank's :class:`ShardedRows` of a whole (R, ...) table, as JAX
    places a cache on the mesh (``_place_on_mesh``: rows padded to a
    multiple of T, int8 pad rows with scale 1), plus the zero row; the table
    itself without a table axis above 1."""
    T = mesh.shape[TABLE_AXIS]
    if T == 1:
        return table
    R = table.shape[0]
    S = -(-R // T)
    start = mesh.table_rank * S

    def part(x, fill=0.0):
        out = torch.full((S + 1, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        rows = x[start:start + S]
        out[:len(rows)] = rows
        return out

    if isinstance(table, Int8Rows):
        local = Int8Rows(part(table.values), part(table.scales, 1.0), table.dequant_dtype)
    else:
        local = part(table)
    return ShardedRows(local, start, S, R, mesh.table_group)


def gather_rows(table: Union[torch.Tensor, Int8Rows, ShardedRows], idx: torch.Tensor
                ) -> torch.Tensor:
    """Rows of a (R, ...) table for an index tensor of any shape; the rows
    of an :class:`Int8Rows` table dequantized to its ``dequant_dtype`` as
    ``q.to(dt) * s.to(dt)``; those of a :class:`ShardedRows` from the shard
    that holds each, summed over the table group."""
    if isinstance(table, ShardedRows):
        return table.sum(gather_rows(table.local, table.local_index(idx)))
    if isinstance(table, Int8Rows):
        dt = _NAMED_DTYPES[table.dequant_dtype]
        return gather_rows(table.values, idx).to(dt) * gather_rows(table.scales, idx).to(dt)
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


def gathered_dtype(table: Union[torch.Tensor, Int8Rows, ShardedRows]) -> torch.dtype:
    """The type of the rows ``gather_rows`` gives from ``table``."""
    if isinstance(table, ShardedRows):
        return gathered_dtype(table.local)
    if isinstance(table, Int8Rows):
        return _NAMED_DTYPES[table.dequant_dtype]
    return table.dtype


@dataclasses.dataclass
class NewsEmbeddingCache:
    # (R, D) in the compute type, or int8 rows; a table rank's shard of them
    embeddings: Union[torch.Tensor, Int8Rows, ShardedRows]
    category: Union[torch.Tensor, ShardedRows]  # (R,) int32
    category_pad_id: int

    @property
    def quantized(self) -> bool:
        return isinstance(self.embeddings, Int8Rows)

    @property
    def sharded(self) -> bool:
        return isinstance(self.embeddings, ShardedRows)

    def quantize(self) -> "NewsEmbeddingCache":
        """The int8 version of this cache (itself if already quantized). A
        shard's rows quantize on their own (each row has its own scale; the
        zero and pad rows take scale 1, as ``shard_rows`` pads them)."""
        emb = self.embeddings
        if self.quantized or (self.sharded and isinstance(emb.local, Int8Rows)):
            return self
        if self.sharded:
            return dataclasses.replace(self, embeddings=dataclasses.replace(
                emb, local=quantize_rows(emb.local)))
        return dataclasses.replace(self, embeddings=quantize_rows(emb))

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
    uint16, the dtype named in the metadata. A table-sharded cache is
    gathered into the one-device layout first (a collective over the table
    group: every rank calls this), and rank 0 writes the file; every rank
    returns once it is there."""
    if cache.sharded:
        cache = dataclasses.replace(cache, embeddings=cache.embeddings.whole(),
                                    category=cache.category.whole())
    if not is_writer():
        barrier()
        return
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
    barrier()


def load_cache(path: str, fingerprint: dict,
               device: torch.device = torch.device("cpu"), mesh: Optional[Mesh] = None
               ) -> Optional[NewsEmbeddingCache]:
    """A cache persisted by :func:`save_cache` (by either package), on
    ``device``; None when the file is absent or its fingerprint differs from
    ``fingerprint`` in any key (the caller then encodes the corpus anew).
    Under a ``mesh`` with a table axis above 1 each rank keeps its shard of
    the rows (:func:`shard_rows`), whatever table size wrote the file."""
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
    category = torch.from_numpy(cat).to(device)
    if mesh is not None:
        embeddings, category = shard_rows(embeddings, mesh), shard_rows(category, mesh)
    return NewsEmbeddingCache(embeddings=embeddings, category=category,
                              category_pad_id=int(meta["category_pad_id"]))


class CacheFiller:
    """Encodes the whole news table in chunks of ``batch_size`` rows.

    ``encode_fn(title, title_mask, sapo, sapo_mask) -> (n, D)``; each news
    is encoded on its own, so the last, shorter chunk needs no padding."""

    def __init__(self, encode_fn: Callable[..., torch.Tensor],
                 batch_size: int = 512):
        self.encode_fn = encode_fn
        self.batch_size = batch_size

    def fill(self, table: NewsTable, inference: bool = True,
             mesh: Optional[Mesh] = None) -> NewsEmbeddingCache:
        """Under ``torch.inference_mode()``, or ``torch.no_grad()`` when not
        ``inference``: cached-history training gathers rows of the cache
        into micro-steps that autograd records, and an inference tensor
        cannot be saved for backward. Under a ``mesh`` with a table axis
        above 1 every rank encodes the whole corpus, as JAX's fill does,
        and keeps its shard (:func:`shard_rows`): the rows are those of one
        device's cache bit for bit."""
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
            embeddings, category = torch.cat(chunks), table.category
            if mesh is not None:
                embeddings, category = shard_rows(embeddings, mesh), shard_rows(category, mesh)
        return NewsEmbeddingCache(embeddings=embeddings, category=category,
                                  category_pad_id=table.category_pad_id)
