"""HTTP scoring server over the news-embedding cache, and the UnBERT reranker.

The port's copy of ``miner_tpu/serving.py`` for the families the port has:
the two-tower Miner and Fastformer, and the UnBERT cross-encoder
(``--model_name``).
``python -m miner_tpu_torch serve @config.txt --port 8400`` starts an HTTP
server that ranks candidate news for a click history with ZERO PLM calls per
request: the corpus is encoded once into the news-embedding cache at startup
(``Trainer.serving_context``) and every request runs only the cached tail
through ``Trainer.serve_scores`` / ``Trainer.serve_topk``, which return the
model's scores whatever its kind: for the Miner the category bias,
poly-attention interests, the lookup+score op and target-aware aggregation;
for Fastformer the user encoder over the history rows and a dot product
with the candidate rows; through the port's kernels on the card.

The UnBERT cross-encoder serves as a reranker through the same server: no
cache can exist for it, so each (candidate, history) pair of a slate packs
into one row and the coalesced batch runs the whole model once
(``Trainer.serve_scores_unbert``). Whole-corpus requests are refused, and
so are slates above ``--serve_max_slate`` (miner_tpu/serving.py:441-452).

Concurrent requests coalesce through a :class:`MicroBatcher` into ONE
device call per drain window (``--serve_max_batch``,
``--serve_batch_wait_ms``) — the scoring path is batched over users, so N
in-flight requests cost one pass instead of N.

API (JSON):
  GET  /healthz            -> {"status": "ok", "num_news": N,
                               "requests": R, "device_batches": D}
  POST /score              {"history": [news_id, ...],       # oldest first
                            "candidates": [news_id, ...] | null,  # null=corpus
                            "topk": int | null}
                           -> {"results": [[news_id, score], ...]}  # ranked

Candidate counts are bucketed (next power of two, min 16) so the number of
distinct request shapes stays at log2(corpus); bucket-padding rows reuse the
pad news (row 0) and are dropped before ranking.

Over a mesh of ranks (one process a rank under ``torch.distributed.run``,
``--mesh_data`` / ``--mesh_table`` / ``--mesh_model``) every rank builds
the serving context (the model sharded over the model axis, the cache over
the table axis), rank 0 runs the HTTP front-end and the
:class:`MicroBatcher`, and every other rank follows its device calls
(:class:`MeshCalls`): before each call rank 0 sends its kind and shapes,
then its index arrays, and the ranks compute it together (a data rank its
rows; each gather and lookup+score summed over the table group; the
encoders' products over the model group); rank 0 replies. The server's
shutdown sends a stop. The control messages travel on a gloo group of
their own on the host, where a follower waits for the next call as long
as the server lives; the calls' collectives run under the process group's
timeout (``cli.SERVE_TIMEOUT``), so a rank that fails makes rank 0's call
fail, not hang.
"""
from __future__ import annotations

import datetime
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from miner_tpu_torch.parallel import mesh
from miner_tpu_torch.utils import candidate_bucket


def history_row(his: Sequence[int], his_length: int,
                legacy_layout: bool = False) -> np.ndarray:
    """(his_length,) history rows: clicks in chronological order, pad news
    appended (the JAX package's default layout), or pads prepended for a
    model trained under ``--legacy_history_layout``. An over-long history
    keeps the most RECENT ``his_length`` clicks (PARITY.md)."""
    H = min(len(his), his_length)
    row = np.zeros((his_length,), np.int32)
    if legacy_layout:
        row[his_length - H:] = his[len(his) - H:]
    else:
        row[:H] = his[len(his) - H:]
    return row


class _Pending:
    """One enqueued scoring request (internal to MicroBatcher)."""

    __slots__ = ("cand", "his", "k", "done", "scores", "error", "t0",
                 "on_done")

    def __init__(self, cand: Optional[np.ndarray], his: np.ndarray,
                 k: Optional[int] = None, on_done: Optional[Callable] = None):
        self.cand = cand  # (C,) candidate rows (slate request)
        self.his = his  # (H,) history rows, fixed H
        self.k = k  # corpus top-k request when not None (cand is None)
        self.done = threading.Event()
        self.scores = None  # (C,) scores | (vals (k,), rows (k,)) for top-k
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()  # enqueue time, for latency stats
        # completion callback invoked from the worker thread after scores/
        # error are set — the asyncio front-end bridges to its event loop
        # here (loop.call_soon_threadsafe) instead of blocking on `done`
        self.on_done = on_done


class MicroBatcher:
    """Coalesces concurrent scoring requests into one device call.

    Requests from the server's handlers enqueue here; a worker thread
    drains up to ``max_batch`` of them, pads them into one
    ``(B_bucket, C_bucket)`` batch (power-of-two buckets), runs ONE device
    call, and distributes the per-request score rows.

    ``max_wait_ms`` defaults to ADAPTIVE (None): the drain waits up to ~10%
    of the rolling device-call duration (capped at 20 ms) for more requests
    before dispatching; the in-flight call alone keeps batches full on a
    fast device. A fixed ``max_wait_ms`` (including 0) overrides verbatim.

    ``score_fn(cand_idx (B, C), his_idx (B, H)) -> (B, C) scores``; padding
    rows use index 0 (the pad news) and are dropped before results are
    returned.
    """

    def __init__(self, score_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 his_length: int, max_batch: int = 32,
                 max_wait_ms: Optional[float] = None,
                 topk_fn: Optional[Callable[[np.ndarray, int],
                                            Tuple[np.ndarray, np.ndarray]]] = None):
        self.score_fn = score_fn
        # (his_idx (B, H), k) -> (vals (B, k), rows (B, k)): whole-corpus
        # top-k requests coalesce through the same worker when provided
        self.topk_fn = topk_fn
        self.his_length = int(his_length)
        self.max_batch = max(1, int(max_batch))
        # None = adaptive (see class docstring); a number is honored verbatim
        self.max_wait_s = (None if max_wait_ms is None
                           else max(0.0, float(max_wait_ms)) / 1e3)
        self._call_ema_s = 0.0  # rolling device-call duration (worker only)
        self.requests = 0  # total requests scored (observability)
        self.device_batches = 0  # total device calls issued
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._lock = threading.Lock()  # guards counters
        self._submit_lock = threading.Lock()  # orders submits vs close()
        self._closed = False
        # rolling request latencies (seconds, enqueue -> scores ready) for
        # /healthz percentiles; bounded so a long-lived server stays O(1)
        self._latencies: deque = deque(maxlen=2048)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="miner-torch-microbatcher")
        self._worker.start()

    def submit(self, cand: Sequence[int], his: np.ndarray) -> np.ndarray:
        """Blocking: returns the (len(cand),) scores for one request."""
        item = _Pending(np.asarray(cand, np.int32), np.asarray(his, np.int32))
        return self._wait(item)

    def submit_topk(self, his: np.ndarray,
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking: (scores (k,), news rows (k,)) over the whole corpus.
        Concurrent top-k requests with the same k bucket coalesce into one
        batched ``topk_fn`` call."""
        if self.topk_fn is None:
            raise RuntimeError("MicroBatcher built without a topk_fn")
        item = _Pending(None, np.asarray(his, np.int32), k=int(k))
        return self._wait(item)

    def submit_callback(self, cand: Optional[Sequence[int]], his: np.ndarray,
                        k: Optional[int] = None,
                        on_done: Optional[Callable] = None) -> _Pending:
        """Non-blocking enqueue: ``on_done(item)`` fires from the worker
        thread once ``item.scores`` / ``item.error`` is set. The asyncio
        front-end's bridge into the batcher."""
        item = _Pending(
            None if cand is None else np.asarray(cand, np.int32),
            np.asarray(his, np.int32),
            k=None if k is None else int(k), on_done=on_done)
        self._enqueue(item)
        return item

    def _enqueue(self, item: _Pending):
        # the submit lock orders every enqueue before close()'s shutdown
        # sentinel — a submit racing close() either lands ahead of the
        # sentinel (worker drains it) or raises, never hangs
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(item)

    def _wait(self, item: _Pending):
        self._enqueue(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.scores

    def stats(self) -> Dict:
        """Observability snapshot: request/batch counters, coalescing
        ratio, and rolling end-to-end latency percentiles (ms)."""
        with self._lock:
            req, dev = self.requests, self.device_batches
            lat = sorted(self._latencies)
        out: Dict = {"requests": req, "device_batches": dev,
                     "mean_batch": round(req / dev, 2) if dev else None}
        if lat:
            pick = lambda q: round(lat[min(len(lat) - 1,
                                           int(q * len(lat)))] * 1e3, 2)
            out["latency_ms_p50"] = pick(0.50)
            out["latency_ms_p99"] = pick(0.99)
        return out

    def close(self):
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=5)

    # ------------------------------------------------------------- worker
    def _wait_budget(self) -> float:
        """Drain window in seconds: explicit when configured, else ~10% of
        the rolling device-call duration (capped at 20 ms)."""
        if self.max_wait_s is not None:
            return self.max_wait_s
        return min(0.1 * self._call_ema_s, 0.020)

    def _timed_call(self, fn, *args):
        """Run one device call, folding its duration into the rolling EMA
        the adaptive drain window is derived from (worker thread only)."""
        t0 = time.monotonic()
        out = fn(*args)
        dur = time.monotonic() - t0
        self._call_ema_s = (dur if self._call_ema_s == 0.0
                            else 0.8 * self._call_ema_s + 0.2 * dur)
        return out

    def _drain(self, first: _Pending) -> List[_Pending]:
        group = [first]
        deadline = time.monotonic() + self._wait_budget()
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                # past the deadline, still sweep whatever is ALREADY queued
                # (free coalescing); only stop waiting for new arrivals
                if remaining <= 0:
                    nxt = self._q.get_nowait()
                else:
                    nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # shutdown: process what we have first
                self._q.put(None)
                break
            group.append(nxt)
        return group

    def _score_group(self, group: List[_Pending]):
        """One padded device call for a same-candidate-bucket group. Every
        exception — including batch allocation — propagates to the callers
        instead of killing the worker thread (which would deadlock every
        queued and future submit)."""
        try:
            B = len(group)
            B_pad = 1 if B == 1 else candidate_bucket(B, minimum=2)
            C_pad = max(candidate_bucket(len(it.cand)) for it in group)
            cand_idx = np.zeros((B_pad, C_pad), np.int32)
            his_idx = np.zeros((B_pad, self.his_length), np.int32)
            for i, it in enumerate(group):
                cand_idx[i, : len(it.cand)] = it.cand
                his_idx[i] = it.his
            scores = np.asarray(self._timed_call(self.score_fn, cand_idx,
                                                 his_idx))
            for i, it in enumerate(group):
                it.scores = scores[i, : len(it.cand)]
        except BaseException as e:  # propagate to every caller
            for it in group:
                it.error = e
        else:
            with self._lock:
                self.requests += B
                self.device_batches += 1
        finally:
            self._complete(group)

    def _complete(self, group: List[_Pending]):
        """Record latency (enqueue -> scores ready), release blocking
        waiters, fire async completion callbacks."""
        now = time.monotonic()
        with self._lock:
            for it in group:
                if it.error is None:
                    self._latencies.append(now - it.t0)
        for it in group:
            it.done.set()
            if it.on_done is not None:
                try:
                    it.on_done(it)
                except Exception:  # a bridge failure must not kill the worker
                    pass

    def _topk_group(self, group: List[_Pending], k_bucket: int):
        """One batched whole-corpus top-k call for same-k-bucket requests;
        each caller gets its own (vals[:k], rows[:k])."""
        try:
            B = len(group)
            B_pad = 1 if B == 1 else candidate_bucket(B, minimum=2)
            his_idx = np.zeros((B_pad, self.his_length), np.int32)
            for i, it in enumerate(group):
                his_idx[i] = it.his
            vals, rows = self._timed_call(self.topk_fn, his_idx, k_bucket)
            # topk_fn may clamp k_bucket to the corpus size
            avail = vals.shape[1]
            for i, it in enumerate(group):
                k = min(it.k, avail)
                it.scores = (vals[i, :k], rows[i, :k])
        except BaseException as e:  # propagate to every caller
            for it in group:
                it.error = e
        else:
            with self._lock:
                self.requests += B
                self.device_batches += 1
        finally:
            self._complete(group)

    def _run(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            group = self._drain(first)
            # Partition by (kind, bucket): one full-corpus request must not
            # drag every coalesced small slate up to a (B, corpus) call, and
            # top-k requests run a different path entirely.
            by_bucket: dict = {}
            for it in group:
                key = (("topk", candidate_bucket(it.k)) if it.k is not None
                       else ("slate", candidate_bucket(len(it.cand))))
                by_bucket.setdefault(key, []).append(it)
            for (kind, bucket), sub in sorted(by_bucket.items()):
                if kind == "topk":
                    self._topk_group(sub, bucket)
                else:
                    self._score_group(sub)


class MeshCalls:
    """A server's device calls over a mesh of ranks: rank 0 sends each
    call (a header ``[kind, B, C, H, k]``, then its int32 index arrays)
    over a gloo group of its own and runs its part; every other rank runs
    :meth:`follow` until the stop."""

    STOP, SLATE, TOPK = 0, 1, 2
    # a follower waits for the next request as long as the server lives
    _IDLE = datetime.timedelta(days=365)

    def __init__(self, service: "ScoringService"):
        self.service = service
        self.group = dist.new_group(backend="gloo", timeout=self._IDLE)
        self.calls = 0
        self.failed: Optional[BaseException] = None

    def _header(self, *words: int) -> torch.Tensor:
        h = torch.tensor(words, dtype=torch.int64)
        dist.broadcast(h, 0, group=self.group)
        return h

    def _array(self, a: Optional[np.ndarray], shape) -> np.ndarray:
        t = (torch.from_numpy(np.ascontiguousarray(a, np.int32)) if a is not None
             else torch.empty(shape, dtype=torch.int32))
        dist.broadcast(t, 0, group=self.group)
        return t.numpy()

    def _run(self, fn, *args):
        if self.failed is not None:
            raise RuntimeError("a rank of the serving mesh failed earlier") from self.failed
        try:
            out = fn(*args)
        except BaseException as e:
            self.failed = e
            raise
        self.calls += 1
        return out

    def slate(self, cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        """Rank 0: one slate call, run by every rank."""
        (B, C), H = cand_idx.shape, his_idx.shape[1]

        def call():
            self._header(self.SLATE, B, C, H, 0)
            return self.service._local_score(self._array(cand_idx, None),
                                             self._array(his_idx, None))
        return self._run(call)

    def topk(self, his_idx: np.ndarray, k: int):
        """Rank 0: one corpus top-k call, run by every rank."""
        B, H = his_idx.shape

        def call():
            self._header(self.TOPK, B, 0, H, k)
            return self.service._local_topk(self._array(his_idx, None), k)
        return self._run(call)

    def stop(self) -> None:
        """Rank 0: end the followers (after a failure they end with it)."""
        if self.failed is None:
            self._header(self.STOP, 0, 0, 0, 0)

    def follow(self) -> int:
        """Every rank but 0: run rank 0's calls until the stop; returns how
        many."""
        while True:
            kind, B, C, H, k = self._header(0, 0, 0, 0, 0).tolist()
            if kind == self.STOP:
                return self.calls
            if kind == self.SLATE:
                cand = self._array(None, (B, C))
                self._run(self.service._local_score, cand, self._array(None, (B, H)))
            else:
                self._run(self.service._local_topk, self._array(None, (B, H)), k)


class ScoringService:
    """Request scoring around a ``Trainer.serving_context()``.

    Concurrent requests coalesce through a :class:`MicroBatcher` into one
    device call per drain — ``max_batch``/``batch_wait_ms`` come from
    ``--serve_max_batch`` / ``--serve_batch_wait_ms`` when built from the
    CLI. ``state_dict`` is passed on to ``serving_context``."""

    def __init__(self, trainer, max_batch: Optional[int] = None,
                 batch_wait_ms: Optional[float] = None, state_dict=None):
        self.trainer = trainer
        self.ctx = trainer.serving_context(state_dict)
        self._row_to_id = {v: k for k, v in self.ctx.store.id_to_row.items()}
        self.his_length = trainer.args.his_length
        a = trainer.args
        self.batcher = MicroBatcher(
            self._score_batch, his_length=self.his_length,
            max_batch=getattr(a, "serve_max_batch", 32)
            if max_batch is None else max_batch,
            max_wait_ms=getattr(a, "serve_batch_wait_ms", None)
            if batch_wait_ms is None else batch_wait_ms,
            # a cross-encoder has no corpus cache to rank: slates only
            topk_fn=None if self.cross_encoder else self._topk_batch,
        )
        # over a mesh: every rank takes part in each device call
        self.mesh_calls = MeshCalls(self) if mesh.world_size() > 1 else None

    @property
    def cross_encoder(self) -> bool:
        return self.trainer.kind == "unbert"

    def _score_batch(self, cand_idx: np.ndarray,
                     his_idx: np.ndarray) -> np.ndarray:
        if self.mesh_calls is not None:
            return self.mesh_calls.slate(cand_idx, his_idx)
        return self._local_score(cand_idx, his_idx)

    def _topk_batch(self, his_idx: np.ndarray, k: int):
        if self.mesh_calls is not None:
            return self.mesh_calls.topk(his_idx, k)
        return self._local_topk(his_idx, k)

    def _local_score(self, cand_idx: np.ndarray, his_idx: np.ndarray) -> np.ndarray:
        if self.cross_encoder:
            return self.trainer.serve_scores_unbert(self.ctx.model, self.ctx.packer,
                                                    cand_idx, his_idx)
        return self.trainer.serve_scores(self.ctx.model, self.ctx.cache,
                                         cand_idx, his_idx)

    def _local_topk(self, his_idx: np.ndarray, k: int):
        return self.trainer.serve_topk(self.ctx.model, self.ctx.cache, his_idx, k)

    def warmup(self, slate_sizes: Sequence[int], topk: Optional[int] = None,
               max_b: Optional[int] = None) -> int:
        """Run the scoring path once for every (B_bucket, C_bucket) shape
        live traffic will hit for the given slate sizes, plus the corpus
        top-k over the same batch buckets (none for the cross-encoder), so
        the first requests pay no kernel build or allocator growth. Returns
        the number of calls."""
        cap = self.batcher.max_batch if max_b is None else max_b

        def b_buckets():
            b = 1
            while True:
                yield b
                if b >= cap:
                    return
                b = 2 if b == 1 else b * 2

        n = 0
        for slate in slate_sizes:
            c_pad = candidate_bucket(slate)
            for b in b_buckets():
                self._score_batch(np.zeros((b, c_pad), np.int32),
                                  np.zeros((b, self.his_length), np.int32))
                n += 1
        if topk is not None and self.batcher.topk_fn is not None:
            k_pad = candidate_bucket(min(topk, self.num_news - 1))
            for b in b_buckets():
                self._topk_batch(np.zeros((b, self.his_length), np.int32),
                                 k_pad)
                n += 1
        return n

    @property
    def num_news(self) -> int:
        return self.ctx.store.num_news

    def _idx_of(self, nid: str) -> int:
        row = self.ctx.store.id_to_row.get(nid)
        if row is None:
            raise KeyError(f"unknown news id {nid!r}")
        return row

    def _prepare(self, history: Sequence[str],
                 candidates: Optional[Sequence[str]],
                 topk: Optional[int]):
        """Validate + resolve one request into a submission plan (the
        CPU-side half shared by the blocking and async paths)."""
        if self.cross_encoder:
            if candidates is None:
                raise ValueError(
                    "whole-corpus scoring is not supported for the unbert "
                    "cross-encoder (every candidate costs a full PLM pass) "
                    "— pass 'candidates'")
            max_slate = int(getattr(self.trainer.args, "serve_max_slate", 512) or 512)
            if len(candidates) > max_slate:
                raise ValueError(
                    f"slate of {len(candidates)} exceeds --serve_max_slate="
                    f"{max_slate} for the unbert cross-encoder (each "
                    "candidate costs a full PLM pass)")
        his_row = history_row([self._idx_of(n) for n in history],
                              self.his_length, self.trainer._legacy_layout)
        if candidates is None and topk is not None:
            # whole-corpus + topk: rank on the device, move only k scores
            # off it; concurrent top-k requests coalesce (k bucketed)
            return ("topk", his_row, min(topk, self.num_news - 1), None)
        if candidates is not None:
            cand = [self._idx_of(n) for n in candidates]
            cand_ids = list(candidates)
        else:
            cand = list(range(1, self.num_news))  # skip the pad row 0
            cand_ids = [self._row_to_id.get(i, str(i)) for i in cand]
        return ("slate", his_row, cand, cand_ids)

    def _finish_topk(self, vals, rows) -> List[Tuple[str, float]]:
        return [(self._row_to_id.get(int(r), str(int(r))), float(v))
                for v, r in zip(vals, rows)]

    @staticmethod
    def _finish_slate(cand_ids, scores, topk) -> List[Tuple[str, float]]:
        order = np.argsort(-scores)
        if topk is not None:
            order = order[:topk]
        return [(cand_ids[i], float(scores[i])) for i in order]

    def score(
        self,
        history: Sequence[str],
        candidates: Optional[Sequence[str]] = None,
        topk: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """Ranked (news_id, score) for one request."""
        plan = self._prepare(history, candidates, topk)
        if plan[0] == "topk":
            _, his_row, k, _ = plan
            vals, rows = self.batcher.submit_topk(his_row, k)
            return self._finish_topk(vals, rows)
        _, his_row, cand, cand_ids = plan
        if not cand:
            return []
        scores = self.batcher.submit(cand, his_row)
        return self._finish_slate(cand_ids, scores, topk)

    async def score_async(
        self,
        history: Sequence[str],
        candidates: Optional[Sequence[str]] = None,
        topk: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """``score`` for the asyncio front-end: the event-loop thread never
        blocks — completion comes back via the micro-batcher's worker-thread
        callback bridged with ``call_soon_threadsafe``."""
        import asyncio

        plan = self._prepare(history, candidates, topk)
        if plan[0] == "slate" and not plan[2]:
            return []
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future" = loop.create_future()

        def on_done(item: _Pending):
            def resolve():
                if fut.cancelled():  # client went away mid-score
                    return
                if item.error is not None:
                    fut.set_exception(item.error)
                else:
                    fut.set_result(item.scores)
            loop.call_soon_threadsafe(resolve)

        if plan[0] == "topk":
            _, his_row, k, _ = plan
            self.batcher.submit_callback(None, his_row, k=k, on_done=on_done)
            vals, rows = await fut
            return self._finish_topk(vals, rows)
        _, his_row, cand, cand_ids = plan
        self.batcher.submit_callback(cand, his_row, on_done=on_done)
        scores = await fut
        return self._finish_slate(cand_ids, scores, topk)

    def close(self):
        self.batcher.close()
        if self.mesh_calls is not None and mesh.this_rank() == 0:
            self.mesh_calls.stop()


_HTTP_REASON = {200: b"OK", 400: b"Bad Request", 404: b"Not Found",
                500: b"Internal Server Error"}


def _parse_score_request(req: dict):
    """(history, candidates, topk) of a /score body; ValueError if bad."""
    history = req.get("history") or []
    if not isinstance(history, list):
        raise ValueError("'history' must be a list of news ids")
    candidates = req.get("candidates")
    if candidates is not None and not isinstance(candidates, list):
        raise ValueError("'candidates' must be a list or null")
    topk = req.get("topk")
    if topk is not None and (not isinstance(topk, int)
                             or isinstance(topk, bool) or topk < 1):
        raise ValueError("'topk' must be a positive integer or null")
    return history, candidates, topk


class AsyncHTTPServer:
    """Single-threaded asyncio HTTP/1.1 front-end (the default).

    ONE event-loop thread parses requests and writes responses; scoring
    never blocks the loop (``ScoringService.score_async`` bridges the
    micro-batcher's worker completion back via call_soon_threadsafe).

    Duck-type-compatible with the stdlib server: ``server_address``,
    ``serve_forever()`` (blocking; run it in a thread), ``shutdown()``
    (threadsafe).
    """

    def __init__(self, service: ScoringService, host: str, port: int):
        import socket

        self.service = service
        # bind synchronously so server_address is valid on construction
        self._sock = socket.create_server((host, port))
        self._sock.setblocking(False)
        self.server_address = self._sock.getsockname()
        self._loop = None
        self._stop = None
        self._done = threading.Event()

    def serve_forever(self):
        import asyncio

        asyncio.run(self._main())

    async def _main(self):
        import asyncio

        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._handle_conn,
                                            sock=self._sock)
        try:
            await self._stop.wait()
        finally:
            server.close()
            await server.wait_closed()
            self._done.set()

    def shutdown(self):
        """Threadsafe stop; returns once the loop has wound down."""
        loop, stop = self._loop, self._stop
        if loop is None:  # never started: just release the socket
            self._sock.close()
            self._done.set()
            return
        loop.call_soon_threadsafe(stop.set)
        self._done.wait(timeout=5)

    async def _handle_conn(self, reader, writer):
        import asyncio
        import socket as socket_mod

        sock = writer.get_extra_info("socket")
        if sock is not None:
            # tiny request/response pairs interact badly with Nagle +
            # delayed ACK (up to ~40ms added per round trip)
            sock.setsockopt(socket_mod.IPPROTO_TCP, socket_mod.TCP_NODELAY, 1)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if line in (b"\r\n", b"\n"):
                    continue
                parts = line.split()
                if len(parts) < 3:
                    break
                method, path, version = (parts[0].decode("latin1"),
                                         parts[1].decode("latin1"),
                                         parts[2].decode("latin1"))
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", 0) or 0)
                body = await reader.readexactly(length) if length else b""
                close = (headers.get("connection", "").lower() == "close"
                         or version == "HTTP/1.0")
                code, payload = await self._dispatch(method, path, body)
                data = json.dumps(payload).encode()
                writer.write(
                    b"HTTP/1.1 %d %s\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: %d\r\n%s\r\n"
                    % (code, _HTTP_REASON.get(code, b"?"), len(data),
                       b"Connection: close\r\n" if close else b"")
                    + data)
                await writer.drain()
                if close:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, TimeoutError):
            pass  # client went away mid-request; nothing to answer
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, method: str, path: str, body: bytes):
        service = self.service
        if method == "GET":
            if path == "/healthz":
                return 200, {"status": "ok", "num_news": service.num_news,
                             **service.batcher.stats()}
            return 404, {"error": f"unknown path {path!r}"}
        if method != "POST" or path != "/score":
            return 404, {"error": f"unknown path {path!r}"}
        try:
            history, candidates, topk = _parse_score_request(
                json.loads(body or b"{}"))
            results = await service.score_async(history, candidates, topk)
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            return 400, {"error": str(e)}
        return 200, {"results": results}


def make_threaded_http_server(service: ScoringService, host: str,
                              port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: _reply always sets Content-Length, so
        # persistent connections are safe
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "num_news": service.num_news,
                                  **service.batcher.stats()})
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            if self.path != "/score":
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                history, candidates, topk = _parse_score_request(
                    json.loads(self.rfile.read(length) or b"{}"))
                results = service.score(history, candidates, topk)
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, {"results": results})

        def log_message(self, fmt, *args):  # quiet; the CLI logs startup
            pass

    return ThreadingHTTPServer((host, port), Handler)


def make_http_server(service: ScoringService, host: str, port: int,
                     impl: str = "async"):
    """The HTTP front-end: single-threaded asyncio event loop by default
    (``--serve_http_impl``), stdlib ThreadingHTTPServer as the fallback.
    Both speak keep-alive HTTP/1.1 with the same JSON API and expose the
    same ``server_address`` / ``serve_forever`` / ``shutdown`` surface."""
    if impl == "threaded":
        return make_threaded_http_server(service, host, port)
    if impl != "async":
        raise ValueError(f"unknown serve_http_impl {impl!r}")
    return AsyncHTTPServer(service, host, port)


def serve(trainer, host: str, port: int) -> None:
    """Build the service (the corpus encode happens here) and serve; over a
    mesh, every rank but 0 follows rank 0's device calls until it stops."""
    service = ScoringService(trainer)
    if service.mesh_calls is not None and mesh.this_rank() != 0:
        try:
            n = service.mesh_calls.follow()
            print(f"rank {mesh.this_rank()}: followed {n} scoring calls")
        finally:
            service.close()
        return
    a = trainer.args
    slates = getattr(a, "serve_warmup_slates", None) or []
    topk = int(getattr(a, "serve_warmup_topk", 16) or 0)
    if slates or topk:
        n = service.warmup(slates, topk=topk or None)
        print(f"warmed {n} scoring calls (slates {slates}, topk {topk or 'off'})")
    server = make_http_server(service, host, port,
                              impl=getattr(a, "serve_http_impl", "async"))
    print(f"serving {service.num_news} news on "
          f"http://{host}:{server.server_address[1]} ({trainer.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        service.close()
