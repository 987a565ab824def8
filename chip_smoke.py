#!/usr/bin/env python3
"""The PyTorch port's serving path on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. build: every CUDA kernel of ``miner_tpu_torch/csrc`` is compiled with
   ``nvcc`` (one process per source, all started together); the Triton
   kernel compiles at its first launch.
2. kernels: each of the four kernels on the serving path runs at the shapes
   the path gives it, in bfloat16 and float32, against its plain PyTorch
   version on the same inputs (the tolerance is printed beside the error),
   and is timed with CUDA events beside the plain version, the one PyTorch
   call computing the same function where there is one, and its bound on
   an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s fp32).
3. serve: the launch counts are set to 0, a synthetic MIND corpus of a few
   thousand news is encoded by the full-width ``config/serve_miner.txt``
   model (roberta-base towers, random weights from a seed, bfloat16) into
   the news-embedding cache, and the HTTP server answers concurrent slate
   and whole-corpus top-k requests. Every kernel must have launched.
4. parity: the same full-width model in float32 over 64 news, on the card
   through the kernels and on the CPU through the plain versions; the cache
   rows and the scores of one request batch must agree.

Prints the card's name and power limit, one JSON line of kernel results,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: float32 differs by summation order only; a
# bfloat16 output may differ by rounding of the output and of the
# intermediates the kernels round (proj, softmax weights): a few ulps
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
HIDDEN, HEADS = 768, 12  # roberta-base
CHUNK = 512  # CacheFiller's chunk of news
HIS, DIM, CODES, CODE_DIM = 50, 256, 32, 200  # config/serve_miner.txt
MAX_BATCH = 32  # --serve_max_batch default
NUM_NEWS = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, target_s: float = 0.2) -> float:
    """Mean time of ``fn()`` on the card in ms, from CUDA events around a
    run of launches after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(200, int(target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- kernels
def mha_cases(dev, g):
    from miner_tpu_torch.ops import mha

    for dtype in (torch.bfloat16, torch.float32):
        for L in (32, 128):  # titles, sapo
            qkv = torch.randn(CHUNK, L, 3 * HIDDEN, device=dev, generator=g).to(dtype)
            lengths = torch.randint(1, L + 1, (CHUNK,), device=dev, generator=g)
            mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).to(torch.int32)
            mask[0] = 0  # a fully masked row comes out as the mean of V
            q, k, v = qkv.view(CHUNK, L, 3, HEADS, -1).permute(2, 0, 3, 1, 4)
            bool_mask = mask.bool()[:, None, None, :]
            out = torch.empty(CHUNK, L, HIDDEN, dtype=dtype, device=dev)
            flops = 4 * CHUNK * HEADS * L * L * (HIDDEN // HEADS)
            yield dict(
                case=f"{str(dtype)[6:]} N={CHUNK} L={L}", dtype=dtype,
                kernel=lambda: mha.fused_mha(qkv, mask, HEADS),
                plain=lambda: mha.mha_reference(qkv, mask, HEADS),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=bool_mask),
                bound=bound_ms(_nbytes(qkv, mask, out), flops, dtype),
                main=dtype == torch.bfloat16 and L == 128)


def add_ln_cases(dev, g):
    from miner_tpu_torch.ops import add_ln

    for dtype in (torch.bfloat16, torch.float32):
        for L in (32, 128):
            T = CHUNK * L
            x = torch.randn(T, HIDDEN, device=dev, generator=g).to(dtype)
            h = torch.randn(T, HIDDEN, device=dev, generator=g).to(dtype)
            scale = 1 + 0.1 * torch.randn(HIDDEN, device=dev, generator=g)
            bias = 0.1 * torch.randn(HIDDEN, device=dev, generator=g)
            scale_t, bias_t = scale.to(dtype), bias.to(dtype)
            yield dict(
                case=f"{str(dtype)[6:]} T={T}", dtype=dtype,
                kernel=lambda: add_ln.fused_dropout_add_ln(x, h, scale, bias, 0.0, 1e-5),
                plain=lambda: add_ln.add_ln_reference(x, h, scale, bias, 1e-5),
                library=lambda: torch.nn.functional.layer_norm(
                    x + h, (HIDDEN,), scale_t, bias_t, 1e-5),
                bound=bound_ms(_nbytes(x, h, scale, bias, x), 8 * T * HIDDEN,
                               torch.float32),
                main=dtype == torch.bfloat16 and L == 128)


def poly_cases(dev, g):
    from miner_tpu_torch.ops import poly_attention

    B = MAX_BATCH
    for dtype in (torch.bfloat16, torch.float32):
        emb = torch.randn(B, HIS, DIM, device=dev, generator=g).to(dtype)
        w = (torch.randn(DIM, CODE_DIM, device=dev, generator=g) / 16).to(dtype)
        codes = (torch.randn(CODES, CODE_DIM, device=dev, generator=g) / 4).to(dtype)
        lengths = torch.randint(1, HIS + 1, (B,), device=dev, generator=g)
        mask = (torch.arange(HIS, device=dev)[None] < lengths[:, None]).to(torch.int32)
        bias = torch.randn(B, HIS, device=dev, generator=g)
        out = torch.empty(B, CODES, DIM, dtype=dtype, device=dev)
        flops = 2 * B * HIS * (DIM * CODE_DIM + CODE_DIM * CODES + CODES * DIM)
        yield dict(
            case=f"{str(dtype)[6:]} B={B}", dtype=dtype,
            kernel=lambda: poly_attention.poly_attention_fused(emb, w, codes, mask, bias),
            plain=lambda: poly_attention.poly_attention_reference(emb, w, codes, mask, bias),
            library=None,
            bound=bound_ms(_nbytes(emb, w, codes, mask, bias, out), flops, dtype),
            main=dtype == torch.bfloat16)


def lookup_cases(dev, g):
    from miner_tpu_torch.ops import lookup_score
    from miner_tpu_torch.utils import candidate_bucket

    B, N = MAX_BATCH, NUM_NEWS + 1
    for dtype in (torch.bfloat16, torch.float32):
        cache = torch.randn(N, DIM, device=dev, generator=g).to(dtype)
        interests = torch.randn(B, CODES, DIM, device=dev, generator=g).to(dtype)
        for C in (16, candidate_bucket(NUM_NEWS)):  # a slate, the corpus top-k
            idx = torch.randint(0, N, (B, C), device=dev, generator=g, dtype=torch.int32)
            if C == candidate_bucket(NUM_NEWS):
                idx[:] = (torch.arange(C, device=dev, dtype=torch.int32) + 1) % N
            rows = torch.unique(idx).numel()
            out = torch.empty(B, C, CODES, dtype=dtype, device=dev)
            nbytes = rows * DIM * cache.element_size() + _nbytes(idx, interests, out)
            yield dict(
                case=f"{str(dtype)[6:]} B={B} C={C}", dtype=dtype,
                kernel=lambda: lookup_score.lookup_score_fused(cache, idx, interests),
                plain=lambda: lookup_score.lookup_score_reference(cache, idx, interests),
                library=None,
                bound=bound_ms(nbytes, 2 * B * C * CODES * DIM, dtype),
                main=dtype == torch.bfloat16 and C > 16)


KERNELS = [
    # name, route, source, replaces, cases
    ("mha_fwd", "cuda", "miner_tpu_torch/csrc/mha_fwd.cu",
     "miner_tpu/ops/mha.py:208", mha_cases),
    ("add_ln_fwd", "triton", "miner_tpu_torch/ops/add_ln.py",
     "miner_tpu/ops/add_ln.py:122", add_ln_cases),
    ("poly_attention_fwd", "cuda", "miner_tpu_torch/csrc/poly_attention_fwd.cu",
     "miner_tpu/ops/poly_attention.py:91", poly_cases),
    ("lookup_score_fwd", "cuda", "miner_tpu_torch/csrc/lookup_score_fwd.cu",
     "miner_tpu/ops/lookup_score.py:134", lookup_cases),
]


def kernel_phase(dev):
    """Every kernel against its plain version, and timed. Returns the rows
    of the ``kernels`` line (launches are filled in by the serving phase)."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, failures = [], []
    for name, route, source, replaces, cases in KERNELS:
        row = None
        for c in cases(dev, g):
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = REL_TOL[c["dtype"]] * max(1.0, want.float().abs().max().item())
            finite = bool(torch.isfinite(got).all())
            ms = device_ms(c["kernel"])
            plain_ms = device_ms(c["plain"])
            library_ms = device_ms(c["library"]) if c["library"] else None
            b_ms, b_by = c["bound"]
            ok = finite and err <= tol
            log(f"  {name:20s} {c['case']:24s} err {err:.3g} (tol {tol:.3g}) "
                f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"library {'-' if library_ms is None else f'{library_ms:.4f} ms'}  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if not ok:
                failures.append(f"{name} {c['case']}: err {err} tol {tol} finite {finite}")
            if c["main"]:
                row = {"name": name, "route": route, "source": source,
                       "replaces": replaces, "case": c["case"], "launches": 0,
                       "max_abs_err": err, "tol": tol, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms}
        rows.append(row)
    if failures:
        raise SystemExit("kernel phase failed:\n  " + "\n  ".join(failures))
    return rows


# ------------------------------------------------------------------ serve
CATEGORIES = ["news", "sports", "finance", "lifestyle", "health", "travel",
              "foodanddrink", "weather", "autos", "video", "tv", "music",
              "movies", "entertainment", "kids", "middleeast", "northamerica"]


def write_corpus(root: str, num_news: int, seed: int) -> None:
    """A MIND-format corpus from a seed: titles of 40 words and abstracts of
    160, so the title (32) and sapo (128) token windows are full."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20000)])
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "news.tsv"), "w", encoding="utf-8") as f:
        for i in range(num_news):
            title = " ".join(words[rng.integers(0, len(words), 40)])
            sapo = " ".join(words[rng.integers(0, len(words), 160)])
            f.write(f"N{i}\t{title}\t{CATEGORIES[i % len(CATEGORIES)]}\t{sapo}\n")
    with open(os.path.join(root, "category2id.json"), "w") as f:
        json.dump({"pad": 0, "unk": 1,
                   **{c: i + 2 for i, c in enumerate(CATEGORIES)}}, f)
    with open(os.path.join(root, "user2id.json"), "w") as f:
        json.dump({"unk": 0}, f)


def serve_args(corpus: str, *extra: str):
    """``config/serve_miner.txt`` as it stands, on the synthetic corpus, with
    the hash tokenizer over roberta-base's vocabulary size (no tokenizer
    files here) and random weights: port checkpoints come with training, so
    the checkpoint and the cache persisted against it are dropped."""
    from miner_tpu_torch.config import convert_arg_line_to_args, make_parser

    here = os.path.dirname(os.path.abspath(__file__))
    words = []
    with open(os.path.join(here, "config", "serve_miner.txt")) as f:
        for line in f:
            words += convert_arg_line_to_args(line)
    for flag in ("--saved_model_path", "--serve_cache_path"):
        i = words.index(flag)
        del words[i:i + 2]
    return make_parser().parse_args([
        "serve", *words, "--pretrained_tokenizer", "hash:50265",
        "--user2id_path", os.path.join(corpus, "user2id.json"),
        "--category2id_path", os.path.join(corpus, "category2id.json"),
        "--eval_news_path", os.path.join(corpus, "news.tsv"),
        "--port", "0", *extra])


def _post(url: str, payload: dict):
    import urllib.request

    req = urllib.request.Request(url + "/score", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def serve_phase(corpus: str, n_slate: int = 64, n_topk: int = 8) -> dict:
    """The main path: ``serve``'s own pieces (service with its corpus cache,
    warm-up, HTTP server) answering concurrent slate and top-k requests.
    Returns the launch counts of the run."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from miner_tpu_torch.ops import launch_counts, reset_launch_counts
    from miner_tpu_torch.parallel.news_cache import CacheFiller
    from miner_tpu_torch.serving import ScoringService, make_http_server
    from miner_tpu_torch.training.trainer import Trainer

    args = serve_args(corpus)
    reset_launch_counts()
    t0 = time.perf_counter()
    service = ScoringService(Trainer(args))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = service.warmup(args.serve_warmup_slates, topk=args.serve_warmup_topk)
    warmup_s = time.perf_counter() - t0
    server = make_http_server(service, args.host, args.port, args.serve_http_impl)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{server.server_address[1]}"
    rng = np.random.default_rng(1)
    ids = [f"N{i}" for i in range(NUM_NEWS)]
    reqs = []
    for i in range(n_slate + n_topk):
        history = list(rng.choice(ids, int(rng.integers(5, 61)), replace=False))
        if i < n_slate:
            reqs.append({"history": history,
                         "candidates": list(rng.choice(ids, 10, replace=False))})
        else:
            reqs.append({"history": history, "candidates": None, "topk": 10})
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            replies = list(pool.map(lambda r: _post(url, r), reqs))
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        server.shutdown()
        service.close()
        thread.join(timeout=10)
    for req, (status, body, _) in zip(reqs, replies):
        scores = [s for _, s in body["results"]]
        want = len(req["candidates"]) if req["candidates"] else req["topk"]
        if (status != 200 or len(scores) != want or not all(map(math.isfinite, scores))
                or scores != sorted(scores, reverse=True)):
            raise SystemExit(f"serve phase: bad reply {status} {body}")
    lat = sorted(t for _, _, t in replies)
    t0 = time.perf_counter()
    ctx = service.ctx
    CacheFiller(ctx.model.encode_news).fill(ctx.table)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    log(f"serve: {ctx.store.num_news - 1} news, {args.plm_preset} towers, "
        f"{ctx.cache.embeddings.dtype}; startup {startup_s:.2f} s (tokenize, "
        f"init, corpus cache), warm cache refill {fill_s:.2f} s; {warmed} warm-up "
        f"calls {warmup_s:.2f} s")
    log(f"serve: {len(reqs)} requests ({n_slate} slates of 10, {n_topk} corpus "
        f"top-10), 16 clients: {len(reqs) / wall_s:.1f} req/s, p50 "
        f"{1e3 * lat[len(lat) // 2]:.1f} ms, p99 {1e3 * lat[-1]:.1f} ms, "
        f"{service.batcher.stats()['mean_batch']} requests per device call "
        f"on {torch.cuda.get_device_name(0)}")
    log(f"serve: kernel launches on the path {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise SystemExit(f"serve phase: the path never launched {missing}")
    return counts


# ----------------------------------------------------------------- parity
def parity_phase(corpus: str) -> None:
    """The full-width model in float32 on the card (kernels) and on the CPU
    (plain versions), same weights from the seed: cache rows and one request
    batch's scores must agree. Tolerance 1e-3 of the values' scale: float32
    through 12 layers, summed in other orders by the kernels and cuBLAS than
    by the plain versions and the CPU's BLAS."""
    import numpy as np

    from miner_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(2)
    cand = np.zeros((4, 16), np.int32)
    cand[:, :10] = rng.integers(1, 65, (4, 10))
    his = rng.integers(0, 65, (4, HIS)).astype(np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(serve_args(corpus, "--compute_dtype", "float32",
                                     "--device", device))
        ctx = trainer.serving_context()
        out[device] = (ctx.cache.embeddings.float().cpu().numpy(),
                       trainer.serve_scores(ctx.model, ctx.cache, cand, his))
    for what, i in (("cache rows", 0), ("scores", 1)):
        got, want = out["cuda"][i], out["cpu"][i]
        err = float(np.abs(got - want).max())
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        log(f"parity: {what} {got.shape} card vs CPU max abs err {err:.3g} "
            f"(tol {tol:.3g})")
        if not (np.isfinite(got).all() and err <= tol):
            raise SystemExit(f"parity phase: {what} disagree ({err} > {tol})")


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    from miner_tpu_torch.ops import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = common.build()
    log(f"build: {len(reports)} CUDA libraries in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("kernels (kernel vs plain version on the same inputs):")
    rows = kernel_phase(dev)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(os.path.join(tmp, "serve"), NUM_NEWS, seed=0)
        counts = serve_phase(os.path.join(tmp, "serve"))
        write_corpus(os.path.join(tmp, "parity"), 64, seed=1)
        parity_phase(os.path.join(tmp, "parity"))
    for row in rows:
        row["launches"] = counts[row["name"]]

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
