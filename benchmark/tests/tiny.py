"""A benchmark root of two tiny cells, for rehearsing whole runs on the CPU:
the harness's code as it is, with configuration, traffic and limit files of
a small size (the tiny PLM preset: width 64, 2 layers) beside it."""
from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

PLM = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "intermediate_size": 128, "vocab_size": 1000, "max_position_embeddings": 256,
       "type_vocab_size": 2, "layer_norm_eps": 1e-05, "hidden_dropout_prob": 0.1,
       "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02, "pad_token_id": 0,
       "position_offset": 0}

CORPUS = {"news": 300, "vocab_words": 2000, "zipf": 1.3,
          "title_words": {"median": 8, "sigma": 0.3, "min": 3, "max": 20},
          "abstract_words": {"median": 12, "sigma": 0.6, "min": 0, "max": 40},
          "impressions": 80, "users": 40,
          "history": {"median": 6, "sigma": 0.8, "min": 1, "max": 10},
          "positives": [1, 2], "negatives": [4, 8]}


# the readers of the reranking runner's per-layer metrics (benchmark/metrics/)
RERANK_METRICS = ("padding_pct.rerank", "requests_per_call.rerank", "pack_share_pct.rerank",
                  "mfu.rerank", "mha_roofline.rerank", "device_idle_pct.rerank")


def miner_config(dtype: str = "float32") -> dict:
    return {**PLM, "name": "tiny-miner", "gelu_approx": dtype == "bfloat16",
            "word_embed_dim": 32, "category_embed_dim": 16, "num_context_codes": 4,
            "context_code_dim": 16, "dropout": 0.2, "max_title_length": 16,
            "max_sapo_length": 32, "his_length": 10, "npratio": 4, "train_batch_size": 4,
            "gradient_accumulation_steps": 2, "learning_rate": 1e-3, "warmup_ratio": 0.1,
            "weight_decay": 0.01, "max_grad_norm": 1.0, "num_train_epochs": 5,
            "compute_dtype": dtype, "remat": True,
            "args": ["--model_name", "Miner", "--max_title_length", "16",
                     "--max_sapo_length", "32", "--his_length", "10", "--online", "1",
                     "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
                     "--word_embed_dim", "32", "--category_embed_dim", "16",
                     "--combine_type", "linear", "--use_category_bias",
                     "--num_context_codes", "4", "--context_code_dim", "16",
                     "--score_type", "weighted", "--dropout", "0.2", "--npratio", "4",
                     "--train_batch_size", "4", "--dataloader_drop_last",
                     "--gradient_accumulation_steps", "2", "--num_train_epochs", "5",
                     "--learning_rate", "1e-3", "--warmup_ratio", "0.1",
                     "--max_grad_norm", "1.0", "--weight_decay", "0.01",
                     "--compute_dtype", dtype, "--remat"]}


def unbert_config() -> dict:
    return {**PLM, "name": "tiny-unbert", "gelu_approx": False, "seq_len": 300,
            "max_position_embeddings": 300,
            "news_max_len": 20, "hist_max_len": 20, "max_title_length": 16, "his_length": 10,
            "serve_max_batch": 4, "compute_dtype": "float32",
            "args": ["--model_name", "unbert", "--max_title_length", "16",
                     "--max_sapo_length", "2", "--his_length", "10", "--plm_preset", "tiny",
                     "--compute_dtype", "float32", "--serve_max_batch", "4",
                     "--serve_http_impl", "async", "--serve_warmup_topk", "0"]}


def make_root(dest: str, seconds_rate: float = 8.0) -> str:
    """A copy of the benchmark's code under ``dest`` with the tiny cells
    ``tiny-train`` and ``tiny-rerank`` in place of the real ones; returns
    ``dest``."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "configs", "traffic", "limits", "tests", ".cache", "__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub))

    def put(sub, name, obj):
        with open(os.path.join(bench, sub, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    put("configs", "tiny-miner", miner_config())
    put("configs", "tiny-unbert", unbert_config())
    put("traffic", "tiny-train", {"kind": "train", "corpus": CORPUS, "check_updates": 2,
                                  "trace_micro_batches": 4})
    put("traffic", "tiny-rerank", {
        "kind": "rerank", "corpus": {**CORPUS, "impressions": 0}, "rate_per_s": seconds_rate,
        "shape_seed": 7, "slate": {"median": 6, "sigma": 0.6, "min": 2, "max": 20},
        "history": {"median": 6, "sigma": 0.8, "min": 1, "max": 10},
        "warmup_slates": [16, 32], "warm_requests": 2, "check_requests": 6,
        "trace_seconds": 1})
    put("limits", "tiny-train", {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                                            "change_gap": 1e-3}})
    put("limits", "tiny-rerank", {"limits": {"score_gap": 1e-3, "score_rms_gap": 1e-3, "unsorted_replies": 0}})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench_json = json.load(f)
    bench_json["workloads"] = [
        {"name": "tiny-train", "config": "tiny-miner", "traffic": "tiny-train", "chips": 1,
         "why": "tests"},
        {"name": "tiny-rerank", "config": "tiny-unbert", "traffic": "tiny-rerank",
         "chips": 1, "why": "tests"}]
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-train"]
    bench_json["end_to_end"].append(
        {"name": "rerank_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny-rerank"]})
    bench_json["per_layer"] += [
        {"name": name, "unit": "%", "better": "lower", "source": "program_span",
         "layer": "tests", "moves": "rerank_p95_ms", "workloads": ["tiny-rerank"]}
        for name in RERANK_METRICS]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench_json, f)
    return dest
