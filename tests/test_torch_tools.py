"""The port's end-to-end tools (``miner_tpu_torch/tools``) held against the
JAX package's ``tools/``.

- ``synth_mind`` and ``prepare_mind`` write byte-equal files to the JAX
  tools' for the same arguments.
- ``turnkey_mind`` runs from a MIND-style zip and from a directory on the
  CPU (``--device cpu``), writing the JAX turnkey's splits, checkpoints,
  and a ``preds.pkl`` and per-impression dumps byte-equal to the JAX
  package's evaluator's of the same scores; ``tools/analyze_preds.py``
  (``preds``, ``compare``) reads them alike.
- The trainer argvs of the turnkey, of ``scale_convergence`` (all four
  families, both types) and of ``quality_run`` (both presets, the CPU and
  card legs), parsed by the port's ``make_parser``, equal JAX's, parsed by
  JAX's, on every key both have. The JAX side's argvs are taken from its
  own tools, run with its ``Trainer`` replaced by a recorder.
- A local WordPiece tokenizer directory (written from a ``vocab.txt``, no
  download) gives the same ids through both packages' ``load_tokenizer``,
  and the port's turnkey trains with it.
- ``scale_convergence`` trains on the CPU on a corpus of a few hundred news
  and prints its per-epoch table; ``quality_run`` prints its rows, and its
  Fisher exact test equals scipy's.
- No module of ``miner_tpu_torch/`` imports ``jax``, ``miner_tpu`` or
  ``tools``.
"""
import ast
import dataclasses as dc
import glob
import json
import logging
import os
import pickle
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest

import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu_torch.config import make_parser as port_parser
from miner_tpu_torch.tools import prepare_mind, quality_run, scale_convergence, synth_mind
from miner_tpu_torch.tools import turnkey_mind
from tests.fixture_data import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYZE = os.path.join(REPO, "tools", "analyze_preds.py")
# --no-fused_kernels: the JAX tools pass it with float32 on the TPU (the
# Pallas kernels are tuned for bf16); the port keeps its kernels' fp32
# routes on, and refuses the flag on a card
FP32_ONLY_JAX = {"fused_kernels"}
# the port's tools pass --device (cpu here); JAX's is unset: its backend
# comes from JAX_PLATFORMS
DEVICE = {"device"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite runs six
    xdist workers on one CPU, where each worker's intra-op threads
    oversubscribe it and the many small ops of the plain Philox dropout
    (the PLM in training mode) slow by two orders of magnitude."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _common(jax_ns, port_ns, skip=()):
    """The keys both namespaces have (``skip`` apart) and those that differ."""
    j, p = vars(jax_ns), vars(port_ns)
    keys = sorted((set(j) & set(p)) - set(skip))
    return keys, {k: (j[k], p[k]) for k in keys if j[k] != p[k]}


def _no_dropout_cfg(make):
    return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=0.0,
                                      attention_dropout=0.0)


class _Recorder:
    """Stands in for the JAX package's ``Trainer``: records the parsed
    arguments and writes what the JAX tools read back (a run directory with
    its checkpoint and ``eval.csv``)."""

    seen = []

    def __init__(self, args):
        self.args = args
        _Recorder.seen.append(args)

    def train(self):
        rd = os.path.join(self.args.train_path, "20000101-000000")
        os.makedirs(os.path.join(rd, "ckpt", "bestAucModel"), exist_ok=True)
        with open(os.path.join(rd, "eval.csv"), "w") as f:
            f.write("epoch,step,auc,group_auc,mrr,ndcg@5,ndcg@10\n0,1,0.5,0.5,0.5,0.5,0.5\n")

    def eval(self):
        os.makedirs(os.path.join(self.args.eval_path, "20000101-000000"), exist_ok=True)
        return {}


@pytest.fixture
def recorder(monkeypatch):
    import miner_tpu.training.trainer as jax_trainer

    _Recorder.seen = []
    monkeypatch.setattr(jax_trainer, "Trainer", _Recorder)
    return _Recorder


# ---------------------------------------------------------------- corpora
def test_synth_mind_byte_equal(tmp_path):
    """Two seeds and two topic lists, through the function and the CLI."""
    from tools.synth_mind import make_synth_mind as jax_make

    for seed, topics in ((11, None), (5, [1, 3, 5]), (2, [6, 0, 2, 4])):
        case = tmp_path / f"seed{seed}"
        kw = dict(n_news=150, n_users=40, n_train_lines=60, n_eval_lines=20,
                  hist_len=(3, 7), seed=seed, topics=topics)
        jax_make(str(case / "jax"), **kw)
        synth_mind.make_synth_mind(str(case / "port"), **kw)
        want = _files(str(case / "jax"))
        assert set(want) == {"news.tsv", "behaviors.tsv", "eval_behaviors.tsv",
                             "user2id.json", "category2id.json"}
        assert _files(str(case / "port")) == want, (seed, topics)
        argv = [str(case / "cli"), "--news", "150", "--users", "40",
                "--train_lines", "60", "--eval_lines", "20", "--hist_len", "3", "7",
                "--seed", str(seed)] + (["--topics", *map(str, topics)] if topics else [])
        synth_mind.main(argv)
        assert _files(str(case / "cli")) == want, (seed, topics)


def _raw_mind(tmp_path):
    """The raw-MIND fixture of tests/test_tools.py::test_prepare_mind."""
    raw_news = tmp_path / "news_raw.tsv"
    raw_news.write_text("".join(
        f"N{i}\tsports\tsoccer\ttitle words {i}\tabstract text {i}\n" for i in range(8)))
    raw_beh = tmp_path / "behaviors_raw.tsv"
    rows = []
    for i in range(20):
        hist = " ".join(f"N{j}" for j in range((i % 3) + 1))
        rows.append(f"{i}\tU{i % 5}\t11/11/2019 9:05:58 AM\t{hist}\tN5-1 N6-0")
    raw_beh.write_text("\n".join(rows) + "\n")
    return str(raw_beh), str(raw_news)


@pytest.mark.parametrize("layout", ["raw_mind", "derived"])
def test_prepare_mind_byte_equal(tmp_path, layout, capsys):
    from tools import prepare_mind as jax_prepare

    if layout == "raw_mind":
        behaviors, news = _raw_mind(tmp_path)
        flags = ["--valid_impressions", "2", "--min_history", "1"]
    else:  # the reference's derived order, 16 users, 4 categories
        src = make_fixture(str(tmp_path / "src"), num_news=40, num_lines=80)
        behaviors, news = (os.path.join(src, n) for n in ("behaviors.tsv", "news.tsv"))
        flags = ["--valid_impressions", "5", "--min_history", "2", "--seed", "3"]
    for side, main in (("jax", jax_prepare.main), ("port", prepare_mind.main)):
        main(["--raw_behaviors", behaviors, "--raw_news", news,
              "--out_dir", str(tmp_path / side), *flags])
    jax_out, port_out = capsys.readouterr().out.strip().splitlines()
    assert port_out.replace(str(tmp_path / "port"), "") == \
        jax_out.replace(str(tmp_path / "jax"), "")
    want = _files(str(tmp_path / "jax"))
    assert set(want) == {"train/behaviors.tsv", "train/news.tsv", "valid/behaviors.tsv",
                         "valid/news.tsv", "user2id.json", "category2id.json"}
    assert _files(str(tmp_path / "port")) == want


# ---------------------------------------------------------------- turnkey
@pytest.fixture(scope="module")
def turnkeys(tmp_path_factory):
    """The port's turnkey from a directory (40 lines of the fixture, hash
    tokenizer, float32 on the CPU); the JAX turnkey's prepared splits from
    the same directory (its ``prepare_mind`` step, its ``Trainer`` a
    recorder); and the JAX package's eval artifacts of the same scores: its
    ``ImpressionEvaluator`` fed the logits the port's standalone eval scored
    (the JAX turnkey's own run compiles for ~60 s of tier-1's CPU)."""
    import _pytest.monkeypatch

    from miner_tpu.evaluation.evaluator import ImpressionEvaluator as JaxEvaluator
    from miner_tpu_torch.evaluation import evaluator as port_evaluator
    from tools import turnkey_mind as jax_turnkey

    root = tmp_path_factory.mktemp("turnkeys")
    src = make_fixture(str(root / "src"), num_lines=40)
    flags = ["--archive", src, "--valid_impressions", "5",
             "--pretrained_tokenizer", "hash:1000", "--epochs", "1",
             "--compute_dtype", "float32"]
    evaluators = []
    with _pytest.monkeypatch.MonkeyPatch.context() as mp:
        import miner_tpu.training.trainer as jax_trainer

        mp.setattr(jax_trainer, "Trainer", _Recorder)
        jax_summary = jax_turnkey.main(flags + ["--out", str(root / "jax")])

        class Recording(port_evaluator.ImpressionEvaluator):
            def __init__(self, targets):
                super().__init__(targets)
                self.calls = []
                evaluators.append((dict(targets), self.calls))

            def eval_batch(self, logits, impression_ids, valid=None):
                self.calls.append((np.array(logits), np.array(impression_ids), valid))
                return super().eval_batch(logits, impression_ids, valid)

        import miner_tpu_torch.training.trainer as trainer_module

        mp.setattr(trainer_module, "ImpressionEvaluator", Recording)
        port_summary = turnkey_mind.main(flags + ["--out", str(root / "port"),
                                                  "--device", "cpu"])
    targets, calls = evaluators[-1]  # the standalone eval's
    jax_eval = root / "jax_eval"
    jax_eval.mkdir()
    ev = JaxEvaluator(targets)
    for logits, ids, valid in calls:
        ev.eval_batch(logits, ids, valid=valid)
    ev.compute_scores(turnkey_mind.METRICS, save_result=True, path=str(jax_eval))
    ev.save_predictions(str(jax_eval))
    return jax_summary, port_summary, str(jax_eval)


def _check_turnkey(summary, out):
    for rel in ("data/train/behaviors.tsv", "data/valid/behaviors.tsv",
                "data/train/news.tsv", "data/user2id.json", "data/category2id.json"):
        assert os.path.exists(os.path.join(out, rel)), rel
    assert os.path.isfile(summary["checkpoint"])  # a port checkpoint is one file
    assert os.path.basename(summary["checkpoint"]) in ("bestAucModel", "finalModel")
    scores = summary["scores"]
    assert set(scores) >= {"auc", "group_auc", "mrr", "ndcg@5", "ndcg@10"}
    assert 0.0 <= scores["auc"] <= 1.0
    with open(summary["preds_pkl"], "rb") as f:
        assert len(pickle.load(f)) > 0
    erun = os.path.dirname(summary["preds_pkl"])
    for dump in ("group_auc.txt", "mrr.txt", "ndcg5.txt", "ndcg10.txt"):
        assert os.path.exists(os.path.join(erun, dump)), dump


def test_turnkey_from_directory(turnkeys):
    jax_summary, port_summary, _ = turnkeys
    _check_turnkey(port_summary, os.path.dirname(port_summary["data_dir"]))
    # the JAX turnkey's prepared splits, file for file
    assert _files(port_summary["data_dir"]) == _files(jax_summary["data_dir"])
    assert set(port_summary) == set(jax_summary)


def _analyze(*argv):
    out = subprocess.run([sys.executable, ANALYZE, *argv], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_analyze_preds_reads_port_beside_jax(turnkeys):
    """The port's ``preds.pkl`` and per-impression dumps are the JAX
    package's of the same scores, byte for byte, and ``tools/analyze_preds.py``
    reads them alike."""
    _, port_summary, jax_eval = turnkeys
    port_eval = os.path.dirname(port_summary["preds_pkl"])
    names = ["preds.pkl", "group_auc.txt", "mrr.txt", "ndcg5.txt", "ndcg10.txt"]
    jax_files = _files(jax_eval)
    assert sorted(jax_files) == sorted(names)
    port_files = _files(port_eval)
    assert {n: port_files[n] for n in names} == jax_files
    outs = [_analyze("preds", os.path.join(d, "preds.pkl"), "--top", "2")
            for d in (jax_eval, port_eval)]
    assert outs[0] == outs[1] and "impressions: " in outs[0]
    text = _analyze("compare", "--run_a", jax_eval, "--run_b", port_eval,
                    "--metrics", "group_auc", "mrr", "ndcg5", "ndcg10", "--verbose")
    for metric in ("group_auc", "mrr", "ndcg5", "ndcg10"):
        line = next(l for l in text.splitlines() if l.startswith(metric + ":"))
        n_a, n_b = re.findall(r" n=(\d+)\)", line)
        assert n_a == n_b and int(n_a) > 0 and "diff=+0.0000" in line, line


def test_turnkey_from_archive_with_local_tokenizer(tmp_path, monkeypatch, caplog):
    """A zip of raw TSVs, as MIND ships, trained with ``--pretrained_tokenizer``
    a local WordPiece directory (RUNBOOK_MIND's real-data route)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    src = make_fixture(str(tmp_path / "src"), num_lines=30)
    archive = str(tmp_path / "mind_fixture.zip")
    with zipfile.ZipFile(archive, "w") as z:
        for name in ("behaviors.tsv", "news.tsv"):
            z.write(os.path.join(src, name), arcname=f"MINDfixture/{name}")
    tok_dir = _wordpiece_dir(tmp_path, os.path.join(src, "news.tsv"))
    out = str(tmp_path / "run")
    with caplog.at_level(logging.WARNING):
        summary = turnkey_mind.main(["--archive", archive, "--out", out,
                                     "--valid_impressions", "5",
                                     "--pretrained_tokenizer", tok_dir, "--device", "cpu"])
    assert not [r for r in caplog.records if "falling back" in r.getMessage()]
    _check_turnkey(summary, out)
    run_args = json.load(open(glob.glob(os.path.join(out, "train_out", "*", "args.json"))[0]))
    assert run_args["pretrained_tokenizer"] == tok_dir
    assert run_args["compute_dtype"] == "float32"  # the CPU's default


# ---------------------------------------------------------------- tokenizer
def _titles(news_tsv):
    with open(news_tsv, encoding="utf-8") as f:
        return [line.split("\t")[1] for line in f if line.strip()]


def _wordpiece_dir(tmp_path, news_tsv):
    """A WordPiece tokenizer written from a ``vocab.txt`` of the corpus's
    words and a few of their pieces (no download)."""
    from transformers import BertTokenizerFast

    words = sorted({w for t in _titles(news_tsv) for w in t.lower().split()})
    pieces = sorted({"##" + w[i:] for w in words for i in (2, 3) if len(w) > i})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        sorted({w[:2] for w in words} | {w[:3] for w in words}) + words + pieces
    vocab = list(dict.fromkeys(vocab))
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    out = str(tmp_path / "wordpiece")
    BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(out)
    return out


def test_load_tokenizer_local_directory_matches_jax(tmp_path, monkeypatch):
    from miner_tpu.data.tokenization import load_tokenizer as jax_load
    from miner_tpu_torch.data.tokenization import HFTokenizerAdapter
    from miner_tpu_torch.data.tokenization import load_tokenizer as port_load

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    src = make_fixture(str(tmp_path / "src"), num_news=40, num_lines=10)
    tok_dir = _wordpiece_dir(tmp_path, os.path.join(src, "news.tsv"))
    jt, pt = jax_load(tok_dir), port_load(tok_dir)
    assert isinstance(pt, HFTokenizerAdapter)
    assert type(jt).__name__ == "HFTokenizerAdapter"
    assert (pt.vocab_size, pt.cls_token_id, pt.sep_token_id, pt.pad_token_id) == \
        (jt.vocab_size, jt.cls_token_id, jt.sep_token_id, jt.pad_token_id)
    titles = _titles(os.path.join(src, "news.tsv")) + ["an unseen word Rally!"]
    for max_length in (4, 16):
        got = [pt.encode(t, max_length) for t in titles]
        assert got == [jt.encode(t, max_length) for t in titles]
    assert len({tuple(ids) for ids in got}) > len(titles) // 2


# ---------------------------------------------------------------- argvs
def test_turnkey_argv_matches_jax(tmp_path, recorder, capsys):
    from tools import turnkey_mind as jax_turnkey

    src = make_fixture(str(tmp_path / "src"), num_lines=20)
    flags = ["--archive", src, "--out", str(tmp_path / "run"), "--valid_impressions", "3",
             "--pretrained_tokenizer", "hash:1000", "--plm_preset", "small",
             "--hf_checkpoint", str(tmp_path / "hf"), "--title_len", "20", "--sapo_len", "30",
             "--his_len", "12", "--batch", "8", "--accum", "2", "--epochs", "3",
             "--lr", "2e-05", "--seed", "5", "--compute_dtype", "bfloat16"]
    summary = jax_turnkey.main(flags)
    jax_train, jax_eval = recorder.seen
    args = turnkey_mind.make_parser().parse_args(flags + ["--device", "cpu"])
    data = summary["data_dir"]
    train = port_parser().parse_args(turnkey_mind.train_argv(
        args, data, jax_train.train_path, "bfloat16"))
    evaluate = port_parser().parse_args(turnkey_mind.eval_argv(
        args, data, summary["checkpoint"], jax_eval.eval_path, "bfloat16"))
    for jax_ns, port_ns in ((jax_train, train), (jax_eval, evaluate)):
        keys, diff = _common(jax_ns, port_ns, DEVICE)
        assert len(keys) > 50 and not diff, diff
        assert port_ns.device == "cpu"
    assert train.hf_checkpoint == str(tmp_path / "hf") and evaluate.save_eval_result
    # the dtype follows the device where none is given
    assert turnkey_mind.default_dtype(turnkey_mind.make_parser().parse_args(
        ["--archive", src, "--out", "x", "--device", "cpu"])) == "float32"


def _jax_scale_argv(monkeypatch, argv):
    """JAX's ``tools/scale_convergence.py --parse_only`` argv, parsed by its
    own parser (recorded)."""
    import miner_tpu.config as jax_config
    from tools import scale_convergence as jax_scale

    seen = []
    real = jax_config.make_parser

    def recording():
        p = real()
        parse = p.parse_args
        p.parse_args = lambda a=None, ns=None: seen.append(parse(a, ns)) or seen[-1]
        return p

    monkeypatch.setattr(jax_config, "make_parser", recording)
    monkeypatch.setattr(sys, "argv", ["scale_convergence.py", *argv])
    jax_scale.main()
    return seen[-1]


@pytest.mark.parametrize("model,dtype,extra", [
    ("miner", "bf16", []), ("miner", "fp32", []), ("unbert", "bf16", []),
    ("fastformer", "bf16", []), ("unisrec", "bf16", []), ("unisrec", "fp32", []),
    ("miner", "bf16", ["--legacy_history_layout", "--pretrained_embedding", "hf",
                       "--seed", "3", "--epochs", "2", "--batch", "32", "--lr", "5e-05",
                       "--tag", "_x"]),
])
def test_scale_convergence_argv_matches_jax(tmp_path, monkeypatch, capsys, model, dtype, extra):
    argv = ["--model", model, "--dtype", dtype, "--out", str(tmp_path), "--parse_only", *extra]
    jax_ns = _jax_scale_argv(monkeypatch, argv)
    assert scale_convergence.main(argv + ["--device", "cpu"]) is None
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == out[1]  # "parse ok: mode=... model_name=..." from both
    args = scale_convergence.make_parser().parse_args(argv + ["--device", "cpu"])
    port_ns = port_parser().parse_args(scale_convergence.trainer_argv(
        args, os.path.join(str(tmp_path), "data"),
        os.path.join(str(tmp_path), f"conv_{model}" + ("_x" if extra else ""))))
    keys, diff = _common(jax_ns, port_ns, DEVICE | (FP32_ONLY_JAX if dtype == "fp32" else set()))
    assert len(keys) > 50 and not diff, diff
    if dtype == "fp32":
        assert jax_ns.fused_kernels is False and port_ns.fused_kernels is None
        assert port_ns.compute_dtype == "float32"
    assert port_ns.device == "cpu" and jax_ns.model_name == port_ns.model_name


@pytest.mark.parametrize("leg", ["cpu", "card_bf16", "card_fp32"])
def test_quality_run_argv_matches_jax(tmp_path, monkeypatch, recorder, leg):
    from tools import quality_run as jax_quality

    for k in quality_run.PRESETS["tiny"]:  # JAX's presets are module globals
        monkeypatch.setattr(jax_quality, k, jax_quality.__dict__[k])
    data, out = str(tmp_path / "data"), str(tmp_path / "ours")
    tpu = leg != "cpu"
    dtype = "fp32" if leg != "card_bf16" else "bf16"
    for preset, init, seed in (("tiny", None, None), ("tiny", "init.ckpt", 303),
                               ("mid", None, None), ("mid", "init.ckpt", 303)):
        jax_quality._apply_preset(preset)
        g = quality_run.PRESETS[preset]
        assert {k: jax_quality.__dict__[k] for k in g} == g
        recorder.seen.clear()
        jax_quality.run_ours(data, out, tpu=tpu, init_ckpt=init, seed=seed,
                             dtype=dtype if tpu else None)
        port_ns = port_parser().parse_args(quality_run.train_argv(
            g, data, out, quality_run.leg_extra("cpu" if leg == "cpu" else "cuda", dtype,
                                                init, seed)))
        keys, diff = _common(recorder.seen[0], port_ns,
                             DEVICE | (FP32_ONLY_JAX if leg == "card_fp32" else set()))
        assert len(keys) > 50 and not diff, diff
        assert port_ns.device == ("cpu" if leg == "cpu" else None)
        assert port_ns.compute_dtype == ("bfloat16" if leg == "card_bf16" else "float32")


def test_fisher_exact_matches_scipy():
    stats = pytest.importorskip("scipy.stats")
    for table in ((5, 3, 4, 4), (8, 0, 4, 4), (0, 8, 5, 3), (3, 5, 5, 3), (7, 1, 1, 7)):
        a, b, c, d = table
        want = stats.fisher_exact([[a, b], [c, d]])[1]
        assert abs(quality_run.fisher_exact(a, b, c, d) - want) < 1e-12, table


# ---------------------------------------------------------------- CPU runs
def test_scale_convergence_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """The at-scale tool end to end on a corpus of 200 news (the PLM's
    dropout off for time: its plain Philox draw on the CPU costs seconds a
    micro-batch)."""
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    res = scale_convergence.main([
        "--model", "miner", "--out", str(tmp_path), "--news", "200", "--events", "12",
        "--eval_lines", "4", "--epochs", "3", "--stop_after_epochs", "1", "--batch", "8",
        "--dtype", "fp32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "corpus generated in" in out
    assert "miner at-scale convergence (3 epochs, stopped after 1, fp32, seed 1" in out
    assert "| epoch | auc | group_auc | mrr | ndcg@5 | ndcg@10 |" in out
    assert len([l for l in out.splitlines() if l.startswith("| 0 |")]) == 1
    assert sorted(res["epochs"]) == [0] and 0.0 <= res["epochs"][0]["auc"] <= 1.0
    assert res["examples_per_s"] > 0 and "examples/s" in out
    # one epoch trained, the learning rate's schedule over three: the
    # events counted as the trainer counts them
    per_epoch = scale_convergence.train_events(
        os.path.join(str(tmp_path), "data", "behaviors.tsv")) // 8
    assert per_epoch > 0 and res["steps"] == per_epoch
    with open(os.path.join(res["run_dir"], "args.json")) as f:
        run_args = json.load(f)
    assert (run_args["num_train_epochs"], run_args["max_steps"]) == (1, 3 * per_epoch)


def test_quality_run_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    report = str(tmp_path / "report.md")
    res = quality_run.main(["--out", str(tmp_path), "--events", "48", "--news", "80",
                            "--eval_lines", "12", "--epochs", "1", "--seeds", "1", "2",
                            "--device", "cpu", "--fisher_against", "torch=5/8",
                            "--report", report])
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l.startswith("| miner_tpu_torch (CPU fp32)")]
    assert len(rows) == 2 and all(("learned" in r) != ("stuck" in r) for r in rows)
    assert f"learned {res['learned']} of 2" in out
    assert "Fisher exact (two-sided) against torch (5/8 learned)" in out
    assert open(report).read().count("| miner_tpu_torch") == 2
    with pytest.raises(SystemExit):
        quality_run.main(["--out", str(tmp_path), "--device", "cpu", "--dtype", "bf16"])


# ---------------------------------------------------------------- imports
def test_port_imports_nothing_of_jax():
    """No module of the port names ``jax``, ``miner_tpu`` or ``tools`` in an
    import, and the tools import none of them when run."""
    bad = []
    for path in glob.glob(os.path.join(REPO, "miner_tpu_torch", "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and
                     not node.level else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "miner_tpu", "tools")]
    assert not bad, bad
    code = ("import sys\n"
            "import miner_tpu_torch.tools.synth_mind, miner_tpu_torch.tools.prepare_mind\n"
            "import miner_tpu_torch.tools.turnkey_mind, miner_tpu_torch.tools.scale_convergence\n"
            "import miner_tpu_torch.tools.quality_run\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'miner_tpu', 'tools')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
