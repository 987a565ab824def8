"""Whole runs of the tiny cells on the CPU: the result's keys, the traced
run's, the refusal without a card."""
import contextlib
import io

from conftest import run_cell

from harness import main


def test_train_run_and_its_result(tiny_root):
    rc, r = run_cell(tiny_root, "tiny-train", seed=2 ** 31 + 77)
    assert rc == 0 and r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "notes", "check"]
    assert set(r["check"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert r["device"]["platform"] == "cpu"
    assert r["metrics"]["train_examples_per_s"]["value"] > 0


def test_rerank_run_and_its_result(tiny_root):
    rc, r = run_cell(tiny_root, "tiny-rerank", seed=2 ** 31 + 78)
    assert rc == 0 and r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == 16
    assert set(r["check"]) == {"score_gap", "score_rms_gap", "unsorted_replies"}
    assert r["metrics"]["rerank_p95_ms"]["value"] > 0


def test_traced_runs_report_the_host_side_metrics(tiny_root):
    rc, r = run_cell(tiny_root, "tiny-rerank", seed=5, trace=1)
    assert rc == 0 and r["correct"] is True
    # on the CPU there is no device trace: only the spans' and counters' metrics
    assert set(r["metrics"]) == {"padding_pct.rerank", "requests_per_call.rerank",
                                 "pack_share_pct.rerank"}
    rc, r = run_cell(tiny_root, "tiny-train", seed=6, trace=1)
    assert rc == 0 and set(r["metrics"]) == {"host_data_ms.train"}


def test_no_card_no_result(tiny_root):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main.main(["--workload", "tiny-train", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--root", tiny_root])
    assert rc != 0 and out.getvalue() == ""
    assert "no result" in err.getvalue()
