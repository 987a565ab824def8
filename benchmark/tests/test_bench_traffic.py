"""Traffic is drawn from the seed: the same seed gives the same inputs,
another seed others, with the same sizes and arrivals in another order."""
import filecmp
import json
import os

import numpy as np

from harness import corpus, rerank, spec

TRAFFIC = json.load(open(os.path.join(spec.BENCH_DIR, "traffic", "rerank-mind.json")))
SMALL = {**TRAFFIC["corpus"], "news": 400, "impressions": 50, "users": 20}


def test_corpus_same_seed_same_bytes_other_seed_other(tmp_path):
    a = corpus.write_corpus(str(tmp_path / "a"), SMALL, 2 ** 31 + 5)
    b = corpus.write_corpus(str(tmp_path / "b"), SMALL, 2 ** 31 + 5)
    c = corpus.write_corpus(str(tmp_path / "c"), SMALL, 2 ** 31 + 6)
    for name in ("news", "behaviors"):
        assert filecmp.cmp(a[name], b[name], shallow=False)
        assert not filecmp.cmp(a[name], c[name], shallow=False)


def test_requests_same_seed_same_other_seed_same_sizes_in_another_order():
    a = rerank.requests(TRAFFIC, 7, 10, 64, 5000)
    b = rerank.requests(TRAFFIC, 7, 10, 64, 5000)
    c = rerank.requests(TRAFFIC, 8, 10, 64, 5000)
    assert a == b and a != c
    assert len(a) == len(c) == 640

    def sizes(reqs):
        return sorted((len(q["body"]["candidates"]), len(q["body"]["history"])) for q in reqs)

    def gaps(reqs):
        due = np.array([q["due"] for q in reqs])
        return np.sort(np.diff(np.concatenate([[0.0], due])))

    assert [s for s, _ in sizes(a)] == sorted(s for s, _ in sizes(c))
    np.testing.assert_allclose(gaps(a), gaps(c))
    for q in a:
        ids = q["body"]["candidates"] + q["body"]["history"]
        assert len(set(ids)) == len(ids)
        assert 5 <= len(q["body"]["candidates"]) <= 128 and 1 <= len(q["body"]["history"]) <= 50
    assert all(0.0 <= q["due"] <= 10.0 for q in a)
