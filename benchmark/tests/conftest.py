"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository (the tests that need a card carry the ``gpu`` marker
and skip without one)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE)), HERE]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny

    return tiny.make_root(str(tmp_path_factory.mktemp("bench-root")))


def run_cell(root, workload, *extra, seed=2 ** 31 + 123, seconds=2, trace=0):
    """One run of ``workload`` on the CPU: (exit code, result or None)."""
    import contextlib
    import io
    import json

    from harness import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace), "--device", "cpu", "--root", root, *extra])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
