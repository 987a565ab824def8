"""Nothing under benchmark/ imports JAX, its libraries or the JAX package;
the references import nothing of the port; the process check compares
top-level names whole."""
import ast
import os
import sys

import pytest

from harness import main, spec

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.BENCH_DIR) for f in fs
               if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not set(imported(path)) & set(main.FORBIDDEN)


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "miner_tpu_torch" not in set(imported(path))


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "miner_tpu_torch_lookalike", sys)
    assert main.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "miner_tpu.models", sys)
    assert main.loaded_forbidden() == ["miner_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert main.loaded_forbidden() == ["jaxlib", "miner_tpu"]
