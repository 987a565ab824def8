"""The benchmark of the PyTorch and CUDA port (``miner_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Each cell of ``BENCHMARK.json`` names a
configuration and a traffic mix, found by name under ``benchmark/``
(``harness/spec.py``). See ``benchmark/README.md``.

The kernel caches stay inside the checkout at fixed paths, set here before
anything imports Triton: ``benchmark/.cache/triton`` for Triton, and the
port's own ``miner_tpu_torch/build/`` for nvcc. Nothing here or in the port
loads JAX: ``transformers`` is kept from loading flax.
"""
import os
import sys
import time

STARTED = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[var] = "0"
sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from harness import main

    sys.exit(main.main(sys.argv[1:], started=min(STARTED, main.process_start())))
