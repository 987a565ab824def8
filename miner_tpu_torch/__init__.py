"""miner_tpu_torch — the MINER news recommender in PyTorch for an NVIDIA H100.

A port of ``miner_tpu`` (JAX / Flax / Pallas on a TPU), which stays beside it
as the reference. Module names mirror the JAX package so each counterpart is
easy to find. The port imports nothing of ``miner_tpu`` and nothing of JAX:
what it needs from the reference's host side is copied here.

Every Pallas kernel on a ported path has a hand-written Hopper kernel under
``csrc/`` (CUDA C++, built with ``nvcc`` at first use and bound with
``ctypes``) or in Triton, with a plain PyTorch version of the same function
beside it in ``ops/``. A kernel wrapper takes the plain version only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.

Ported so far: training and evaluation of the Miner and Fastformer
families (``python -m miner_tpu_torch train`` / ``eval``, and
``train_fastformer`` / ``eval_fastformer``), with augmented news variants
and warm starts; contrastive pretraining of the news encoder
(``pretrain``); and serving both from the news-embedding cache (``serve`` /
``recommend``), persisted across restarts and optionally int8. Every
Pallas kernel of the JAX package now has its Hopper counterpart.
"""

__version__ = "0.1.0"
