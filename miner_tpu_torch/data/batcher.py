"""Batcher: SampleBlock -> fixed-shape index batches.

Every batch has exactly ``batch_size`` rows (the tail is padded and carries a
``valid`` count) so every step sees one shape.  The per-step host->device
payload is a handful of small int32 arrays; token gathering happens on device
from the resident news table (see ``miner_tpu_torch.data.device_table``).

The port's own copy of ``miner_tpu/data/batcher.py``
(the port imports nothing of the JAX package); the tests hold the two
equal.
"""
from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np

from miner_tpu_torch.data.samplers import SampleBlock


def block_size(block) -> int:
    if isinstance(block, dict):
        return len(next(iter(block.values())))
    return len(block)


class Batcher:
    def __init__(
        self,
        batch_size: int,
        drop_last: bool = False,
        shuffle: bool = False,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed

    def num_batches(self, n: int) -> int:
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def batches(
        self, block: Union[SampleBlock, Dict[str, np.ndarray]], epoch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Batch a SampleBlock (index samples), a dict of row-aligned arrays,
        or a lazy block exposing ``materialize(idx)`` (UnBERT packed features
        — built per batch so host memory stays O(batch))."""
        lazy = hasattr(block, "materialize")
        if lazy:
            fields = None
        elif isinstance(block, dict):
            fields = block
        else:
            fields = {
                "cand_idx": block.cand,
                "his_idx": block.his,
                "label": block.label,
                "impression_id": block.impression_id,
            }
        n = block_size(block)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch, 997))
            rng.shuffle(order)
        B = self.batch_size
        nb = self.num_batches(n)
        for b in range(nb):
            idx = order[b * B : (b + 1) * B]
            valid = len(idx)
            if valid < B:  # pad the tail batch by repeating row 0
                idx = np.concatenate([idx, np.zeros(B - valid, dtype=idx.dtype)])
            if lazy:
                out = block.materialize(idx)
            else:
                out = {k: v[idx] for k, v in fields.items()}
            out["valid"] = np.int32(valid)
            yield out
