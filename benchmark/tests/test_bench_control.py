"""On the card: the control (the reference in the program's place, in fp8)
and the half-batch fault come out not correct against the training cell's
limits, at the cell's own size, on one seed. Run on the card:
python -m pytest -m gpu benchmark/tests"""
import pytest

import control
from harness import spec


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's readings are the card's")


def _failed(readings, limits):
    return [k for k, lim in limits.items() if k in readings and readings[k] > lim]


@pytest.mark.gpu
def test_train_control_and_fault_are_not_correct(tmp_path):
    _card()
    cell = spec.cell("miner-train")
    got = control.train_readings(cell, 2 ** 31 + 402, str(tmp_path), "cuda")
    assert _failed(got["control_fp8"], cell.limits["limits"])
    assert _failed(got["fault_half_batch"], cell.limits["limits"])
