"""The trace's reduction on a made-up device trace: busy time, the marks'
pairing, and the readers of the update and of the data plane."""
from types import SimpleNamespace

import pytest

from harness import spec, trace


def _prof(events):
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return SimpleNamespace(events=lambda: [
        SimpleNamespace(name=n, device_type=cuda, time_range=SimpleNamespace(start=s, end=e))
        for s, e, n in events])


def _events(update_us=300.0):
    """The anchor at 0 us; two micro-steps of 1,000 us each, with the
    optimizer's marks after each; the second carries an update."""
    spin = trace.ANCHOR_KERNEL
    return [(0, 1, spin),
            (10, 1010, "nvjet_gemm"), (1020, 1021, spin), (1030, 1031, spin),
            (1040, 2040, "mha_fwd"), (2050, 2051, spin),
            (2060, 2060 + update_us / 2, "multi_tensor_apply_kernel"),
            (2070 + update_us / 2, 2070 + update_us, "reduce_kernel"),
            (2080 + update_us, 2081 + update_us, spin)]


def test_reduce_sums_the_work_between_each_pair_of_marks():
    spans = trace.Spans()
    got = trace.reduce(_prof(_events()), t_anchor=0.0, window=(0.0, 0.01), spans=spans)
    assert got["marked"] == pytest.approx([0.0, 300e-6])
    assert got["busy_s"] == pytest.approx(2300e-6)
    assert all(trace.ANCHOR_KERNEL not in k for k in got["kernels"])


def test_unpaired_marks_read_as_nothing():
    got = trace.reduce(_prof(_events()[:-1]), 0.0, (0.0, 0.01), trace.Spans())
    assert got["marked"] is None


def test_update_and_data_plane_readers():
    cell = spec.cell("miner-train")
    spans = trace.Spans()
    spans.intervals["host_data"] += [(0.0, 0.001), (1.0, 1.003)]
    spans.intervals["host_to_device"] += [(2.0, 2.5)]  # the card's backlog: not counted
    got = trace.reduce(_prof(_events()), 0.0, (0.0, 0.01), spans)
    ctx = SimpleNamespace(kind="train", cfg={}, micro_batches=2, trace=got, spans=spans,
                          updated=[False, True])
    assert cell.readers["update_ms.train"].read(ctx) == pytest.approx(0.3)
    assert cell.readers["host_data_ms.train"].read(ctx) == pytest.approx(2.0)
    ctx.updated = [False, False]
    assert cell.readers["update_ms.train"].read(ctx) is None
    ctx.updated, ctx.micro_batches = [False, True, False], 3  # a mark lost
    assert cell.readers["update_ms.train"].read(ctx) is None
