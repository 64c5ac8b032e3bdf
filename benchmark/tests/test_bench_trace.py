"""The trace reduction: the device's busy time is the union of its
intervals, and every gap between them is found."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import trace


def test_union_counts_overlap_once_and_finds_the_gaps():
    iv = np.array([[0, 10], [5, 12], [20, 30], [22, 25], [40, 41]], dtype=np.float64)
    busy, gaps = trace._union(iv)
    assert busy == 12 + 10 + 1
    assert gaps.tolist() == [[12, 20], [30, 40]]


def test_reduce_on_events():
    def ev(name, start, dur, device, corr=0, user=False, tid=1):
        return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                               device_type=lambda: device, correlation_id=lambda: corr,
                               linked_correlation_id=lambda: 0, start_thread_id=lambda: tid,
                               is_user_annotation=lambda: user)

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    cap = trace.Capture(torch.device("cpu"))
    cap.window_s = 1e-6 * 100
    cap.events = [
        ev("benchmark::spatial_encoder", 0, 30, cpu, user=True),
        ev("cudaLaunchKernel", 5, 2, cpu, corr=7),
        ev("cuLaunchKernel", 50, 2, cpu, corr=8),
        ev("aten::mm", 45, 20, cpu),
        ev("gat_kernel", 10, 20, cuda, corr=7),
        ev("gemm", 60, 30, cuda, corr=8),
    ]
    out = trace.reduce(cap)
    assert out["launches"] == 2
    assert out["busy_s"] == pytest.approx(50e-9)
    assert out["spans"] == {"spatial_encoder": [pytest.approx(20e-9)]}
    assert out["idle_gaps"] == [["aten::mm", pytest.approx(30e-9)]]
