"""The readers of the program's own spans (``metrics/_spans.py`` and the
metrics that use it), on the CPU at tiny sizes: each finds a number in a
traced run of its cell, and nothing in an untraced run or in a program
without the tracer."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spec

SEED = 2**31 + 977
SPAN_METRICS = [m for m in spec.manifest()["per_layer"] if m["source"] == "program_span" and
                m["name"] != "serve.forward_ms_p50"]  # that one reads the service's own stats


def run(tiny, name, trace):
    return harness.run_cell(name, SEED, 1.0, trace, device="cpu", overrides=tiny, log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def traced_lines(tiny):
    return {cell: run(tiny, cell, True) for cell in sorted({c for m in SPAN_METRICS for c in m["workloads"]})}


def test_the_span_metrics_are_the_ones_of_the_tracer():
    assert sorted(m["name"] for m in SPAN_METRICS) == sorted([
        "serve.queue_ms_p50", "serve.respond_ms_p50", "serve.forward_device_ms_p50", "serve.batcher_wait_share",
        "data_wait.train.scale_up", "data_wait.forecast"])


@pytest.mark.parametrize("entry", SPAN_METRICS, ids=lambda m: m["name"])
def test_each_reader_finds_a_number_in_a_traced_run_of_its_cell(traced_lines, entry):
    for cell in entry["workloads"]:
        line = traced_lines[cell]
        assert line["correct"] is True, line["checks"]
        metric = line["metrics"][entry["name"]]
        assert metric["unit"] == entry["unit"] and metric["value"] >= 0
        if entry["unit"] == "%":
            assert metric["value"] <= 100


@pytest.mark.parametrize("cell", sorted({c for m in SPAN_METRICS for c in m["workloads"]}))
def test_an_untraced_run_records_nothing_the_readers_find(tiny, cell):
    with profile(activities=[ProfilerActivity.CPU]):
        pass  # an empty session in place of what earlier runs recorded
    line = run(tiny, cell, False)
    assert line["correct"] is True
    record = {"trace": {"window_s": 1.0}, "window": {}, "config": {}, "device_kind": "cpu"}
    for entry in SPAN_METRICS:
        if cell in entry["workloads"]:
            assert spec.reader(entry["name"]).read(record) is None, entry["name"]


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    """A program whose ``utils/profiler.py`` has no ``recorded`` (the port
    before its tracer): the readers return None there and do not raise."""
    from tec_mollm_tpu_torch.utils import profiler

    with profile(activities=[ProfilerActivity.CPU]):
        t = profiler.now()
        for k in range(20):
            profiler.record("serve.queue", t + k, t + 2 * k + 1)
    record = {"trace": {"window_s": 1.0}, "window": {}, "config": {}, "device_kind": "cpu"}
    assert spec.reader("serve.queue_ms_p50").read(record) == pytest.approx(10.5e-6)
    monkeypatch.delattr(profiler, "recorded")
    for entry in SPAN_METRICS:
        assert spec.reader(entry["name"]).read(record) is None, entry["name"]
