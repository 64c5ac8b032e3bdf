"""PyTorch port: the tracer of ``utils/profiler.py`` and the spans the serving,
data, training and evaluation layers open.

Spans record only while a ``torch.profiler`` is active, on every thread of
the process; off, they build nothing. A session is one profiler-active
interval and replaces the last. Span times are on the clock kineto stamps its
own events on, and ``trace(logdir)`` writes them into the Chrome trace."""

import dataclasses
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler
from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
from tec_mollm_tpu_torch.evaluation.harness import EvalExecutor
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.models.gpt2 import GPT2Backbone
from tec_mollm_tpu_torch.serving import ForecastService, make_server
from tec_mollm_tpu_torch.training.trainer import Trainer
from tec_mollm_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = [ProfilerActivity.CPU]
SLACK_NS = 50_000


def _cfg():
    c = pcfg.tiny_config()
    return dataclasses.replace(
        c, train=dataclasses.replace(c.train, bf16=False, batch_size=2, accumulation_steps=2)
    ).resolved()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny processed directory, its graph, splits and seeded weights."""
    cfg = _cfg()
    m, t = cfg.model, cfg.train
    path = str(tmp_path_factory.mktemp("trace_proc"))
    for mode, n, seed in (("train", 9, 0), ("test", 10, 1)):
        split = synthetic_processed_split(n, t.L_in, t.L_out, m.num_nodes, seed=seed)
        np.savez(os.path.join(path, f"{mode}_set.npz"), **split)
    graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
    graph.save(os.path.join(path, "graph.npz"))
    scaler = StandardScaler(np.array([25.0]), np.array([12.0]))
    scaler.save(os.path.join(path, "target_scaler.npz"))
    shifts, _ = graph_inputs(graph, "cpu")
    state = TECMoLLM(m, shifts, seed=3).state_dict()
    load = lambda mode: SlidingWindowDataset.from_dir(path, mode, t.L_in, t.L_out, stride=1)  # noqa: E731
    return {"cfg": cfg, "dir": path, "graph": GraphData.load(os.path.join(path, "graph.npz")), "scaler": scaler,
            "state": state, "train": load("train"), "test": load("test")}


@pytest.fixture
def service(world):
    svc = ForecastService(world["cfg"], world["dir"], state_dict=world["state"], device="cpu")
    yield svc
    svc.close()


def _post(port: int, indices: list[int]) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/forecast", data=json.dumps({"indices": indices}).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


class _Http:
    def __init__(self, service):
        self.httpd = make_server(service, "127.0.0.1", 0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def _by_name(rec: dict, name: str) -> list[dict]:
    return [s for s in rec["spans"] if s["name"] == name]


def test_off_spans_record_nothing_and_build_no_record_function(world, tmp_path, monkeypatch):
    """With no profiler active, a served request, a train epoch and a scoring
    pass run while ``record_function`` would raise, and record nothing."""
    with profile(activities=CPU):
        pass  # an empty session: what earlier tests recorded is gone
    assert profiler.recorded()["spans"] == []

    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiler.span("x")
    assert profiler.record("x", 0, 1) is None
    # made after that session, so that the batcher's first wait is no part of it
    service = ForecastService(world["cfg"], world["dir"], state_dict=world["state"], device="cpu")
    try:
        with _Http(service) as http:
            assert len(_post(http.port, [0, 1])["forecast"]) == 2
    finally:
        service.close()
    cfg = world["cfg"]
    trainer = Trainer(cfg, world["train"], None, world["graph"], None, workdir=str(tmp_path), device="cpu")
    assert trainer.train_epoch(checkpoints=False)["updates"] > 0
    ex = EvalExecutor(cfg, world["graph"], world["state"], 4, "cpu")
    assert np.isfinite(ex.stream_metrics(world["test"], world["scaler"])["rmse_avg"])
    rec = profiler.recorded()
    assert rec["spans"] == [] and rec["counts"] == {}


def test_spans_of_every_thread_record_with_their_parents_and_self_time():
    def background():
        with profiler.span("bg.outer", item=7):
            time.sleep(0.002)
            with profiler.span("bg.inner"):
                time.sleep(0.003)

    with profile(activities=CPU):
        with profiler.span("main.outer") as outer:
            t = threading.Thread(target=background, name="bg-worker")
            t.start()
            with profiler.span("main.inner"):
                time.sleep(0.004)
            with profiler.span("main.inner"):
                time.sleep(0.002)
            t.join()
        profiler.count("things", 3)
        profiler.count("things")
    rec = profiler.recorded()
    main_outer, = _by_name(rec, "main.outer")
    main_inner = _by_name(rec, "main.inner")
    bg_outer, = _by_name(rec, "bg.outer")
    bg_inner, = _by_name(rec, "bg.inner")
    assert main_outer["id"] == outer.id and main_outer["parent"] is None
    assert [s["parent"] for s in main_inner] == [outer.id] * 2
    assert bg_outer["parent"] is None and bg_inner["parent"] == bg_outer["id"]
    assert bg_outer["attrs"] == {"item": 7}
    assert bg_outer["thread"] != main_outer["thread"] and rec["threads"][bg_outer["thread"]] == "bg-worker"
    assert rec["counts"] == {"things": 4}
    for parent, children in ((main_outer, main_inner), (bg_outer, [bg_inner])):
        total = parent["end_ns"] - parent["start_ns"]
        covered = sum(c["end_ns"] - c["start_ns"] for c in children)
        stats = rec["stats"][parent["name"]]
        assert stats["count"] == 1 and stats["total_ms"] == pytest.approx(total * 1e-6)
        assert stats["self_ms"] == pytest.approx((total - covered) * 1e-6)
    assert rec["stats"]["main.inner"]["count"] == 2
    assert rec["stats"]["main.inner"]["p50_ms"] >= 2.0


def test_span_shares_the_clock_of_the_profiler_events():
    """A span around a torch op brackets that op's kineto event, by the
    event's own start and duration."""
    a = torch.randn(256, 256)
    with profile(activities=CPU) as prof:
        with profiler.span("clock"):
            torch.mm(a, a)
    sp, = _by_name(profiler.recorded(), "clock")
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert sp["start_ns"] - SLACK_NS <= start and end <= sp["end_ns"] + SLACK_NS


def test_a_new_session_replaces_the_last():
    with profile(activities=CPU):
        with profiler.span("first"):
            pass
    assert [s["name"] for s in profiler.recorded()["spans"]] == ["first"]
    with profile(activities=CPU):
        with profiler.span("second"):
            pass
        profiler.count("second.count")
    rec = profiler.recorded()
    assert [s["name"] for s in rec["spans"]] == ["second"] and rec["counts"] == {"second.count": 1}
    assert rec["window_ns"][1] is not None and rec["window_ns"][0] < rec["window_ns"][1]


def test_a_span_open_at_the_stop_is_clipped_and_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_RECORDS", 3)
    with profile(activities=CPU):
        for _ in range(5):
            with profiler.span("many"):
                pass
        still_open = profiler.span("open")
        still_open.__enter__()
    still_open.__exit__(None, None, None)
    rec = profiler.recorded()
    assert len(rec["spans"]) == 3 and rec["dropped"] == 3
    monkeypatch.setattr(profiler, "MAX_RECORDS", 10)
    with profile(activities=CPU):
        sp = profiler.span("open")
        sp.__enter__()
    time.sleep(0.01)
    sp.__exit__(None, None, None)
    rec = profiler.recorded()
    opened, = _by_name(rec, "open")
    assert opened["end_ns"] <= rec["window_ns"][1]


def test_an_interval_across_the_session_edges_counts_for_its_part_inside():
    """``record`` clips to the session: an interval begun before the profiler
    started counts from its start, one recorded after it stopped ends at its
    stop, and one wholly outside is not kept."""
    before = profiler.now()
    with profile(activities=CPU):
        inside = profiler.now()
        assert profiler.record("across.start", before, inside) is not None
        assert profiler.record("before", before - 10, before) is None
    after = profiler.now()
    assert profiler.record("across.stop", inside, after) is not None
    assert profiler.record("after", after, after + 10) is None
    rec = profiler.recorded()
    lo, hi = rec["window_ns"]
    first, = _by_name(rec, "across.start")
    last, = _by_name(rec, "across.stop")
    assert first["start_ns"] == lo and first["end_ns"] < hi
    assert last["end_ns"] == hi and last["start_ns"] == first["end_ns"]
    assert {s["name"] for s in rec["spans"]} == {"across.start", "across.stop"}


def test_a_traced_request_over_http_carries_its_id_through_every_stage(service):
    with _Http(service) as http:
        _post(http.port, [0])  # warm the handler path
        with profile(activities=CPU):
            out = _post(http.port, [1, 2])
    assert len(out["forecast"]) == 2
    rec = profiler.recorded()
    request, = _by_name(rec, "serve.request")
    rid = request["attrs"]["request"]
    for name in ("serve.parse", "serve.queue", "serve.respond"):
        sp, = _by_name(rec, name)
        assert sp["attrs"]["request"] == rid and sp["parent"] == request["id"], name
        assert request["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= request["end_ns"], name
    encode, = _by_name(rec, "serve.encode")
    assert encode["parent"] == _by_name(rec, "serve.respond")[0]["id"]
    dispatch, = _by_name(rec, "serve.dispatch")
    assert rid in dispatch["attrs"]["requests"] and dispatch["attrs"]["rows"] == 2
    assert dispatch["attrs"]["device_ms"] > 0
    queue, = _by_name(rec, "serve.queue")
    assert queue["end_ns"] == dispatch["start_ns"]
    for name in ("serve.gather", "serve.h2d", "serve.forward", "serve.d2h"):
        sp, = _by_name(rec, name)
        assert sp["parent"] == dispatch["id"], name
    assert _by_name(rec, "serve.d2h")[0]["end_ns"] == dispatch["end_ns"]
    assert _by_name(rec, "serve.batch_window")[0]["attrs"]["requests"] == [rid]
    deliver, = _by_name(rec, "serve.deliver")
    assert deliver["start_ns"] >= dispatch["end_ns"] and deliver["end_ns"] <= request["end_ns"]
    # the batcher was waiting when the profiler started: that wait counts from the session's start
    wait, = _by_name(rec, "serve.batcher_wait")
    assert wait["start_ns"] == rec["window_ns"][0] and wait["end_ns"] <= dispatch["start_ns"]
    # the one forward's dense layers, each finished in its product's epilogue
    assert rec["counts"] == {"llm.dense.epilogue": 4 * service.cfg.model.llm_layers}
    stats = service.stats()
    assert stats["batches"] == 2 and stats["padded_rows"] == 2 * service.max_batch - 3  # rows 1 and 2
    assert f"tec_mollm_padded_rows_total {stats['padded_rows']}" in service.metrics_text()


def test_a_traced_forecast_without_the_batcher_records_the_same_stages(world):
    svc = ForecastService(world["cfg"], world["dir"], state_dict=world["state"], device="cpu", batch_window_ms=0)
    with profile(activities=CPU):
        svc.forecast([0, 3], request=41)
    rec = profiler.recorded()
    dispatch, = _by_name(rec, "serve.dispatch")
    queue, = _by_name(rec, "serve.queue")
    assert dispatch["attrs"]["requests"] == [41] and dispatch["attrs"]["rows"] == 2
    assert queue["attrs"] == {"request": 41} and queue["end_ns"] == dispatch["start_ns"]
    assert {s["parent"] for s in rec["spans"] if s["name"] in ("serve.gather", "serve.h2d", "serve.forward",
                                                               "serve.d2h")} == {dispatch["id"]}
    assert "serve.batcher_wait" not in rec["stats"]


def test_traced_train_and_eval_loops_record_their_stages(world, tmp_path):
    cfg = world["cfg"]
    trainer = Trainer(cfg, world["train"], None, world["graph"], None, workdir=str(tmp_path), device="cpu")
    ex = EvalExecutor(cfg, world["graph"], world["state"], 4, "cpu")
    with profile(activities=CPU):
        trainer.train_epoch(checkpoints=False)
    rec = profiler.recorded()
    steps = len(trainer.train_loader)
    assert {n: rec["stats"][n]["count"] for n in ("data.gather", "train.put", "train.step")} == dict.fromkeys(
        ("data.gather", "train.put", "train.step"), steps)
    assert rec["stats"]["data.wait"]["count"] == steps + 1  # and the end of the epoch
    assert rec["stats"]["train.sync"]["count"] >= 1
    main = threading.get_native_id()
    assert {s["thread"] for s in _by_name(rec, "data.wait")} == {main}
    assert {rec["threads"][s["thread"]] for s in _by_name(rec, "data.gather")} == {"batch-prefetch"}
    with profile(activities=CPU):
        ex.stream_metrics(world["test"], world["scaler"])
    rec = profiler.recorded()
    batches = len(ex.loader(world["test"]))
    assert {n: rec["stats"][n]["count"] for n in ("eval.put", "eval.step", "eval.metrics", "eval.finalize")} == {
        "eval.put": batches, "eval.step": batches, "eval.metrics": batches, "eval.finalize": 1}
    assert "train.step" not in rec["stats"]


def test_trace_writes_every_thread_spans_on_the_file_time_base(tmp_path):
    def background():
        with profiler.span("bg.work"):
            torch.ones(64).sum()

    logdir = str(tmp_path / "prof")
    with profiler.trace(logdir):
        with profiler.span("main.work"):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))
        t = threading.Thread(target=background, name="bg-trace")
        t.start()
        t.join()
    with open(os.path.join(logdir, "trace.json")) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"main.work", "bg.work"}
    assert spans["main.work"]["tid"] != spans["bg.work"]["tid"]
    rows = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert "bg-trace" in rows[spans["bg.work"]["tid"]]
    mm = next(e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm")
    work = spans["main.work"]
    assert work["ts"] - SLACK_NS / 1e3 <= mm["ts"] and mm["ts"] + mm["dur"] <= work["ts"] + work["dur"] + SLACK_NS / 1e3
    assert "programSpans" in doc


@pytest.mark.parametrize("layout", ["whole", "megatron"])
def test_each_dense_call_counts_its_form_only_while_profiled(layout):
    """A backbone forward counts every dense layer once, by the form it took:
    the whole layers and the column-parallel ones finish in the product's
    epilogue; a row-parallel one (here without a model group) adds its bias
    after the sum. With no profiler active nothing is counted."""
    m = _cfg().model
    backbone = GPT2Backbone(m).eval()
    if layout == "megatron":
        for block in backbone.h:
            block.attn.c_attn.parallel = block.mlp.c_fc.parallel = "column"
            block.attn.c_proj.parallel = block.mlp.c_proj.parallel = "row"
    x = torch.randn(3, 2, m.d_llm)
    with torch.no_grad():
        with profile(activities=CPU):
            backbone(x)
        want = ({"llm.dense.epilogue": 4 * m.llm_layers} if layout == "whole" else
                {"llm.dense.epilogue": 2 * m.llm_layers, "llm.dense.row_parallel": 2 * m.llm_layers})
        assert profiler.recorded()["counts"] == want
        backbone(x)
    assert profiler.recorded()["counts"] == want


def test_many_threads_lose_no_span_and_no_count():
    """More recording threads than cores, switching often: every span and
    every count arrives."""
    workers, each = 4 * (os.cpu_count() or 1) + 2, 200
    switch = sys.getswitchinterval()

    def work():
        for _ in range(each):
            with profiler.span("stress"):
                profiler.count("stress.count")

    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=CPU):
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    rec = profiler.recorded()
    assert rec["stats"]["stress"]["count"] == workers * each
    assert rec["counts"] == {"stress.count": workers * each}
    assert len({s["id"] for s in rec["spans"]}) == workers * each
