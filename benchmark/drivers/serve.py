"""The serve CLI's path: ``ForecastService`` behind the stdlib HTTP server,
``POST /forecast``, under an open loop of requests from another process.

Set-up writes the seeded test split, graph and target scaler as a processed
directory, builds the service on the seeded weights (``state_dict=``) with the
traffic's ``max_batch`` and ``batch_window_ms``, starts the HTTP server on a
free localhost port and the client (``benchmark.loadgen``), and warms the path
with a short run of the same mix. The window sends the seed's schedule at the
traffic's rate (``traffic.schedule``) and waits for every answer:
``serve_windows_per_s`` is the windows answered well over the time from the
window's start to the last answer; the 95th percentile of latency over every
request due in the window, from its due time to its answer, a failed or
unanswered one counting as never answered, is the per-layer ``serve.p95_ms``
(its spread between runs is too wide to bound).

The check: a sample of the answered requests, drawn from the seed, against the
reference's float32 forecasts of the same windows, inverse-scaled and clipped
to [0, 200] TECU as the service does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np

from benchmark import trace as trace_lib
from benchmark import traffic as traffic_lib
from benchmark import graphfile
from benchmark.drivers import common
from benchmark.reference import model as ref

TEC_MIN, TEC_MAX = 0.0, 200.0
WARM_S = 3.0
TRACE_S = 5.0
WAIT_S = 60.0
NEVER_MS = 1e9


def write_processed(path: str, ctx, data: dict) -> None:
    np.savez(os.path.join(path, "test_set.npz"), **data)
    graphfile.write(os.path.join(path, "graph.npz"), ctx.config)
    np.savez(os.path.join(path, "target_scaler.npz"), mean=np.array([traffic_lib.TARGET_MEAN]),
             scale=np.array([traffic_lib.TARGET_SCALE]))


class Client:
    """The load generator's process and its line protocol."""

    def __init__(self, port: int):
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.proc = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen", "--port", str(port)], cwd=root,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if json.loads(self.proc.stdout.readline()).get("ready") is not True:
            raise RuntimeError("the load generator did not start")

    def run(self, schedule, keep, out: str, wait_s: float) -> tuple[dict, dict]:
        job = {"schedule": schedule, "keep": sorted(keep), "out": out, "wait_s": wait_s}
        self.proc.stdin.write(json.dumps(job) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator exited ({self.proc.poll()})")
        with np.load(out) as z:
            arrays = {k: z[k] for k in z.files}
        os.remove(out)
        return json.loads(line), arrays

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def setup(ctx):
    from tec_mollm_tpu_torch.serving.server import ForecastService, make_server

    if ctx.world > 1:
        raise ValueError("the serve driver runs on one chip")
    cfg = common.program_config(ctx)
    t = ctx.traffic
    n_windows = int(t["split_windows"])
    data = traffic_lib.split(ctx.config, n_windows, ctx.seed, stream=2)
    data_dir = os.path.join(ctx.tmp, "processed")
    os.makedirs(data_dir)
    write_processed(data_dir, ctx, data)
    service = ForecastService(cfg, data_dir, state_dict=common.seeded_weights(ctx), max_batch=int(t["max_batch"]),
                              batch_window_ms=float(t["batch_window_ms"]), device=ctx.device)
    common.free(ctx.device)
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, name="bench-http", daemon=True)
    thread.start()
    s = {"ctx": ctx, "service": service, "httpd": httpd, "thread": thread, "data": data, "n": n_windows}
    try:
        s["client"] = Client(httpd.server_address[1])
        warm = traffic_lib.schedule(t, ctx.seed, WARM_S, n_windows, stream=1)
        _run(s, warm, set(), wait_s=WAIT_S)
    except BaseException:
        close(s)
        raise
    return s


def _run(s, schedule, keep, wait_s: float) -> tuple[dict, dict]:
    out = os.path.join(s["ctx"].tmp, "answers.npz")
    return s["client"].run(schedule, keep, out, wait_s)


def sample_requests(ctx, count: int) -> set[int]:
    g = traffic_lib.rng(ctx.seed, 0xC4EC)
    return set(g.choice(count, size=min(int(ctx.traffic["check_requests"]), count), replace=False).tolist())


def summarize(schedule, arrays: dict, seconds: float) -> dict:
    ok = (arrays["status"] == 200) & (arrays["answered"] > 0)
    latency_ms = np.where(ok, (arrays["done"] - arrays["due"]) * 1e3, NEVER_MS)
    windows = int(arrays["answered"][ok].sum())
    span_s = max(float(np.nanmax(arrays["done"])) if ok.any() else seconds, seconds * 1e-3)
    return {"p95_ms": float(np.percentile(latency_ms, 95)), "p50_ms": float(np.percentile(latency_ms, 50)),
            "windows_per_s": windows / span_s, "failed": int((~ok).sum()), "attempted": len(schedule),
            "windows": windows, "span_s": span_s}


def window(s, seconds: float) -> dict:
    ctx = s["ctx"]
    schedule = traffic_lib.schedule(ctx.traffic, ctx.seed, seconds, s["n"])
    keep = sample_requests(ctx, len(schedule))
    gen, arrays = _run(s, schedule, keep, WAIT_S)
    summ = summarize(schedule, arrays, seconds)
    s["schedule"], s["keep"] = schedule, keep
    s["answers"] = {i: arrays[f"forecast_{i}"] for i in keep if f"forecast_{i}" in arrays}
    s["stats"] = s["service"].stats()
    s["failed"] = summ["failed"]
    return {
        "metrics": {"serve_windows_per_s": summ["windows_per_s"]},
        "p95_ms": summ["p95_ms"],
        "attempted": summ["attempted"],
        "failed": summ["failed"],
        "windows": summ["windows"],
        "elapsed_s": summ["span_s"],
        "notes": {"p50_ms": summ["p50_ms"], "p95_ms": summ["p95_ms"], "rate_per_s": float(ctx.traffic["rate_per_s"]),
                  "loadgen_late_p99_ms": gen["late_p99_ms"], "loadgen_late_max_ms": gen["late_max_ms"],
                  "service": {k: s["stats"].get(k) for k in ("p50_ms", "p95_ms", "forward_p50_ms", "mean_batch_rows")}},
    }


def traced(s) -> dict:
    """``TRACE_S`` seconds of the same mix (another draw) under the profiler;
    the service's counters as the window left them."""
    ctx = s["ctx"]
    schedule = traffic_lib.schedule(ctx.traffic, ctx.seed, TRACE_S, s["n"], stream=2)
    t = trace_lib.Capture(ctx.device)
    with t:
        _run(s, schedule, set(), WAIT_S)
    return {"trace": trace_lib.reduce(t), "serve_stats": s["stats"]}


def check(s) -> list[tuple[str, float, float]]:
    ctx = s["ctx"]
    close(s)
    s.pop("service", None)
    common.free(ctx.device)
    limits = ctx.limits
    failed = ("unanswered", float(s["failed"]), 0.0)
    if not s["answers"]:
        return [failed, ("answers_compared_missing", 1.0, 0.0)]
    order = sorted(s["answers"])  # a sampled request that failed counts under unanswered
    got = np.concatenate([s["answers"][i] for i in order])                       # (W, L_out, N) TECU
    starts = np.concatenate([np.asarray(s["schedule"][i][1]) for i in order])
    want = common.reference_forecasts(ctx, s["data"], starts, ref.Precision())
    want = np.clip(want * traffic_lib.TARGET_SCALE + traffic_lib.TARGET_MEAN, TEC_MIN, TEC_MAX)
    return [failed, ("forecast_err", common.relative_error(got, want), limits.get("forecast_err", 0.0))]


def close(s) -> None:
    if "client" in s:
        s.pop("client").close()
    if "httpd" in s:
        httpd = s.pop("httpd")
        httpd.shutdown()
        httpd.server_close()
        s.pop("thread").join(timeout=30)
    if "service" in s:
        s["service"].close()
