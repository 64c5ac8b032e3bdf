"""The test CLI's scoring loop: ``EvalExecutor.stream_metrics`` over the test
split, pass after pass.

Set-up builds the ``EvalExecutor`` on a seeded test split with the seeded
weights and runs one pass as the warm-up. The window runs whole passes until
``seconds`` have passed (``forecast_windows_per_s``: every window scored over
the window's whole time). A forward hook keeps the predictions of a sample of
batches of the window's first pass, drawn from the seed.

The check: the reference's float32 predictions of those batches, and its RMSE
by horizon over the whole split in TECU (with the program's guard: predictions
clipped to [0, 200] TECU after the inverse scaling), against the streamed RMSE
of the window's last pass.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import trace as trace_lib
from benchmark import traffic as traffic_lib
from benchmark.drivers import common
from benchmark.reference import model as ref

TEC_MIN, TEC_MAX = 0.0, 200.0


def setup(ctx):
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.scaler import StandardScaler
    from tec_mollm_tpu_torch.evaluation.harness import EvalExecutor

    if ctx.world > 1:
        raise ValueError("the forecast driver runs on one chip")
    cfg = common.program_config(ctx)
    windows = int(ctx.traffic["test_windows"])
    data = traffic_lib.split(ctx.config, windows, ctx.seed, stream=1)
    ds = SlidingWindowDataset(data, cfg.train.L_in, cfg.train.L_out, stride=1)
    scaler = StandardScaler(mean=np.array([traffic_lib.TARGET_MEAN]), scale=np.array([traffic_lib.TARGET_SCALE]))
    batch = int(ctx.traffic.get("batch_size") or cfg.train.eval_batch_size)
    ex = EvalExecutor(cfg, common.program_graph(ctx), common.seeded_weights(ctx), batch, ctx.device)
    common.free(ctx.device)
    batches = -(-len(ds) // batch)
    g = traffic_lib.rng(ctx.seed, 0xC4EC)
    sample = sorted(g.choice(batches, size=min(int(ctx.traffic["check_batches"]), batches), replace=False).tolist())
    s = {"ctx": ctx, "ex": ex, "ds": ds, "scaler": scaler, "data": data, "batch": batch, "sample": sample,
         "seen": 0, "keep": False, "kept": {}}

    def hook(module, args, output):
        if s["keep"] and s["seen"] in sample:
            s["kept"][s["seen"]] = output[..., 0].detach().float().clone()
        s["seen"] += 1

    s["hook"] = ex.model.register_forward_hook(hook)
    ex.stream_metrics(ds, scaler)  # the warm-up pass
    return s


def _pass(s) -> dict:
    s["seen"] = 0
    return s["ex"].stream_metrics(s["ds"], s["scaler"])


def window(s, seconds: float) -> dict:
    ctx = s["ctx"]
    trace_lib.sync(ctx.device)
    t0 = time.perf_counter()
    passes = 0
    while True:
        s["keep"] = passes == 0
        s["metrics"] = _pass(s)
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    s["keep"] = False
    elapsed = time.perf_counter() - t0
    done = passes * len(s["ds"])
    s["kept"] = {b: t.cpu().numpy() for b, t in s["kept"].items()}
    return {
        "metrics": {"forecast_windows_per_s": done / elapsed},
        "attempted": done,
        "failed": 0,
        "windows": done,
        "elapsed_s": elapsed,
        "notes": {"passes": passes, "windows_per_pass": len(s["ds"]), "batch": s["batch"]},
    }


def traced(s) -> dict:
    """One whole pass under the profiler, the spatial encoder inside a span."""
    span = trace_lib.Span(s["ex"].model.spatial_encoder, "spatial_encoder")
    t = trace_lib.Capture(s["ctx"].device)
    try:
        with t:
            _pass(s)
    finally:
        span.remove()
    summary = trace_lib.reduce(t)
    summary["windows"] = len(s["ds"])
    return {"trace": summary, "batch": s["batch"]}


def check(s) -> list[tuple[str, float, float]]:
    ctx = s["ctx"]
    s["hook"].remove()
    del s["ex"]
    common.free(ctx.device)
    got, starts = program_and_starts(s)
    preds = common.reference_forecasts(ctx, s["data"], np.arange(len(s["ds"])), ref.Precision())
    want = preds[starts]
    limits = ctx.limits
    return [
        ("forecast_err", common.relative_error(got, want), limits.get("forecast_err", 0.0)),
        ("rmse_gap", rmse_gap(s["metrics"]["rmse_by_horizon"], rmse_tecu(ctx, s["data"], preds)),
         limits.get("rmse_gap", 0.0)),
    ]


def program_and_starts(s) -> tuple[np.ndarray, np.ndarray]:
    """The kept predictions (W, L_out, N) of the valid rows, and their windows."""
    n, b = len(s["ds"]), s["batch"]
    got, starts = [], []
    for k in s["sample"]:
        rows = np.arange(k * b, min((k + 1) * b, n))
        got.append(s["kept"][k][: len(rows)])
        starts.append(rows)
    return np.concatenate(got).astype(np.float64), np.concatenate(starts)


def rmse_tecu(ctx, data: dict, preds: np.ndarray) -> np.ndarray:
    """The RMSE in TECU by horizon of scaled predictions (W, L_out, N) of the
    split's first W windows, with the program's guard: predictions clipped to
    [0, 200] TECU after the inverse scaling."""
    l_in = ctx.config["train"]["L_in"]
    truth = data["Y"][np.arange(len(preds)) + l_in - 1].transpose(0, 2, 1).astype(np.float64)
    scale, mean = traffic_lib.TARGET_SCALE, traffic_lib.TARGET_MEAN
    p = np.clip(preds * scale + mean, TEC_MIN, TEC_MAX)
    return np.sqrt(((p - (truth * scale + mean)) ** 2).mean(axis=(0, 2)))


def rmse_gap(got, want) -> float:
    """The widest relative gap of the streamed RMSE by horizon. The RMSE, not
    the MAE: zero-mean noise in the predictions moves the MAE only at second
    order against errors this large, the RMSE by its own square."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / want))


def close(s) -> None:
    s.pop("ex", None)
