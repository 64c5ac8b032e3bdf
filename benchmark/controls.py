"""The readings the limits of ``correct`` are set from, other than the
program's own (those are the ``check`` lines of the benchmark's runs).

    python3 -m benchmark.controls --workload <cell> --seeds 11 12 13 [--out file]

For each seed it makes the cell's inputs and weights as a run does and reads,
at the cell's own size:

* the control: the reference with every product's operands in float8 e4m3
  (the precision below the configuration's bf16) put in the program's place,
  compared with the float32 reference by the cell's own numbers;
* for a training cell, the planted fault "half of the batch left out, the mean
  taken over the rest", in the reference put in the program's place. (The
  fault "a step that returns its state unchanged" reads 1 on ``change_gap`` by
  its definition and needs no run.)

The benchmark's own runs never run this. It prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from benchmark import harness
from benchmark import traffic as traffic_lib
from benchmark.drivers import common
from benchmark.drivers import forecast as forecast_driver
from benchmark.drivers import serve as serve_driver
from benchmark.drivers import train as train_driver
from benchmark.reference import model as ref


def train_readings(ctx) -> list[dict]:
    """The steps' rows are a permutation drawn from the seed and the dropout
    masks fresh draws (``ref.Drawn``), the same on both sides of a reading."""
    windows = int(ctx.traffic["train_windows"])
    data = traffic_lib.split(ctx.config, windows, ctx.seed, stream=0)
    t = ctx.config["train"]
    per_step = t["batch_size"] * t["accumulation_steps"]
    order = traffic_lib.rng(ctx.seed, 0x0DE5).permutation(windows)
    batches = [[order[k * per_step:(k + 1) * per_step]] for k in range(train_driver.CHECK_STEPS)]

    def drawn(step, rank):
        return ref.Drawn(torch.Generator(device=ctx.device).manual_seed(1000 * step + rank + ctx.seed % 2**31))

    want = train_driver.reference_steps(ctx, data, ref.Precision(), batches, drawn)
    out = []
    for kind, prec, half in (("control_fp8", ref.Precision(fp8=True), False), ("fault_half_batch", ref.Precision(), True)):
        got = train_driver.reference_steps(ctx, data, prec, batches, drawn, half_batch=half)
        out.append({"kind": kind, **{n: v for n, v, _ in train_driver.compare(got, want, {})}})
    return out


def forecast_readings(ctx) -> list[dict]:
    data = traffic_lib.split(ctx.config, int(ctx.traffic["test_windows"]), ctx.seed, stream=1)
    n = int(ctx.traffic["test_windows"])
    batch = int(ctx.traffic["batch_size"])
    batches = -(-n // batch)
    g = traffic_lib.rng(ctx.seed, 0xC4EC)
    sample = sorted(g.choice(batches, size=min(int(ctx.traffic["check_batches"]), batches), replace=False).tolist())
    starts = np.concatenate([np.arange(k * batch, min((k + 1) * batch, n)) for k in sample])
    every = np.arange(n)
    want = common.reference_forecasts(ctx, data, every, ref.Precision())
    got = common.reference_forecasts(ctx, data, every, ref.Precision(fp8=True))
    rmse = forecast_driver.rmse_gap(forecast_driver.rmse_tecu(ctx, data, got), forecast_driver.rmse_tecu(ctx, data, want))
    return [{"kind": "control_fp8", "forecast_err": common.relative_error(got[starts], want[starts]), "rmse_gap": rmse}]


def serve_readings(ctx, seconds: float) -> list[dict]:
    n = int(ctx.traffic["split_windows"])
    data = traffic_lib.split(ctx.config, n, ctx.seed, stream=2)
    schedule = traffic_lib.schedule(ctx.traffic, ctx.seed, seconds, n)
    keep = sorted(serve_driver.sample_requests(ctx, len(schedule)))
    starts = np.concatenate([np.asarray(schedule[i][1]) for i in keep])

    def tecu(p):
        return np.clip(p * traffic_lib.TARGET_SCALE + traffic_lib.TARGET_MEAN, serve_driver.TEC_MIN, serve_driver.TEC_MAX)

    want = tecu(common.reference_forecasts(ctx, data, starts, ref.Precision()))
    got = tecu(common.reference_forecasts(ctx, data, starts, ref.Precision(fp8=True)))
    return [{"kind": "control_fp8", "forecast_err": common.relative_error(got, want)}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0, help="the window a serve cell's sample is drawn from")
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default=None)
    args = p.parse_args(argv)
    overrides = json.load(open(args.override)) if args.override else {}
    cell, config, traffic = harness.load(args.workload, overrides)
    device = torch.device(args.device)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = harness.Ctx(args.workload, cell, config, traffic, seed, device, tmp)
            kind = traffic["driver"]
            if kind == "train":
                rows = train_readings(ctx)
            elif kind == "forecast":
                rows = forecast_readings(ctx)
            else:
                rows = serve_readings(ctx, args.seconds)
        for row in rows:
            print(json.dumps({"cell": args.workload, "seed": seed, **row}), flush=True)
        common.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
