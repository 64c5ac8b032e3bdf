"""The serve cell's mix at rising rates, on one set-up: where the knee lies.

    python3 -m benchmark.sweep --workload flagship-serve --seed 5 --seconds 20 --rates 4 6 8 10 12 14

For each rate it runs the cell's window at that rate and prints one JSON line:
p50 and p95 from the due time, windows answered per second, the load
generator's lateness, and the backlog's growth: the least-squares slope of
latency against due time (ms of added latency a second). The knee is the highest rate
whose backlog does not grow; the cell's rate is about 4/5 of it, written into
its traffic file.
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
from benchmark.drivers import serve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    p.add_argument("--workload", default="flagship-serve")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default=None)
    args = p.parse_args(argv)
    overrides = json.load(open(args.override)) if args.override else {}
    cell, config, traffic = harness.load(args.workload, overrides)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Ctx(args.workload, cell, config, traffic, args.seed, device, tmp)
        s = serve.setup(ctx)
        try:
            for k, rate in enumerate(args.rates):
                ctx.traffic = dict(traffic, rate_per_s=rate)
                schedule = traffic_lib.schedule(ctx.traffic, args.seed, args.seconds, s["n"], stream=10 + k)
                gen, arrays = serve._run(s, schedule, set(), serve.WAIT_S)
                summ = serve.summarize(schedule, arrays, args.seconds)
                lat = (arrays["done"] - arrays["due"]) * 1e3
                ok = np.isfinite(lat)
                growth = np.polyfit(arrays["due"][ok], lat[ok], 1)[0] if ok.sum() > 2 else float("nan")
                print(json.dumps({"rate_per_s": rate, "requests": summ["attempted"], "failed": summ["failed"],
                                  "p50_ms": summ["p50_ms"], "p95_ms": summ["p95_ms"],
                                  "windows_per_s": summ["windows_per_s"], "backlog_ms_per_s": float(growth),
                                  "late_p99_ms": gen["late_p99_ms"], "stats": s["service"].stats()}), flush=True)
        finally:
            serve.close(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
