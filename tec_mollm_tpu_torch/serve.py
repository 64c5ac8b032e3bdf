"""Forecast server CLI of the PyTorch port.

    python -m tec_mollm_tpu_torch.serve --data-dir data/processed --checkpoint model.pt --port 8901
    curl -s localhost:8901/healthz
    curl -s -X POST localhost:8901/forecast -d '{"indices": [0, 1]}'

--checkpoint is a port state_dict saved with ``torch.save(model.state_dict())``
(``models/convert.py`` turns a JAX parameter tree into one). The config is
--config (a preset name or a config.json), else the config.json beside the
checkpoint, else the flagship default. --bench N skips HTTP and prints latency
statistics of N warm forecast calls as one JSON line. Runs on the GPU; --cpu
asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np


def _resolve_config(config: str | None, checkpoint: str):
    from tec_mollm_tpu_torch.config import Config, load_config

    if config:
        return load_config(config)
    beside = os.path.join(os.path.dirname(os.path.abspath(checkpoint)), "config.json")
    if os.path.exists(beside):
        with open(beside) as f:
            return Config.from_json(f.read())
    logging.getLogger(__name__).warning("no config.json beside %s: using the flagship config", checkpoint)
    return Config()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="TEC-MoLLM forecast server (PyTorch port)")
    p.add_argument("--data-dir", default="data/processed")
    p.add_argument("--checkpoint", required=True, help="port state_dict (.pt)")
    p.add_argument("--config", default=None)
    p.add_argument("--splits", nargs="*", default=["test"])
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="coalesce concurrent requests for up to this long (0 disables)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--bench", type=int, default=0, metavar="N",
                   help="run N warm forecast calls and print latency stats instead of serving HTTP")
    p.add_argument("--bench-threads", type=int, default=1)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = p.parse_args(argv)
    if not args.splits:
        p.error("--splits needs at least one split name")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from tec_mollm_tpu_torch.serving import ForecastService, serve

    # a serial bench with the batching window on would add the window to every request
    window_ms = 0.0 if (args.bench and args.bench_threads == 1) else args.batch_window_ms
    service = ForecastService(
        _resolve_config(args.config, args.checkpoint), args.data_dir, checkpoint=args.checkpoint,
        max_batch=args.max_batch, splits=tuple(args.splits), batch_window_ms=window_ms,
        device="cpu" if args.cpu else None,
    )
    if not args.bench:
        serve(service, args.host, args.port)
        return
    ds_len = service.health()["splits"][args.splits[0]]
    rng = np.random.default_rng(0)
    idxs = [rng.integers(0, ds_len, size=1).tolist() for _ in range(args.bench)]
    t0 = time.perf_counter()
    if args.bench_threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.bench_threads) as pool:
            list(pool.map(lambda i: service.forecast(i, args.splits[0]), idxs))
    else:
        for idx in idxs:
            service.forecast(idx, args.splits[0])
    wall = time.perf_counter() - t0
    service.close()
    print(json.dumps({
        **service.stats(), "device": str(service.device), "threads": args.bench_threads,
        "batch_window_ms": window_ms, "requests_per_sec": round(args.bench / wall, 2),
    }))


if __name__ == "__main__":
    main()
