"""Forecast server CLI of the PyTorch port: ``python -m tec_mollm_tpu_torch.serve``.

    python -m tec_mollm_tpu_torch.serve --data-dir data/processed --checkpoint latest --port 8901
    curl -s localhost:8901/healthz
    curl -s -X POST localhost:8901/forecast -d '{"indices": [0, 1]}'

The JAX package's ``serve.py`` flags. --checkpoint is ``latest`` (the newest
``<workdir>/checkpoints/<run>/best_params.pt``, within --run-name when given),
a ``best_params.pt`` or a reference ``.pth``; the config is --config, else the
config.json beside the resolved checkpoint, else the flagship default
(``evaluation/harness.resolve_cli_config``). A quantile model serves its bands
calibrated by the ``conformal.npz`` beside the checkpoint (or the artifact).
--artifact serves an exported program (``python -m tec_mollm_tpu_torch.export``)
instead of restoring the checkpoint; --config/--checkpoint still resolve the
window config, which is cross-checked against the artifact's metadata json.
--bench N skips HTTP and prints latency statistics of N warm forecast calls as
one JSON line. Runs on the GPU; --cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="TEC-MoLLM forecast server (PyTorch port)")
    p.add_argument("--data-dir", default="data/processed")
    p.add_argument("--workdir", default=".")
    p.add_argument("--checkpoint", default="latest",
                   help="'latest', a best_params.pt file or a reference .pth")
    p.add_argument("--run-name", default=None, help="restrict 'latest' resolution to one run")
    p.add_argument("--config", default=None)
    p.add_argument("--splits", nargs="*", default=["test"])
    p.add_argument("--artifact", default=None,
                   help="serve from an exported artifact (python -m tec_mollm_tpu_torch.export) instead of "
                        "restoring the checkpoint; --config/--checkpoint still resolve the window config, "
                        "cross-checked against the artifact's metadata json")
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

    from tec_mollm_tpu_torch.device import resolve_device
    from tec_mollm_tpu_torch.evaluation.harness import resolve_cli_config
    from tec_mollm_tpu_torch.serving import ForecastService, serve

    device = resolve_device("cpu" if args.cpu else None)  # no card and no --cpu: raises
    cfg, checkpoint = resolve_cli_config(args.config, args.checkpoint, args.workdir, args.run_name)
    # a serial bench with the batching window on would add the window to every request
    window_ms = 0.0 if (args.bench and args.bench_threads == 1) else args.batch_window_ms
    service = ForecastService(
        cfg, args.data_dir, checkpoint=None if args.artifact else checkpoint, workdir=args.workdir,
        run_name=args.run_name, max_batch=args.max_batch, splits=tuple(args.splits), batch_window_ms=window_ms,
        device=device, artifact=args.artifact,
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
