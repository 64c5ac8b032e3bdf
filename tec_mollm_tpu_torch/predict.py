"""Forecast CLI of the PyTorch port: ``python -m tec_mollm_tpu_torch.predict``.

The JAX package's ``predict.py`` flags, on one GPU: TECU forecasts (inverse
scaled, clipped to [0, 200]) of chosen windows of a processed split, written
to ``<output-dir>/forecast.npz``; a quantile head adds its bands, calibrated
by the ``conformal.npz`` beside the checkpoint when there is one::

    python -m tec_mollm_tpu_torch.predict --data-dir data/processed --checkpoint latest
    python -m tec_mollm_tpu_torch.predict --checkpoint ckpt/best_params.pt --indices 0 100 200 --split val

It runs on the GPU and raises without one; ``--cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TEC-MoLLM forecast from a checkpoint (PyTorch port, one GPU)")
    p.add_argument("--data-dir", default="data/processed")
    p.add_argument("--workdir", default=".")
    p.add_argument("--checkpoint", default="latest",
                   help="'latest', a best_params.pt file or a reference .pth")
    p.add_argument("--run-name", default=None, help="restrict 'latest' resolution to one run")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--indices", type=int, nargs="*", default=None,
                   help="window start indices (stride-1); default: most recent")
    p.add_argument("--output-dir", default="results")
    p.add_argument("--config", default=None,
                   help="preset name or config json (e.g. checkpoints/<run>/config.json)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from tec_mollm_tpu_torch.device import resolve_device
    from tec_mollm_tpu_torch.evaluation.harness import resolve_cli_config, run_prediction
    from tec_mollm_tpu_torch.utils.logging import setup_logging

    setup_logging()
    device = resolve_device("cpu" if args.cpu else None)  # no card and no --cpu: raises
    cfg, checkpoint = resolve_cli_config(args.config, args.checkpoint, args.workdir, args.run_name)
    return run_prediction(
        cfg.resolved(),
        data_dir=args.data_dir,
        checkpoint=checkpoint,
        split=args.split,
        indices=args.indices,
        output_dir=args.output_dir,
        workdir=args.workdir,
        run_name=args.run_name,
        device=device,
    )


if __name__ == "__main__":
    main()
