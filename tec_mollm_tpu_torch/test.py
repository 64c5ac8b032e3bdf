"""Evaluation CLI of the PyTorch port: ``python -m tec_mollm_tpu_torch.test``.

The JAX package's ``test.py`` flags, on one GPU: a checkpoint against the
Historical-Average baseline on a processed split, with split or adaptive
conformal calibration of a quantile head and an optional autoregressive
rollout::

    python -m tec_mollm_tpu_torch.test --data-dir data/processed --checkpoint latest
    python -m tec_mollm_tpu_torch.test --checkpoint checkpoints/run/best_params.pt --conformal fit
    python -m tec_mollm_tpu_torch.test --cpu --data-dir proc --workdir W --rollout-steps 24

``--checkpoint`` is ``latest`` (the newest ``<workdir>/checkpoints/<run>/
best_params.pt``), the port's ``best_params.pt`` or a reference ``.pth``. The
config is --config, else the config.json beside the checkpoint, else the flag
defaults. It runs on the GPU and raises without one; ``--cpu`` asks for the
CPU. ``--baseline sarima`` adds the batched SARIMA row (``models/sarima.py``):
fitted once on the train split's TEC with season ``--sarima-season``, its
recursions the kernels of ``ops/sarima.py`` on the card.
"""

from __future__ import annotations

import argparse


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate TEC-MoLLM vs HA baseline (PyTorch port, one GPU)")
    p.add_argument("--data-dir", default="data/processed")
    p.add_argument("--workdir", default=".")
    p.add_argument("--checkpoint", default="latest",
                   help="'latest', a best_params.pt file or a reference .pth")
    p.add_argument("--run-name", default=None,
                   help="restrict 'latest' resolution to one run (a workdir of several configs otherwise "
                        "evaluates whichever run saved last)")
    p.add_argument("--output-dir", default="results")
    p.add_argument("--batch-size", type=int, default=None,
                   help="eval batch (default: the config's eval_batch_size)")
    p.add_argument("--L-in", type=int, default=48)
    p.add_argument("--L-out", type=int, default=12)
    p.add_argument("--d-emb", type=int, default=16)
    p.add_argument("--llm-layers", type=int, default=3)
    p.add_argument("--config", default=None,
                   help="preset name or config json (e.g. checkpoints/<run>/config.json); overrides the "
                        "individual model flags")
    p.add_argument("--baseline", action="append", default=[], choices=["sarima"],
                   help="additional baseline rows beyond the HA (sarima: the batched CSS SARIMA fit on "
                        "the train split)")
    p.add_argument("--sarima-season", type=int, default=12,
                   help="seasonal period s for --baseline sarima")
    p.add_argument("--split", default="test", choices=["train", "val", "test"],
                   help="which processed split to score; '--split val --tail-frac 0.3' is the shift-aware "
                        "model-selection probe")
    p.add_argument("--tail-frac", type=float, default=1.0,
                   help="score only the chronologically last fraction of the split's windows")
    p.add_argument("--conformal", default="auto", metavar="MODE",
                   help="split-conformal calibration of the quantile head's intervals: 'fit' = calibrate "
                        "per-(horizon, level) offsets on the VAL split and save conformal.npz next to the "
                        "checkpoint; 'auto' (default) = use conformal.npz if present; 'off' = raw intervals "
                        "only; or a path to an offsets file")
    p.add_argument("--conformal-mode", default="additive", choices=["additive", "scale", "adaptive"],
                   help="'additive' = per-(horizon, level) TECU offsets; 'scale' = offsets in units of the "
                        "model's own band width; 'adaptive' = rolling recalibration on the chronological "
                        "stream from residuals whose whole target range was observed")
    p.add_argument("--conformal-decay", type=float, default=0.99,
                   help="per-batch exponential decay of the adaptive mode's residual histogram")
    p.add_argument("--conformal-level-gain", type=float, default=0.05,
                   help="ACI coverage-error feedback gain of the adaptive mode; 0 = pure rolling recalibration")
    p.add_argument("--conformal-tail-frac", type=float, default=1.0,
                   help="with --conformal fit: calibrate on only the chronologically last fraction of val")
    p.add_argument("--rollout-steps", type=int, default=0,
                   help="also run an autoregressive rollout eval this many steps beyond L_out")
    p.add_argument("--rollout-windows", type=int, default=8)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)

    from tec_mollm_tpu_torch.config import Config, ModelConfig, TrainConfig
    from tec_mollm_tpu_torch.device import resolve_device
    from tec_mollm_tpu_torch.evaluation.harness import resolve_cli_config, run_evaluation, run_rollout_eval
    from tec_mollm_tpu_torch.utils.logging import setup_logging

    setup_logging()
    device = resolve_device("cpu" if args.cpu else None)  # no card and no --cpu: raises
    cfg, checkpoint = resolve_cli_config(
        args.config, args.checkpoint, args.workdir, args.run_name,
        fallback=Config(
            model=ModelConfig(d_emb=args.d_emb, llm_layers=args.llm_layers),
            train=TrainConfig(L_in=args.L_in, L_out=args.L_out),
        ),
    )
    cfg = cfg.resolved()
    out = run_evaluation(
        cfg,
        data_dir=args.data_dir,
        checkpoint=checkpoint,
        output_dir=args.output_dir,
        batch_size=args.batch_size if args.batch_size is not None else cfg.train.eval_batch_size,
        workdir=args.workdir,
        run_name=args.run_name,
        baselines=tuple(args.baseline),
        sarima_season=args.sarima_season,
        split=args.split,
        tail_frac=args.tail_frac,
        conformal=None if args.conformal == "off" else args.conformal,
        conformal_tail_frac=args.conformal_tail_frac,
        conformal_mode=args.conformal_mode,
        conformal_decay=args.conformal_decay,
        conformal_level_gain=args.conformal_level_gain,
        device=device,
    )
    if args.rollout_steps > 0:
        out["rollout"] = run_rollout_eval(
            cfg,
            data_dir=args.data_dir,
            checkpoint=checkpoint,
            rollout_steps=args.rollout_steps,
            num_windows=args.rollout_windows,
            output_dir=args.output_dir,
            workdir=args.workdir,
            run_name=args.run_name,
            device=device,
        )
    return out


if __name__ == "__main__":
    main()
