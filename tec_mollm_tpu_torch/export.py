"""Export CLI of the PyTorch port: ``python -m tec_mollm_tpu_torch.export``.

The counterpart of the JAX package's ``scripts/export_model.py``: a trained
checkpoint becomes a self-contained ``torch.export`` artifact (``.pt2`` plus a
metadata ``.json``, ``serving/export.py``) that ``python -m
tec_mollm_tpu_torch.serve --artifact`` serves::

    python -m tec_mollm_tpu_torch.export --data-dir data/processed --checkpoint latest --out exports/model.pt2
    python -m tec_mollm_tpu_torch.export --checkpoint run/best_params.pt --batch-size 8 --fused
    python -m tec_mollm_tpu_torch.export --cpu --config tiny.json --data-dir proc --workdir W

The checkpoint and config resolve as in the test CLI (``latest``, a
``best_params.pt`` or a reference ``.pth``; --config, else the config.json
beside the checkpoint); graph.npz of --data-dir is baked into the artifact.
--platforms lists the devices it serves on ("cuda", "cpu"; "tpu" is the JAX
package's and is refused; default: the device of the export); the export
traces on the first, or on the CPU under --cpu. --fused exports the short-attention and
fused-MLP kernels (``fused_attn`` and ``use_fused_mlp``) beside the GAT. The
artifact's path is printed on the last line.
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export a checkpoint to a torch.export artifact (PyTorch port)")
    p.add_argument("--data-dir", default="data/processed", help="processed dir (graph.npz is baked into the artifact)")
    p.add_argument("--workdir", default=".")
    p.add_argument("--checkpoint", default="latest", help="'latest', a best_params.pt file or a reference .pth")
    p.add_argument("--run-name", default=None, help="restrict 'latest' resolution to one run")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="exports/model.pt2")
    p.add_argument("--batch-size", type=int, default=None, help="pin the batch dim (default: symbolic, any B)")
    p.add_argument("--platforms", nargs="+", default=None,
                   help="devices the artifact serves on, from cuda and cpu (default: the device of the export)")
    p.add_argument("--fused", action="store_true",
                   help="export the short-attention and fused-MLP kernels too (fused_attn, use_fused_mlp)")
    p.add_argument("--cpu", action="store_true", help="run the export itself on the CPU")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> str:
    from tec_mollm_tpu_torch.evaluation.harness import load_params_for_eval, resolve_cli_config, warn_on_config_mismatch
    from tec_mollm_tpu_torch.graph.builder import GraphData
    from tec_mollm_tpu_torch.serving.export import artifact_meta, export_forecaster, save_exported
    from tec_mollm_tpu_torch.utils.logging import setup_logging

    args = parse_args(argv)
    setup_logging()
    # the export traces on the first platform: the CPU under --cpu
    platforms = args.platforms or ["cpu" if args.cpu else "cuda"]
    if args.cpu:
        if "cpu" not in platforms:
            raise SystemExit(f"export: --cpu traces on the CPU, which --platforms {platforms} leaves out")
        platforms = ["cpu"] + [p for p in platforms if p != "cpu"]
    cfg, checkpoint = resolve_cli_config(args.config, args.checkpoint, args.workdir, args.run_name)
    cfg = cfg.resolved()
    graph = GraphData.load(os.path.join(args.data_dir, "graph.npz"))
    logger.info("checkpoint: %s", checkpoint)
    warn_on_config_mismatch(cfg, checkpoint)
    state_dict = load_params_for_eval(cfg, checkpoint)
    ep = export_forecaster(
        cfg, state_dict, graph, batch_size=args.batch_size, platforms=platforms,
        fused_attn=args.fused, use_fused_mlp=args.fused,
    )
    save_exported(ep, args.out, meta=artifact_meta(cfg, graph, checkpoint, platforms, args.batch_size))
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
