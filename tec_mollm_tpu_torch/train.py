"""Training CLI of the PyTorch port: ``python -m tec_mollm_tpu_torch.train``.

The JAX package's ``train.py`` flags and config overrides, on one GPU or,
with ``--multihost`` under ``torchrun``, one process a GPU:

    python -m tec_mollm_tpu_torch.train --data-dir data/processed --epochs 50
    python -m tec_mollm_tpu_torch.train --config run_config.json --resume
    python -m tec_mollm_tpu_torch.train --cpu --config tiny.json --data-dir proc --epochs 2
    torchrun --nproc_per_node 8 -m tec_mollm_tpu_torch.train --multihost --data-dir data/processed
    torchrun --nproc_per_node 8 -m tec_mollm_tpu_torch.train --multihost --model-parallel 2 --data-dir data/processed

It runs on the GPU and raises without one; ``--cpu`` asks for the CPU. The
data directory holds ``{train,val}_set.npz``, ``graph.npz`` (with or without
stencil arrays) and ``target_scaler.npz``, as the preprocess CLI writes them.
Checkpoints go to ``<workdir>/checkpoints/<run_name>/``, with the run's
``config.json`` written beside them before training (not on ``--resume``,
until the restore has succeeded); ``best_params.pt`` there is what
``python -m tec_mollm_tpu_torch.serve --checkpoint`` serves.

``--device-data`` keeps the splits' raw series (``{split}_raw.npz``) on the
card and gathers each microbatch's windows there (``data/device_data.py``).

``--multihost`` joins the process group that ``torchrun`` describes in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL with rank r on card ``LOCAL_RANK``, or gloo with
``--cpu``. ``--model-parallel N`` lays the world out as JAX's (data, model)
mesh: N consecutive ranks form a model group that splits the GPT-2 backbone
and the head Megatron-style (``parallel/tensor_parallel.py``), and
``world / N`` data-parallel replicas train over the data groups. One process
is one card, so without ``--multihost`` a value above 1 raises JAX's
divisibility message. The effective batch is ``batch_size *
accumulation_steps * world / model_parallel``; rank 0 writes
``config.json``, the checkpoints (whole tensors) and the history, and the
other ranks log warnings only.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import os

logger = logging.getLogger(__name__)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train TEC-MoLLM (PyTorch port: one GPU, or one process a GPU)")
    p.add_argument("--data-dir", default="data/processed")
    p.add_argument("--workdir", default=".")
    # None defaults: an unset flag keeps the config's value (the dataclass
    # default or the --config file's), a set flag wins
    p.add_argument("--L-in", type=int, default=None, help="default 48")
    p.add_argument("--L-out", type=int, default=None, help="default 12")
    p.add_argument("--train-stride", type=int, default=None, help="default 12")
    p.add_argument("--val-stride", type=int, default=None, help="validation window stride (default 1)")
    p.add_argument("--val-tail-frac", type=float, default=None,
                   help="select checkpoints on only the chronologically last fraction of "
                        "validation windows (default 1.0 = full period)")
    p.add_argument("--epochs", type=int, default=None, help="default 50")
    p.add_argument("--batch-size", type=int, default=None, help="microbatch (default 2)")
    p.add_argument("--accumulation-steps", type=int, default=None, help="default 6")
    p.add_argument("--lr", type=float, default=None, help="default 1e-4")
    p.add_argument("--weight-decay", type=float, default=None, help="default 1e-2")
    p.add_argument("--patience", type=int, default=None, help="default 20")
    p.add_argument("--min-delta", type=float, default=None, help="default 1e-4")
    p.add_argument("--seed", type=int, default=None, help="default 0")
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   help="mid-epoch resumable checkpoint every N macro steps (default 0 = epoch "
                        "boundaries only)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="EMA decay of the trainable params (e.g. 0.999); validation and the best "
                        "checkpoint use the EMA weights; 0 (default) disables")
    p.add_argument("--d-emb", type=int, default=None, help="default 16")
    p.add_argument("--llm-layers", type=int, default=None, help="default 3")
    p.add_argument("--revin", action="store_true",
                   help="per-window instance normalization of the TEC channel (recorded in config.json)")
    p.add_argument("--quantiles", type=float, nargs="+", default=None, metavar="Q",
                   help="probabilistic head with pinball loss, e.g. --quantiles 0.1 0.5 0.9 "
                        "(must include 0.5)")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="tensor-parallel degree (default 1): consecutive ranks of a --multihost world split the "
                        "GPT-2 backbone and head; the world must be a multiple of it")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute each GPT-2 block in the backward (torch.utils.checkpoint)")
    p.add_argument("--no-remat", action="store_true", help="force remat off (overrides --config)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident archive: keep the splits' raw series (*_raw.npz) on the card and "
                        "gather windows there; the host ships only window-start indices")
    p.add_argument("--multihost", action="store_true",
                   help="one process a card (data parallelism, and tensor parallelism with --model-parallel): "
                        "join the process group torchrun describes in RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR "
                        "and MASTER_PORT (NCCL; gloo with --cpu)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of one epoch (on a snapshot of the state) here")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--run-name", default=None)
    p.add_argument("--config", default=None,
                   help="preset name (default/scale_up/long_horizon/scaled_backbone/operational) or "
                        "config json path")
    p.add_argument("--gpt2-checkpoint", default=None,
                   help="torch GPT-2/peft state_dict (.pt/.bin) or HF dir to import")
    args = p.parse_args(argv)
    if args.remat and args.no_remat:
        p.error("--remat and --no-remat are mutually exclusive")
    return args


def build_config(args: argparse.Namespace):
    from tec_mollm_tpu_torch.config import Config, load_config

    train_over = {
        k: v
        for k, v in {
            "L_in": args.L_in,
            "L_out": args.L_out,
            "train_stride": args.train_stride,
            "val_stride": args.val_stride,
            "val_tail_frac": args.val_tail_frac,
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "accumulation_steps": args.accumulation_steps,
            "lr": args.lr,
            "weight_decay": args.weight_decay,
            "patience": args.patience,
            "min_delta": args.min_delta,
            "seed": args.seed,
            "checkpoint_every_steps": args.checkpoint_every_steps,
            "ema_decay": args.ema_decay,
            "model_parallel": args.model_parallel,
        }.items()
        if v is not None
    }
    if args.remat or args.no_remat:
        train_over["remat_llm"] = args.remat
    if args.no_bf16:
        train_over["bf16"] = False
    if args.device_data:
        train_over["device_data"] = True
    model_over = {
        k: v for k, v in {"d_emb": args.d_emb, "llm_layers": args.llm_layers}.items() if v is not None
    }
    if args.revin:
        model_over["revin"] = True
    if args.quantiles is not None:
        model_over["quantiles"] = tuple(args.quantiles)
    cfg = load_config(args.config) if args.config else Config()
    if train_over or model_over:
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, **model_over),
            train=dataclasses.replace(cfg.train, **train_over),
        )
    return cfg.resolved()


def build_trainer(args: argparse.Namespace, cfg):
    """The Trainer over the data directory's splits, graph and scaler, with
    the run's config written beside its checkpoints."""
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset
    from tec_mollm_tpu_torch.data.scaler import StandardScaler
    from tec_mollm_tpu_torch.device import resolve_device
    from tec_mollm_tpu_torch.graph.builder import GraphData
    from tec_mollm_tpu_torch import parallel
    from tec_mollm_tpu_torch.parallel import local_device, rank
    from tec_mollm_tpu_torch.training.trainer import Trainer

    if not parallel.is_initialized():
        try:  # one process is one card
            parallel.check_model_parallel(1, cfg.train.model_parallel)
        except ValueError as e:
            raise SystemExit(f"train: {e} (tensor parallelism takes --multihost, one process a card)") from None
    # no card and no --cpu: raises; under --multihost the rank's own device
    device = local_device() or resolve_device("cpu" if args.cpu else None)
    data_dir = args.data_dir
    t = cfg.train
    if t.device_data:
        def make_ds(mode, stride, tail_frac=1.0):
            return DeviceResidentDataset(data_dir, mode, t.L_in, t.L_out, stride=stride, tail_frac=tail_frac)
    else:
        def make_ds(mode, stride, tail_frac=1.0):
            return SlidingWindowDataset.from_dir(data_dir, mode, t.L_in, t.L_out, stride=stride, tail_frac=tail_frac)

    train_ds = make_ds("train", t.train_stride)
    val_ds = make_ds("val", t.val_stride, tail_frac=t.val_tail_frac)
    if len(val_ds) == 0:
        logger.warning("validation split empty; training without validation")
        val_ds = None
    graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
    tscaler_path = os.path.join(data_dir, "target_scaler.npz")
    target_scaler = StandardScaler.load(tscaler_path) if os.path.exists(tscaler_path) else None

    trainer = Trainer(
        cfg, train_ds, val_ds, graph, target_scaler,
        workdir=args.workdir, run_name=args.run_name, device=device,
    )
    logger.info(
        "device %s | world %d = data %d x model %d | effective batch %d | GAT route: %s",
        trainer.device, trainer.world, trainer.dp, trainer.mp, trainer.macro_batch, trainer.model.gat_route,
    )
    # written before training, by rank 0, so an interrupted run still leaves
    # the config that rebuilds its model; on --resume only after the restore
    # succeeded
    config_path = os.path.join(trainer.ckpt.dir, "config.json")
    if rank() == 0 and not (args.resume and os.path.exists(config_path)):
        with open(config_path, "w") as f:
            f.write(cfg.to_json())

    if args.gpt2_checkpoint:
        from tec_mollm_tpu_torch.models import TECMoLLM
        from tec_mollm_tpu_torch.models.hf_import import gpt2_state_dict, load_torch_checkpoint

        whole = trainer.model
        if trainer.mp > 1:  # the import reads the whole model's names and shapes
            whole = TECMoLLM(cfg.model, trainer.model.stencil_shifts, seed=None)
            whole.load_state_dict(trainer.full_state_dict())
        trainer.set_params(gpt2_state_dict(whole, load_torch_checkpoint(args.gpt2_checkpoint)))
        logger.info("imported GPT-2 weights from %s", args.gpt2_checkpoint)
    return trainer


def run(trainer, args: argparse.Namespace, cfg) -> list[dict]:
    """Profile one epoch if asked, then ``fit``; returns the history."""
    if args.profile_dir:
        from tec_mollm_tpu_torch.training.checkpoint import capture_state, load_state
        from tec_mollm_tpu_torch.utils.profiler import trace

        # the profiled epoch leaves no trace in training: it writes no
        # checkpoint and the state is restored from a copy afterwards, so the
        # run trains exactly --epochs epochs (and --resume finds its own state);
        # every rank trains it, rank 0 writes the trace
        snapshot = copy.deepcopy(capture_state(trainer.state))
        with trace(args.profile_dir if trainer.rank == 0 else None):
            trainer.epoch = 0
            trainer.train_epoch(checkpoints=False)
        load_state(trainer.state, snapshot)
        trainer.epoch = 0
        logger.info("profiler trace written to %s", args.profile_dir)

    history = trainer.fit(resume=args.resume)
    if args.resume and trainer.rank == 0:
        # the restore succeeded: the resumed flags are now the run's record
        with open(os.path.join(trainer.ckpt.dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    if history:
        logger.info("finished: epoch %d best_val %.6f", history[-1]["epoch"], trainer.best_val_loss)
    return history


def main(argv: list[str] | None = None) -> list[dict]:
    from tec_mollm_tpu_torch import parallel
    from tec_mollm_tpu_torch.utils.logging import setup_logging

    args = parse_args(argv)
    cfg = build_config(args)
    # a caller that made the group itself (another backend) keeps it
    owned = args.multihost and not parallel.is_initialized()
    if args.multihost:
        parallel.init_distributed(device="cpu" if args.cpu else None, model_parallel=cfg.train.model_parallel)
    try:
        setup_logging(process_index=parallel.rank())
        return run(build_trainer(args, cfg), args, cfg)
    finally:
        if owned:
            parallel.destroy()


if __name__ == "__main__":
    main()
