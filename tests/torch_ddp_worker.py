"""One rank of the port's data- and tensor-parallel tests
(tests/test_torch_ddp.py, tests/test_torch_ddp_jax.py, tests/test_torch_tp.py
and tests/test_torch_tp_jax.py), on the CPU over gloo.

    python tests/torch_ddp_worker.py JOB.json RANK WORLD

joins the process group (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as
torchrun would set them), runs the job and writes ``<out>/rank<RANK>.json``
(and ``.npz`` for arrays). Every group meets at a file store of its own,
``<out>/rendezvous/<job or stage name>``, made when the group starts: no
group uses a port picked before it starts, which another process could have
taken in between. The CLIs the jobs call (``train``, ``bench``) find the
group already made and use it.
It imports torch and the port only: nothing of JAX. Jobs (``JOB.json``):

* ``fit``: the ``Trainer`` on a processed dir (``resume``, ``epochs``), then,
  with ``eval``, ``run_evaluation``, ``get_model_predictions`` (val),
  ``run_prediction`` and adaptive conformal (test) on the best checkpoint.
  ``stop_rank`` / ``stop_epoch``: that rank alone sends itself SIGTERM once
  its trainer reaches that epoch. ``epoch_only``: one ``train_epoch`` (its
  periodic checkpoints, no validation) in place of ``fit``.
  ``model_parallel``: the group's and the config's tensor-parallel degree;
  ``record_params``: also write the model's whole tensors after the fit
  (``param:<name>`` arrays) and each rank's ``c_attn`` shape.
  ``eval_batch``: also ``run_evaluation`` on the best checkpoint at that
  batch size, with the harness's log lines about the batch size.
* ``cli``: ``python -m tec_mollm_tpu_torch.train --multihost`` with ``argv``.
* ``stages``: several of the above in one spawn, each in a process group of
  its own (``world``, ``model_parallel``; the ranks past a stage's world sit
  it out), plus ``grad`` (two train steps of a fresh ``Trainer``: the
  second's loss, clip norm and whole clipped gradients) and ``bench``
  (``python -m tec_mollm_tpu_torch.bench`` with ``argv``, its printed line).
  A stage's records go under its ``name``.

Every job records the files the rank opened for writing, or renamed into
place, under its workdir (an audit hook), so a test can hold the writes to
rank 0.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _watch_writes(root: str) -> list[str]:
    """Paths under ``root`` this process opens to write or renames into place."""
    root = os.path.realpath(root)
    seen: list[str] = []

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], str):
            mode = args[1] if len(args) > 1 and isinstance(args[1], str) else ""
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            writes = any(c in mode for c in "wax+") or (flags & (os.O_WRONLY | os.O_RDWR))
            paths = [args[0]] if writes else []
        elif event == "os.rename":
            paths = [a for a in args[:2] if isinstance(a, str)]
        else:
            return
        for p in paths:
            if os.path.realpath(p).startswith(root + os.sep):
                seen.append(os.path.relpath(os.path.realpath(p), root))

    sys.addaudithook(hook)
    return seen


def _fit(job: dict, rank: int, out: dict, arrays: dict) -> None:
    import dataclasses
    import signal
    import threading
    import time

    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler
    from tec_mollm_tpu_torch.graph import GraphData
    from tec_mollm_tpu_torch.training.trainer import Trainer

    with open(job["config"]) as f:
        cfg = Config.from_json(f.read())
    if "epochs" in job:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=job["epochs"]))
    if "model_parallel" in job:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, model_parallel=job["model_parallel"]))
    data, t = job["data"], cfg.train
    train = SlidingWindowDataset.from_dir(data, "train", t.L_in, t.L_out, stride=t.train_stride)
    val = SlidingWindowDataset.from_dir(data, "val", t.L_in, t.L_out, stride=1)
    graph = GraphData.load(os.path.join(data, "graph.npz"))
    scaler = StandardScaler.load(os.path.join(data, "target_scaler.npz"))
    trainer = Trainer(cfg, train, val, graph, scaler, workdir=job["workdir"], run_name="run", device="cpu")
    if job.get("stop_rank") == rank:
        def signal_when_reached():
            while trainer.epoch < job["stop_epoch"]:
                time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=signal_when_reached, daemon=True).start()
    if job.get("epoch_only"):
        out["epoch"] = trainer.train_epoch()
        return
    out["history"] = trainer.fit(resume=job.get("resume", False))
    out["final_epoch"] = trainer.epoch
    out["best_val_loss"] = trainer.best_val_loss
    out["updates"] = trainer.state.step
    val_loss, metrics = trainer.validate()
    out["validate"] = {"val_loss": val_loss, **metrics}
    if job.get("record_params"):
        out["c_attn_shape"] = list(trainer.model.llm_backbone.model.h[0].attn.c_attn.weight.shape)
        for k, v in trainer.full_state_dict().items():
            arrays[f"param:{k}"] = v.numpy()
    if job.get("eval"):
        _evaluate(job, cfg, graph, scaler, out, arrays)
    if job.get("eval_batch"):
        _evaluate_at(job, cfg, out)


def _evaluate_at(job: dict, cfg, out: dict) -> None:
    """``run_evaluation`` of the best checkpoint at batch ``eval_batch``,
    and what the harness logged about the batch size."""
    import logging

    from tec_mollm_tpu_torch.evaluation.harness import run_evaluation

    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log, keep = logging.getLogger("tec_mollm_tpu_torch.evaluation.harness"), Keep()
    level = log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    workdir = job["workdir"]
    try:
        ev = run_evaluation(cfg, job["data"], os.path.join(workdir, "checkpoints", "run", "best_params.pt"),
                            output_dir=os.path.join(workdir, "results_b"), batch_size=job["eval_batch"],
                            workdir=workdir, device="cpu")
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
    out["eval_batch"] = {"results": ev["results"], "log": [s for s in lines if s.startswith("eval batch size")]}


def _evaluate(job: dict, cfg, graph, scaler, out: dict, arrays: dict) -> None:
    import dataclasses

    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.evaluation.conformal import evaluate_adaptive_conformal
    from tec_mollm_tpu_torch.evaluation.harness import (
        get_model_predictions,
        load_params_for_eval,
        run_evaluation,
        run_prediction,
    )
    from tec_mollm_tpu_torch.models import TECMoLLM

    data, workdir, t = job["data"], job["workdir"], cfg.train
    ckpt = os.path.join(workdir, "checkpoints", "run", "best_params.pt")
    results = os.path.join(workdir, "results")
    ev = run_evaluation(cfg, data, ckpt, output_dir=results, batch_size=4, workdir=workdir, device="cpu")
    out["eval"] = ev["results"]
    pred = run_prediction(cfg, data, ckpt, indices=[0, 3, 4], output_dir=results, workdir=workdir, device="cpu")
    arrays["pred_forecast"] = pred["forecast"]
    val = SlidingWindowDataset.from_dir(data, "val", t.L_in, t.L_out, stride=1)
    trues, preds = get_model_predictions(cfg, load_params_for_eval(cfg, ckpt), val, graph, batch_size=4, device="cpu")
    arrays["gmp_true"], arrays["gmp_pred"] = trues, preds
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantiles=(0.1, 0.5, 0.9))).resolved()
    test = SlidingWindowDataset.from_dir(data, "test", t.L_in, t.L_out, stride=1)
    aci = evaluate_adaptive_conformal(
        qcfg, TECMoLLM(qcfg.model, seed=1).state_dict(), test, graph, scaler, batch_size=4,
        min_residual_mass=100.0, device="cpu",
    )
    out["aci"] = {k: aci[k] for k in ("pinball_avg", "interval_coverage", "calibration_by_level")}
    out["aci"]["final_effective_levels"] = aci["adaptive"]["final_effective_levels"]
    out["aci"]["batches"] = aci["adaptive"]["batches"]


def _grad(job: dict, out: dict, arrays: dict) -> None:
    """Two train steps of a fresh Trainer on its first two macro batches (the
    first moves lora_B off its zero init, so the second gives lora_A a
    gradient): the second step's loss, global norm before the clip, and
    whole clipped gradients."""
    import dataclasses

    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler
    from tec_mollm_tpu_torch.graph import GraphData
    from tec_mollm_tpu_torch.parallel.tensor_parallel import gather_full_state_dict
    from tec_mollm_tpu_torch.training.trainer import Trainer

    with open(job["config"]) as f:
        cfg = Config.from_json(f.read())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, model_parallel=job["model_parallel"]))
    data, t = job["data"], cfg.train
    train = SlidingWindowDataset.from_dir(data, "train", t.L_in, t.L_out, stride=t.train_stride)
    graph = GraphData.load(os.path.join(data, "graph.npz"))
    scaler = StandardScaler.load(os.path.join(data, "target_scaler.npz"))
    trainer = Trainer(cfg, train, None, graph, scaler, workdir=job["workdir"], run_name="grad", device="cpu")
    trainer.train_loader.set_epoch(0)
    for batch in list(trainer.train_loader)[:2]:
        trainer.state, metrics = trainer._train_step(trainer.state, trainer._put(batch), trainer.graph)
    out["loss"], out["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    grads = {n: p.grad for n, p in trainer.state.trainable().items()}
    for k, v in gather_full_state_dict(grads, cfg.model, trainer.mp).items():
        arrays[f"grad:{k}"] = v.numpy()


def _bench(job: dict, out: dict) -> None:
    import contextlib
    import io

    from tec_mollm_tpu_torch import bench

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench.main(job["argv"])
    out["line"] = json.loads(text.getvalue()) if text.getvalue() else None


def _run(job: dict, rank: int, out: dict, arrays: dict) -> None:
    """One job or stage in the process group its caller made."""
    if job["kind"] == "grad":
        _grad(job, out, arrays)
    elif job["kind"] == "bench":
        _bench(job, out)
    elif job["kind"] == "cli":
        from tec_mollm_tpu_torch import train

        out["history"] = train.main(job["argv"] + ["--multihost", "--cpu"])
    else:
        _fit(job, rank, out, arrays)


def _in_group(job: dict, name: str, world: int, rank: int, out: dict, arrays: dict) -> None:
    """Make the group of ``world`` ranks at a new file store under the job's
    out dir, run ``job`` in it, and leave it."""
    from tec_mollm_tpu_torch import parallel

    store = os.path.join(job["out"], "rendezvous", name)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    os.environ["WORLD_SIZE"] = str(world)
    parallel.init_distributed(device="cpu", model_parallel=job.get("model_parallel", 1),
                              init_method=f"file://{store}")
    try:
        _run(job, rank, out, arrays)
    finally:
        parallel.destroy()


def _stages(job: dict, rank: int, out: dict, arrays: dict) -> None:
    for stage in job["stages"]:
        if rank >= stage["world"]:
            continue
        rec: dict = {}
        got: dict = {}
        _in_group({**stage, "out": job["out"]}, stage["name"], stage["world"], rank, rec, got)
        out[stage["name"]] = rec
        arrays.update({f"{stage['name']}/{k}": v for k, v in got.items()})


def main() -> None:
    job_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(job_path) as f:
        job = json.load(f)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    writes = _watch_writes(job["workdir"])
    out: dict = {"rank": rank, "world": world}
    arrays: dict = {}
    if job["kind"] == "stages":
        _stages(job, rank, out, arrays)
    else:
        _in_group(job, os.path.splitext(os.path.basename(job_path))[0], world, rank, out, arrays)
    out["writes"] = sorted(set(writes))
    os.makedirs(job["out"], exist_ok=True)
    if arrays:
        np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **arrays)
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=float)


if __name__ == "__main__":
    main()
