"""TEC-MoLLM on the DeepSeek-V2-Lite backbone at its published widths, through
the port's entry points on one card (``benchmark/configs/dsv2_lite.json``).

    python3 scripts/dsv2_card_check.py [--out DIR]

1. A seeded synthetic processed directory on the 41 x 71 grid.
2. ``Trainer``: two macro steps of B 1 x 8 from the benchmark's seeded weights
   (``benchmark/drivers/forecast_moe.seeded_weights``), dropout off, each
   step's loss beside the plain reference's (``benchmark/reference/
   deepseek_v2.py``, float32, TF32 off) on the same rows and on the program's
   weights of that step.
3. The train CLI for one epoch on the configuration file, then the test CLI
   (``EvalExecutor``) and the serve CLI (``ForecastService``, 4 requests) on
   the run it wrote.

Writes ``DIR/dsv2_card_check.json`` (default ``results``) and prints it as
one JSON line last. Needs a CUDA device; ``--device cpu --override tiny.json``
(``benchmark/tests/tiny.json``) rehearses it on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import forecast_moe  # noqa: E402
from benchmark.reference import deepseek_v2 as rd  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402

CELL = "dsv2_lite-forecast"
NO_DROPOUT = dict(gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0)
TARGET_MEAN, TARGET_SCALE = 25.0, 12.0


def write_processed(path: str, cfg, windows=(16, 2, 32)) -> None:
    from tec_mollm_tpu_torch.data import StandardScaler
    from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates

    os.makedirs(path, exist_ok=True)
    m = cfg.model
    for seed, (split, n) in enumerate(zip(("train", "val", "test"), windows)):
        np.savez(os.path.join(path, f"{split}_set.npz"),
                 **synthetic_processed_split(n, cfg.train.L_in, cfg.train.L_out, m.num_nodes, seed=seed))
    build_graph(*grid_coordinates(m.grid_h, m.grid_w)).save(os.path.join(path, "graph.npz"))
    StandardScaler(np.array([TARGET_MEAN]), np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))


def reference_loss(params: dict, batch: dict, config: dict, device) -> float:
    dims = rd.Dims.of(config)
    delta = config["train"]["huber_delta"]
    with torch.no_grad():
        x, tf, y = (torch.as_tensor(batch[k], device=device) for k in ("x", "time_features", "y"))
        pred = rd.forward(params, x.float(), tf.long(), ref.Graph(config, device), dims, ref.Precision())
        err = (pred - y.float().transpose(1, 2)[..., None]).abs()
        quad = err.clamp(max=delta)
        return float((0.5 * quad * quad + delta * (err - quad)).mean())


def trainer_steps(cfg, config: dict, proc: str, work: str, device) -> dict:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    from tec_mollm_tpu_torch.data import SlidingWindowDataset
    from tec_mollm_tpu_torch.graph import GraphData
    from tec_mollm_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = cfg.train
    ds = SlidingWindowDataset.from_dir(proc, "train", t.L_in, t.L_out, stride=1)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, None, GraphData.load(os.path.join(proc, "graph.npz")), None, workdir=work,
                      run_name="steps", device=device)
    cell, _, traffic = harness.load(CELL)
    weights = forecast_moe.seeded_weights(harness.Ctx(CELL, cell, config, traffic, 20261018, device, work))
    trainer.set_params(weights)
    built = time.perf_counter() - t0
    steps = []
    for k, batch in enumerate(trainer.train_loader.iter_from(0)):
        if k == 2:
            break
        params = dict(weights)
        params.update({n: p.detach().float() for n, p in trainer.state.trainable().items()})
        want = reference_loss(params, batch, config, device)
        sync()
        s0 = time.perf_counter()
        _, out = trainer._train_step(trainer.state, trainer._put(batch), trainer.graph)
        got = float(out["loss"].detach())
        sync()
        steps.append({"loss": got, "reference_loss": want, "gap": abs(got - want) / abs(want),
                      "grad_norm": float(out["grad_norm"]), "step_s": time.perf_counter() - s0})
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del trainer, weights
    return {"steps": steps, "build_s": built, "peak_bytes": peak}


def clis(config_path: str, proc: str, work: str, cpu: bool) -> dict:
    from tec_mollm_tpu_torch import serve as serve_cli
    from tec_mollm_tpu_torch import test as test_cli
    from tec_mollm_tpu_torch import train as train_cli

    out = {}
    flag = ["--cpu"] if cpu else []
    t0 = time.perf_counter()
    history = train_cli.main(flag + ["--config", config_path, "--data-dir", proc, "--workdir", work, "--run-name",
                                     "cli", "--epochs", "1"])
    out["train"] = {"s": time.perf_counter() - t0, "history": history}
    results = os.path.join(work, "results")
    t0 = time.perf_counter()
    test_cli.main(flag + ["--data-dir", proc, "--workdir", work, "--checkpoint", "latest", "--output-dir", results])
    with open(os.path.join(results, "evaluation_results.csv")) as f:
        out["test"] = {"s": time.perf_counter() - t0, "csv": f.read().splitlines()[:4]}
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(flag + ["--data-dir", proc, "--workdir", work, "--bench", "4"])
    out["serve"] = {"s": time.perf_counter() - t0, "bench": json.loads(buf.getvalue().strip().splitlines()[-1])}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 scripts/dsv2_card_check.py")
    p.add_argument("--out", default=os.path.join(ROOT, "results"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--override", default=None, help="a JSON file of sizes merged into the configuration")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tec_mollm_tpu_torch.config import Config

    device = torch.device(args.device)
    overrides = {}
    if args.override:
        with open(args.override) as f:
            overrides = json.load(f)
    _, config, _ = harness.load(CELL, overrides)
    config = harness.merge(config, {"model": NO_DROPOUT, "train": {"epochs": 1, "train_stride": 1}})
    cfg = Config.from_dict({k: config[k] for k in ("model", "train", "data")}).resolved()
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as work:
        proc = os.path.join(work, "proc")
        write_processed(proc, cfg)
        config_path = os.path.join(work, "dsv2_lite.json")
        with open(config_path, "w") as f:
            f.write(cfg.to_json())
        result["trainer"] = trainer_steps(cfg, config, proc, os.path.join(work, "steps"), device)
        result.update(clis(config_path, proc, os.path.join(work, "cli"), device.type == "cpu"))
    # the train cells' loss limit (benchmark/workloads/scale_up-train.json)
    result["ok"] = all(s["gap"] < 0.035 for s in result["trainer"]["steps"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dsv2_card_check.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps(result, default=str))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
